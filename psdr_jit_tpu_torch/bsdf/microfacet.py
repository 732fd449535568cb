"""Microfacet BRDF: a diffuse lobe plus a GGX specular lobe with the UE4
form of Schlick's Fresnel (counterpart of ``psdr_jit_tpu/bsdf/microfacet.py``,
reference src/bsdf/microfacet.cpp).

The parameters are bitmaps (``core/bitmap.py``), constant or textured,
evaluated at a hit's texture coordinates: the scene's material table
(``bsdf.material_table``) reads each lane's values, and
:func:`microfacet_eval`, :func:`microfacet_sample` and
:func:`microfacet_pdf` evaluate every lane with its own values, as
``bsdf/diffuse.py`` does."""

from __future__ import annotations

import torch

from ..core.bitmap import Bitmap
from ..core.math import dot, mulsign, normalize, safe_div
from ..core.records import BSDFSample
from ..core.types import INV_PI
from .bsdf import BSDF
from .ggx import GGXDistribution


def _orient(wi, wo, two_side):
    """Two-sided materials flip both directions into the upper hemisphere
    of ``wi``: ``wo.z = mulsign(wo.z, wi.z)``, ``wi.z = |wi.z|``."""
    wi_z, wo_z = wi[..., 2], wo[..., 2]
    wo_z = torch.where(two_side, mulsign(wo_z, wi_z), wo_z)
    wi_z = torch.where(two_side, torch.abs(wi_z), wi_z)
    return (torch.cat([wi[..., :2], wi_z[..., None]], -1),
            torch.cat([wo[..., :2], wo_z[..., None]], -1))


def microfacet_eval(specular, diffuse, roughness, two_side, wi, wo, active):
    """f(wi, wo) cos(theta_o) for local directions (..., 3): ``(..., 3)``;
    ``specular``, ``diffuse`` (..., 3) and ``roughness`` (...,) a lane."""
    wi, wo = _orient(wi, wo, two_side)
    cos_nv, cos_nl = wi[..., 2], wo[..., 2]
    active = active & (cos_nv > 0.0) & (cos_nl > 0.0)
    h = normalize(wi + wo)
    cos_vh = dot(h, wi)
    distr = GGXDistribution(roughness * roughness)
    # UE4's Schlick with a spherical-Gaussian power (microfacet.cpp:53-55)
    coeff = cos_vh * (-5.55473 * cos_vh - 6.8316)
    fresnel = specular + (1.0 - specular) * torch.exp2(coeff)[..., None]
    smith_g = distr.smith_g1(wi, h) * distr.smith_g1(wo, h)
    numerator = (distr.eval(h) * smith_g)[..., None] * fresnel
    denominator = 4.0 * cos_nl * cos_nv
    spec = numerator / (denominator + 1e-6)[..., None]
    value = (diffuse * INV_PI + spec) * cos_nl[..., None]
    return torch.where(active[..., None], value, 0.0)


def ggx_reflection_sample(alpha_u, alpha_v, two_side, wi, rnd3,
                          active) -> BSDFSample:
    """A visible normal of the GGX distribution ``(alpha_u, alpha_v)``
    from ``rnd3[..., :2]``, ``wi`` reflected about it; detached. The
    Microfacet BSDFs' and the rough conductor's sample."""
    wi = wi.detach()
    wi = torch.cat([wi[..., :2], torch.where(
        two_side, torch.abs(wi[..., 2]), wi[..., 2])[..., None]], -1)
    distr = GGXDistribution(alpha_u.detach(), alpha_v.detach())
    m, m_pdf = distr.sample(wi, rnd3)
    wo = 2.0 * dot(wi, m)[..., None] * m - wi
    pdf = safe_div(m_pdf, 4.0 * dot(wo, m))
    return BSDFSample(
        wo=wo.detach(), pdf=pdf.detach(), eta=torch.ones_like(pdf),
        is_valid=active & (wi[..., 2] > 0.0) & (pdf != 0.0)
        & (wo[..., 2] > 0.0))


def ggx_reflection_pdf(alpha_u, alpha_v, two_side, wi, wo, active):
    """Solid-angle density of ``wo`` under :func:`ggx_reflection_sample`;
    detached."""
    wi, wo = _orient(wi.detach(), wo.detach(), two_side)
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    m = normalize(wo + wi)
    ok = (active & (cos_i > 0.0) & (cos_o > 0.0) & (dot(wi, m) > 0.0)
          & (dot(wo, m) > 0.0))
    distr = GGXDistribution(alpha_u.detach(), alpha_v.detach())
    result = safe_div(distr.eval(m) * distr.smith_g1(wi, m), 4.0 * cos_i)
    return torch.where(ok, result, 0.0).detach()


def microfacet_sample(roughness, two_side, wi, rnd3, active) -> BSDFSample:
    """A visible-normal sample at alpha = ``roughness``^2 reflected about
    its normal, from ``rnd3[..., :2]``; detached."""
    alpha = roughness * roughness
    return ggx_reflection_sample(alpha, alpha, two_side, wi, rnd3, active)


def microfacet_pdf(roughness, two_side, wi, wo, active):
    """Solid-angle density of ``wo``; detached."""
    alpha = roughness * roughness
    return ggx_reflection_pdf(alpha, alpha, two_side, wi, wo, active)


def _bitmap(value, channels: int) -> Bitmap:
    if isinstance(value, Bitmap):
        return value
    arr = torch.as_tensor(value, dtype=torch.float32)
    if arr.dim() >= 3:
        return Bitmap.from_array(arr)
    return Bitmap.from_value(arr, channels)


class MicrofacetBSDF(BSDF):
    """``MicrofacetBSDF(specular, diffuse, roughness, twoSide)``: RGB
    specular and diffuse reflectances and a roughness (alpha = roughness^2),
    each a :class:`Bitmap` or a value."""

    _tensor_fields = ("specularReflectance", "diffuseReflectance",
                      "roughness")

    def __init__(self, specular=(0.04, 0.04, 0.04), diffuse=(0.5, 0.5, 0.5),
                 roughness=0.5, twoSide: bool = False):
        self.specularReflectance = _bitmap(specular, 3)
        self.diffuseReflectance = _bitmap(diffuse, 3)
        self.roughness = _bitmap(roughness, 1)
        self.twoSide = bool(twoSide)

    def to_string(self) -> str:
        return "MicrofacetBSDF[]"
