"""Rough conductor: an anisotropic GGX lobe with the Fresnel reflectance of
a complex index of refraction (counterpart of
``psdr_jit_tpu/bsdf/roughconductor.py``, reference
src/bsdf/roughconductor.cpp).

The five parameters are bitmaps, constant or textured, read lane by lane
by the scene's material table as ``bsdf/microfacet.py``'s are:
:func:`roughconductor_eval` takes each lane's values. Its sample and
density are ``microfacet.ggx_reflection_sample`` and
``ggx_reflection_pdf`` at the lanes' anisotropic alphas."""

from __future__ import annotations

import torch

from ..core.math import dot, fresnel_conductor, normalize, safe_div
from .bsdf import BSDF
from .ggx import GGXDistribution
from .microfacet import _bitmap, _orient


def roughconductor_eval(alpha_u, alpha_v, eta, k, specular, two_side, wi,
                        wo, active):
    """f(wi, wo) cos(theta_o) for local directions (..., 3): ``(..., 3)``;
    ``alpha_u``, ``alpha_v`` (...,), ``eta``, ``k`` and ``specular``
    (..., 3) a lane."""
    wi, wo = _orient(wi, wo, two_side)
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    active = active & (cos_i > 0.0) & (cos_o > 0.0)
    distr = GGXDistribution(alpha_u, alpha_v)
    h = normalize(wo + wi)
    d = distr.eval(h)
    active = active & (d != 0.0)
    result = safe_div(d * distr.G(wi, wo, h), 4.0 * cos_i)
    f = fresnel_conductor(eta, k, dot(wi, h))
    value = f * result[..., None] * specular
    return torch.where(active[..., None], value, 0.0)


class RoughConductorBSDF(BSDF):
    """``RoughConductorBSDF(alpha_u, alpha_v, eta, k, specular_reflectance,
    twoSide)``: GGX roughnesses along the shading frame's ``s`` and ``t``
    (``alpha_v`` defaults to ``alpha_u``), the RGB complex index of
    refraction ``eta + i k`` and a specular tint, each a :class:`Bitmap`
    or a value."""

    _tensor_fields = ("alpha_u", "alpha_v", "eta", "k",
                      "specular_reflectance")

    def __init__(self, alpha_u=0.1, alpha_v=None,
                 eta=(0.2004, 0.9228, 1.102), k=(3.913, 2.448, 2.1765),
                 specular_reflectance=(1.0, 1.0, 1.0),
                 twoSide: bool = False):
        self.alpha_u = _bitmap(alpha_u, 1)
        self.alpha_v = _bitmap(alpha_u if alpha_v is None else alpha_v, 1)
        self.eta = _bitmap(eta, 3)
        self.k = _bitmap(k, 3)
        self.specular_reflectance = _bitmap(specular_reflectance, 3)
        self.twoSide = bool(twoSide)

    def anisotropic(self) -> bool:
        return True

    def to_string(self) -> str:
        return "RoughConductorBSDF[]"
