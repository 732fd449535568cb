"""Microfacet BRDF with per-vertex parameters, interpolated by barycentrics
at the hit (counterpart of ``psdr_jit_tpu/bsdf/microfacet_pv.py``,
reference src/bsdf/microfacet_pv.cpp).

The scene's material table concatenates the per-vertex tables of every
such BSDF into one ``(rows, 7)`` table (specular | diffuse | roughness)
with a first row a slot; :func:`interpolate` gathers a lane's three
vertex rows at that offset plus the hit face's mesh-local vertex ids with
``ops.gather.gather_rows``, whose backward is one sum into the table.
:func:`microfacet_pv_eval` is UE4's analytic GGX with Schlick's masking;
sampling and its density are the Microfacet BSDF's at the interpolated
roughness (``microfacet.microfacet_sample``, ``microfacet_pdf``)."""

from __future__ import annotations

import torch

from ..core.math import dot, normalize, safe_div
from ..core.types import INV_PI
from ..ops.gather import gather_rows
from .bsdf import BSDF
from .microfacet import _orient

PACKED = 7  # specular (3) | diffuse (3) | roughness (1)


def packed_table(bsdf):
    """``bsdf``'s per-vertex tables side by side: ``(V, 7)``."""
    return torch.cat([bsdf.specularReflectance, bsdf.diffuseReflectance,
                      bsdf.roughness.reshape(-1, 1)], -1)


def interpolate(table, rows, bc):
    """The barycentric blend at ``bc`` (..., 2) of the rows ``rows`` (...,
    3) of ``table`` (R, C): ``(..., C)`` (microfacet_pv.cpp:145-163)."""
    v = gather_rows(table, rows)
    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    return v0 + (v1 - v0) * bc[..., 0:1] + (v2 - v0) * bc[..., 1:2]


def microfacet_pv_eval(specular, diffuse, roughness, two_side, wi, wo,
                       active):
    """f(wi, wo) cos(theta_o) for local directions (..., 3): ``(..., 3)``;
    the interpolated ``specular``, ``diffuse`` (..., 3) and ``roughness``
    (...,) a lane (microfacet_pv.cpp:48-60)."""
    wi, wo = _orient(wi, wo, two_side)
    cos_nv, cos_nl = wi[..., 2], wo[..., 2]
    active = active & (cos_nv > 0.0) & (cos_nl > 0.0)
    h = normalize(wi + wo)
    cos_nh = h[..., 2]
    cos_vh = dot(h, wi)
    alpha = roughness * roughness
    k = (roughness + 1.0) * (roughness + 1.0) / 8.0
    tmp = safe_div(alpha, cos_nh * cos_nh * (alpha * alpha - 1.0) + 1.0)
    ggx = tmp * tmp * INV_PI
    coeff = cos_vh * (-5.55473 * cos_vh - 6.8316)
    fresnel = specular + (1.0 - specular) * torch.exp2(coeff)[..., None]
    smith_g = (safe_div(cos_nv, cos_nv * (1.0 - k) + k)
               * safe_div(cos_nl, cos_nl * (1.0 - k) + k))
    numerator = (ggx * smith_g)[..., None] * fresnel
    denominator = 4.0 * cos_nl * cos_nv
    spec = numerator / (denominator + 1e-6)[..., None]
    value = (diffuse * INV_PI + spec) * cos_nl[..., None]
    return torch.where(active[..., None], value, 0.0)


class MicrofacetBSDFPerVertex(BSDF):
    """``MicrofacetBSDFPerVertex(spec_refl, diff_refl, roughness,
    twoSide)``: ``(V, 3)`` specular and diffuse reflectances and ``(V,)``
    roughnesses, a row a vertex of the one mesh that uses it."""

    _tensor_fields = ("specularReflectance", "diffuseReflectance",
                      "roughness")

    def __init__(self, spec_refl, diff_refl, roughness,
                 twoSide: bool = False):
        self.specularReflectance = torch.as_tensor(spec_refl,
                                                   dtype=torch.float32)
        self.diffuseReflectance = torch.as_tensor(diff_refl,
                                                  dtype=torch.float32)
        self.roughness = torch.as_tensor(roughness,
                                         dtype=torch.float32).reshape(-1, 1)
        self.twoSide = bool(twoSide)

    def to_string(self) -> str:
        return f"MicrofacetBSDFPerVertex[{self.roughness.shape[0]}]"
