"""Lambertian BSDF with a constant reflectance (counterpart of
``psdr_jit_tpu/bsdf/diffuse.py``, reference src/bsdf/diffuse.cpp; textured
reflectance is not ported).

The JAX package's ``eval``, ``sample`` and ``pdf`` methods are the
per-lane functions :func:`diffuse_eval`, :func:`diffuse_sample` and
:func:`diffuse_pdf`, which take the reflectance and the two-sided flag as
tensors, so the scene's dispatch (``bsdf/bsdf.py``) evaluates every lane
with its own material's values in one pass."""

from __future__ import annotations

import torch

from ..core import warp
from ..core.records import BSDFSample
from ..core.types import INV_PI
from .bsdf import BSDF


def _orient(wi_z, wo_z, two_side):
    """Two-sided materials flip both directions into the upper hemisphere
    of ``wi`` (diffuse.cpp:28-31): ``wo.z = mulsign(wo.z, wi.z)`` with
    sign(0) = +1, ``wi.z = |wi.z|``."""
    wo_z = torch.where(two_side & ~(wi_z >= 0.0), -wo_z, wo_z)
    wi_z = torch.where(two_side, torch.abs(wi_z), wi_z)
    return wi_z, wo_z


def diffuse_eval(reflectance, two_side, wi, wo, active):
    """f(wi, wo) cos(theta_o) for local directions (..., 3): ``(..., 3)``."""
    cos_i, cos_o = _orient(wi[..., 2], wo[..., 2], two_side)
    ok = active & (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(ok[..., None], reflectance * (INV_PI * cos_o)[..., None],
                       0.0)


def diffuse_sample(two_side, wi, rnd3, active) -> BSDFSample:
    """Cosine-weighted direction from ``rnd3[..., 1:3]``; detached."""
    cos_i = torch.where(two_side, torch.abs(wi[..., 2]), wi[..., 2])
    wo = warp.square_to_cosine_hemisphere(rnd3[..., 1:3])
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return BSDFSample(wo=wo, pdf=pdf, eta=torch.ones_like(pdf),
                      is_valid=active & (cos_i > 0.0))


def diffuse_pdf(two_side, wi, wo, active):
    """Solid-angle density cos(theta_o) / pi of ``wo``; detached."""
    cos_i, cos_o = _orient(wi[..., 2].detach(), wo[..., 2].detach(),
                           two_side)
    ok = active & (cos_i > 0.0) & (cos_o > 0.0)
    return torch.where(ok, INV_PI * cos_o, 0.0)


class DiffuseBSDF(BSDF):
    def __init__(self, reflectance=(0.5, 0.5, 0.5), twoSide: bool = False):
        self.reflectance = reflectance
        self.twoSide = bool(twoSide)

    @property
    def reflectance(self) -> torch.Tensor:
        """The constant RGB reflectance, ``(3,)`` float32. A tensor set
        here keeps its autograd graph, so a training step can set it."""
        return self._reflectance

    @reflectance.setter
    def reflectance(self, value):
        refl = torch.as_tensor(value, dtype=torch.float32).reshape(-1)
        if refl.numel() == 1:
            refl = refl.repeat(3)
        if refl.numel() != 3:
            raise NotImplementedError(
                "DiffuseBSDF takes a constant RGB reflectance; textured "
                "reflectance comes with the rest of the BSDF surface")
        self._reflectance = refl

    def __repr__(self) -> str:
        return f"DiffuseBSDF[reflectance={self.reflectance.tolist()}]"
