"""Lambertian BSDF with a constant or textured reflectance (counterpart of
``psdr_jit_tpu/bsdf/diffuse.py``, reference src/bsdf/diffuse.cpp).

The JAX package's ``eval``, ``sample`` and ``pdf`` methods are the
per-lane functions :func:`diffuse_eval`, :func:`diffuse_sample` and
:func:`diffuse_pdf`, which take the reflectance and the two-sided flag as
tensors, so the scene's dispatch (``bsdf/bsdf.py``) evaluates every lane
with its own material's values, read at its hit's ``uv``, in one pass."""

from __future__ import annotations

import torch

from ..core import warp
from ..core.bitmap import Bitmap, Bitmap3f
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
    _tensor_fields = ("reflectance",)

    def __init__(self, reflectance=(0.5, 0.5, 0.5), twoSide: bool = False):
        self.reflectance = reflectance
        self.twoSide = bool(twoSide)

    @property
    def reflectance(self) -> Bitmap:
        """The RGB reflectance, a :class:`Bitmap`: 1x1 for a constant,
        (H, W, 3) for a texture. A training step sets its ``data`` (a
        tensor set there keeps its autograd graph)."""
        return self._reflectance

    @reflectance.setter
    def reflectance(self, value):
        """A :class:`Bitmap`, an RGB value or an (H, W, 3) array."""
        if isinstance(value, Bitmap):
            self._reflectance = value
        else:
            self._reflectance = Bitmap3f(value)

    def to_string(self) -> str:
        return f"DiffuseBSDF[reflectance={self.reflectance.resolution}]"
