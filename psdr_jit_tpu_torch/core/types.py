"""Render options, rays and constants (counterpart of
``psdr_jit_tpu/core/types.py``)."""

from __future__ import annotations

import dataclasses

import torch

# reference include/psdr/constants.h:12-32
EPSILON = 1e-5
RAY_EPSILON = 1e-3
SHADOW_EPSILON = 1e-3
EDGE_EPSILON = 1e-5

PI = 3.14159265358979323846
INV_PI = 1.0 / PI


@dataclasses.dataclass(init=False)
class RenderOption:
    """``RenderOption{width, height, spp, sppe, sppse, log_level}`` with the
    reference's positional constructors: ``RenderOption(w, h, s)`` sets
    spp = sppe = sppse = s; ``RenderOption(w, h, s1, s2)`` sets
    sppe = sppse = s2."""

    width: int = 128
    height: int = 128
    spp: int = 1
    sppe: int = 1
    sppse: int = 1
    log_level: int = 0

    def __init__(self, width=128, height=128, spp=1, sppe=None, sppse=None,
                 log_level=0):
        self.width = int(width)
        self.height = int(height)
        self.spp = int(spp)
        self.sppe = int(spp if sppe is None else sppe)
        self.sppse = int(self.sppe if sppse is None else sppse)
        self.log_level = int(log_level)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclasses.dataclass
class Ray:
    """A bundle of rays: ``o`` and ``d`` are ``(..., 3)`` float32 tensors."""

    o: torch.Tensor
    d: torch.Tensor


def coordinate_system(n):
    """Duff et al. orthonormal basis around unit normals ``n`` (..., 3)
    (reference core/frame.h:9-28). Returns ``(s, t)``."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([sign * nx * nx * a + 1.0, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


@dataclasses.dataclass
class Frame:
    """Shading frame: tangent ``s``, bitangent ``t``, normal ``n``."""

    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def from_normal(n) -> "Frame":
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v):
        from .math import dot

        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)],
                           dim=-1)


@dataclasses.dataclass
class Intersection:
    """Detached surface interaction record of the path formulation
    (reference core/intersection.h:7-60); fields the slice has no data for
    (uv texture coordinates, dp/du, dp/dv) are left out."""

    valid: torch.Tensor    # (...,) bool
    t: torch.Tensor        # (...,) distance
    p: torch.Tensor        # (..., 3) hit position
    n: torch.Tensor        # (..., 3) face normal
    sh_frame: Frame        # shading frame
    wi: torch.Tensor       # (..., 3) incident direction, local frame
    J: torch.Tensor        # (...,) path-space Jacobian (1 when detached)
    bc: torch.Tensor       # (..., 2) barycentrics
    tri_id: torch.Tensor   # (...,) int32 global triangle id (-1 = miss)
    mesh_id: torch.Tensor  # (...,) int32 mesh index
