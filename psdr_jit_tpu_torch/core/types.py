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
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI


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

    def __call__(self, t):
        """The points at distances ``t`` (...,) along the rays."""
        return self.o + self.d * t[..., None]

    def reversed(self) -> "Ray":
        return Ray(self.o, -self.d)


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

    def to_world(self, v):
        return (self.s * v[..., 0:1] + self.t * v[..., 1:2]
                + self.n * v[..., 2:3])


def _sin_theta_2(v):
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]


def _inv_sin_theta(s2):
    from .math import _sqrt

    return 1.0 / _sqrt(torch.clamp(s2, min=1e-30))


def sin_phi(v):
    """sin(phi) of local directions (..., 3); 0 at the pole
    (reference frame.h)."""
    s2 = _sin_theta_2(v)
    return torch.where(torch.abs(s2) <= 4.0 * EPSILON, 0.0, torch.clamp(
        v[..., 1] * _inv_sin_theta(s2), -1.0, 1.0))


def cos_phi(v):
    """cos(phi) of local directions (..., 3); 1 at the pole."""
    s2 = _sin_theta_2(v)
    return torch.where(torch.abs(s2) <= 4.0 * EPSILON, 1.0, torch.clamp(
        v[..., 0] * _inv_sin_theta(s2), -1.0, 1.0))


@dataclasses.dataclass
class Intersection:
    """Detached surface interaction record of the path formulation
    (reference core/intersection.h:7-60)."""

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
    uv: torch.Tensor       # (..., 2) texture coordinates (0 without)
    dp_du: torch.Tensor    # (..., 3) dp/du (0 without a UV frame)
    dp_dv: torch.Tensor    # (..., 3) dp/dv
    face_indices: torch.Tensor  # (..., 3) int32 the hit face's vertex ids,
    #                             local to its mesh

    def is_valid(self):
        return self.valid
