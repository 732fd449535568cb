"""Homogeneous 4x4 transforms (counterpart of
``psdr_jit_tpu/core/transform.py``).

Row convention: ``transform_pos(M, v) = (M @ [v, 1]).xyz / w``. Matrices
are float32 tensors.
"""

from __future__ import annotations

import torch

from .math import cross, normalize


def translate(v):
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 3] = torch.as_tensor(v, dtype=torch.float32)
    return m


def scale(v):
    v = torch.as_tensor(v, dtype=torch.float32)
    return torch.diag(torch.cat([v, torch.ones(1, dtype=torch.float32)]))


def perspective(fov_deg, near, far):
    """Projection to [-1,1]^2 x [0,1] depth (reference transform.h:48-61).

    Same float32 operation order as the JAX package: the camera matrices
    of the two packages agree to the last bit or two."""
    recip = 1.0 / (far - near)
    tan = torch.tan(torch.deg2rad(
        torch.tensor(fov_deg, dtype=torch.float32) * 0.5))
    cot = 1.0 / tan
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = far * recip
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return m


def orthographic(near, far):
    """Orthographic depth remap (reference transform.h:73-76)."""
    return (scale([1.0, 1.0, 1.0 / (far - near)])
            @ translate([0.0, 0.0, -near]))


def look_at(origin, target, up):
    """Camera-to-world matrix whose columns are ``[left, new_up, dir,
    origin]`` (reference transform.h:85-103)."""
    origin, target, up = (torch.as_tensor(x, dtype=torch.float32)
                          for x in (origin, target, up))
    dir_ = normalize(target - origin)
    left = normalize(cross(up, dir_))
    new_up = cross(dir_, left)
    m = torch.stack([left, new_up, dir_, origin], dim=-1)
    return torch.cat([m, torch.tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)


def transform_pos(m, v):
    """Apply 4x4 ``m`` to points ``v`` (..., 3) with perspective divide."""
    rot = m[..., :3, :3]
    r = (v[..., 0:1] * rot[..., :, 0] + v[..., 1:2] * rot[..., :, 1]
         + v[..., 2:3] * rot[..., :, 2] + m[..., :3, 3])
    w = (v[..., 0] * m[..., 3, 0] + v[..., 1] * m[..., 3, 1]
         + v[..., 2] * m[..., 3, 2] + m[..., 3, 3])
    return r / w[..., None]


def transform_dir(m, v):
    """Apply the linear part of ``m`` to directions ``v`` (..., 3)."""
    rot = m[..., :3, :3]
    return (v[..., 0:1] * rot[..., :, 0] + v[..., 1:2] * rot[..., :, 1]
            + v[..., 2:3] * rot[..., :, 2])
