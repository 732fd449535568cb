"""Homogeneous 4x4 transforms (counterpart of
``psdr_jit_tpu/core/transform.py``).

Row convention: ``transform_pos(M, v) = (M @ [v, 1]).xyz / w``. Matrices
are float32 tensors. :class:`TransformStack` is the pose of meshes and
cameras, ``to_world_left @ to_world_raw @ to_world_right``.
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


def rotate(axis, angle_deg):
    """Rotation about ``axis`` by ``angle_deg`` degrees (Rodrigues)."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    theta = torch.deg2rad(torch.as_tensor(angle_deg, dtype=torch.float32))
    s, c = torch.sin(theta), torch.cos(theta)
    x, y, z = axis.unbind()
    zero = torch.zeros((), dtype=torch.float32)
    k = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]),
                     torch.stack([-y, x, zero])])
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] = torch.eye(3, dtype=torch.float32) + s * k + (1.0 - c) * (
        k @ k)
    return m


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


def perspective_intrinsic(fx, fy, cx, cy, near, far):
    """Projection of the intrinsic form: focal lengths and principal point
    in units of the film (reference transform.h:63-71)."""
    recip = 1.0 / (far - near)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = 1.0
    m[1, 1] = 1.0
    m[2, 2] = far * recip
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return (translate([1.0 - 2.0 * cx, 1.0 - 2.0 * cy, 0.0])
            @ scale([2.0 * fx, 2.0 * fy, 1.0]) @ m)


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


class TransformStack:
    """The ``to_world_left @ to_world_raw @ to_world_right`` stack of a mesh
    or a camera (the reference's ``set_transform``/``append_transform``).
    A tensor set here keeps its autograd graph and forward-mode tangent."""

    @property
    def to_world(self):
        return self.to_world_raw

    @to_world.setter
    def to_world(self, m):
        self.to_world_raw = torch.as_tensor(m, dtype=torch.float32)

    def set_transform(self, m, left: bool = True):
        """Set ``to_world_left`` (or, with ``left`` off, ``to_world_right``)."""
        m = torch.as_tensor(m, dtype=torch.float32)
        if left:
            self.to_world_left = m
        else:
            self.to_world_right = m

    def append_transform(self, m, left: bool = True):
        """Compose ``m`` onto the stack: ``m @ left``, or ``right @ m``."""
        m = torch.as_tensor(m, dtype=torch.float32)
        if left:
            self.to_world_left = m @ torch.as_tensor(
                self.to_world_left, dtype=torch.float32)
        else:
            self.to_world_right = torch.as_tensor(
                self.to_world_right, dtype=torch.float32) @ m
