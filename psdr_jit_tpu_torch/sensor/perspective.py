"""Perspective camera (counterpart of
``psdr_jit_tpu/sensor/perspective.py``), in its field-of-view form or its
intrinsic form (focal lengths and principal point in units of the film,
the reference's six-float constructor)."""

from __future__ import annotations

import torch

from ..core import transform as xf
from ..core.math import norm, squared_norm
from ..shape.mesh import cpu_f32
from .sensor import Sensor, SensorData, build_primary_edges


class PerspectiveCamera(Sensor):
    """``PerspectiveCamera(fov, near, far)``, the horizontal field of view
    in degrees, or ``PerspectiveCamera(fx, fy, cx, cy, near, far)``, the
    intrinsic form (also :meth:`from_intrinsic`), whose projection applies
    no aspect term (perspective.cpp:13-26)."""

    def __init__(self, fov=60.0, near=1e-6, far=1e7, *intrinsic_rest):
        self.use_intrinsic = bool(intrinsic_rest)
        if self.use_intrinsic:
            if len(intrinsic_rest) != 3:
                raise TypeError("PerspectiveCamera takes (fov, near, far) "
                                "or (fx, fy, cx, cy, near, far)")
            self.fx, self.fy, self.cx = float(fov), float(near), float(far)
            self.cy, near, far = (float(v) for v in intrinsic_rest)
            fov = 60.0
        else:
            self.fx = self.fy = self.cx = self.cy = 0.0
        self.fov = float(fov)
        self.near_clip = float(near)
        self.far_clip = float(far)
        self.to_world_raw = torch.eye(4, dtype=torch.float32)
        self.to_world_left = torch.eye(4, dtype=torch.float32)
        self.to_world_right = torch.eye(4, dtype=torch.float32)
        self.id = ""

    @staticmethod
    def from_intrinsic(fx, fy, cx, cy, near=1e-6, far=1e7):
        """The intrinsic form: focal lengths ``fx``, ``fy`` and principal
        point ``cx``, ``cy``, in units of the film's width and height."""
        return PerspectiveCamera(fx, fy, cx, cy, near, far)

    def _camera_to_sample(self, aspect: float):
        """perspective.cpp:13-26."""
        if self.use_intrinsic:
            return (xf.scale([-0.5, -0.5, 1.0])
                    @ xf.translate([-1.0, -1.0, 0.0])
                    @ xf.perspective_intrinsic(
                        self.fx, self.fy, self.cx, self.cy, self.near_clip,
                        self.far_clip))
        return (xf.scale([-0.5, -0.5 * aspect, 1.0])
                @ xf.translate([-1.0, -1.0 / aspect, 0.0])
                @ xf.perspective(self.fov, self.near_clip, self.far_clip))

    def configure_data(self, width: int, height: int, mesh_list=(),
                       mesh_datas=(), with_edges: bool = False) -> SensorData:
        """Camera compile on the CPU (perspective.cpp:10-152); with
        ``with_edges`` it projects the meshes' edges for the primary-edge
        pass."""
        camera_to_sample = self._camera_to_sample(float(width) / float(height))
        sample_to_camera = torch.linalg.inv(camera_to_sample)
        to_world = (cpu_f32(self.to_world_left) @ cpu_f32(self.to_world_raw)
                    @ cpu_f32(self.to_world_right))
        world_to_sample = camera_to_sample @ torch.linalg.inv(to_world)
        camera_pos = xf.transform_pos(to_world, torch.zeros(3))
        camera_dir = xf.transform_dir(to_world, torch.tensor([0.0, 0.0, 1.0]))

        def corner(x, y):
            return xf.transform_pos(sample_to_camera, torch.tensor([x, y, 0.0]))

        v00, v10, v11, vc = (corner(0.0, 0.0), corner(1.0, 0.0),
                             corner(1.0, 1.0), corner(0.5, 0.5))
        inv_area = squared_norm(vc) / (norm(v00 - v10) * norm(v11 - v10))
        edge_info = (build_primary_edges(camera_pos, world_to_sample,
                                         mesh_list, mesh_datas)
                     if with_edges else None)
        return SensorData(
            sample_to_camera=sample_to_camera,
            to_world=to_world,
            world_to_sample=world_to_sample,
            camera_pos=camera_pos,
            camera_dir=camera_dir,
            inv_area=inv_area,
            edge_info=edge_info,
            width=width,
            height=height,
        )

    def to_string(self) -> str:
        return "PerspectiveCamera"
