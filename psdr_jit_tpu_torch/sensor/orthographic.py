"""Orthographic camera (counterpart of
``psdr_jit_tpu/sensor/orthographic.py``; reference
src/sensor/orthographic.cpp)."""

from __future__ import annotations

import torch

from ..core import transform as xf
from ..core.math import norm
from ..shape.mesh import cpu_f32
from .sensor import Sensor, SensorData, build_primary_edges


class OrthographicCamera(Sensor):
    def __init__(self, near=1e-6, far=1e7):
        self.near_clip = float(near)
        self.far_clip = float(far)
        self.to_world_raw = torch.eye(4, dtype=torch.float32)
        self.to_world_left = torch.eye(4, dtype=torch.float32)
        self.to_world_right = torch.eye(4, dtype=torch.float32)
        self.id = ""

    def configure_data(self, width: int, height: int, mesh_list=(),
                       mesh_datas=(), with_edges: bool = False) -> SensorData:
        """Camera compile on the CPU (orthographic.cpp:10-150): parallel
        rays over the view plane, with the importance 1 / (its world area)
        and, with ``with_edges``, the meshes' edges classified against the
        view direction."""
        aspect = float(width) / float(height)
        camera_to_sample = (xf.scale([-0.5, -0.5 * aspect, 1.0])
                            @ xf.translate([-1.0, -1.0 / aspect, 0.0])
                            @ xf.orthographic(self.near_clip, self.far_clip))
        sample_to_camera = torch.linalg.inv(camera_to_sample)
        to_world = (cpu_f32(self.to_world_left) @ cpu_f32(self.to_world_raw)
                    @ cpu_f32(self.to_world_right))
        world_to_sample = camera_to_sample @ torch.linalg.inv(to_world)
        camera_pos = xf.transform_pos(to_world, torch.zeros(3))
        camera_dir = xf.transform_dir(to_world, torch.tensor([0.0, 0.0, 1.0]))

        def corner(x, y):
            return xf.transform_pos(sample_to_camera,
                                    torch.tensor([x, y, 0.0]))

        v00, v10, v11 = corner(0.0, 0.0), corner(1.0, 0.0), corner(1.0, 1.0)
        # 1 / (world area of the view plane); the reference scales by
        # |vc|^2 (orthographic.cpp's copy of perspective.cpp:44), which
        # couples W_e to the near clip (JAX orthographic.py:75-78)
        inv_area = 1.0 / (norm(v00 - v10) * norm(v11 - v10))
        edge_info = (build_primary_edges(camera_pos, world_to_sample,
                                         mesh_list, mesh_datas,
                                         camera_dir=camera_dir)
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
            ortho=True,
        )

    def to_string(self) -> str:
        return "OrthographicCamera"
