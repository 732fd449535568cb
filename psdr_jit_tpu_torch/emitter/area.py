"""Area light attached to a mesh (counterpart of
``psdr_jit_tpu/emitter/area.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import rgb2luminance, safe_div
from ..core.records import PositionSample
from ..shape.mesh import MeshData, sample_position
from .emitter import Emitter


class AreaLight(Emitter):
    """Constant-radiance emitter bound to a mesh."""

    def __init__(self, radiance=(1.0, 1.0, 1.0)):
        self.radiance = radiance
        self.mesh_index = -1  # assigned by Scene.add_Mesh
        self.id = ""

    @property
    def radiance(self) -> torch.Tensor:
        """RGB radiance, ``(3,)`` float32; a tensor set here keeps its
        autograd graph."""
        return self._radiance

    @radiance.setter
    def radiance(self, value):
        self._radiance = torch.as_tensor(value, dtype=torch.float32).reshape(3)

    def to_string(self) -> str:
        return f"AreaLight[radiance={self.radiance.tolist()}]"


@dataclasses.dataclass
class AreaLightData:
    """Configured area light. ``sampling_weight`` is the light's share of
    all emitters' weights (scene.cpp:489-515)."""

    radiance: torch.Tensor          # (3,)
    sampling_weight: torch.Tensor   # ()
    mesh_data: MeshData
    mesh_index: int = -1

    def eval(self, its, active):
        """One-sided constant radiance (area.cpp:17-26): ``(..., 3)``."""
        ok = active & (its.wi[..., 2] > 0.0)
        return torch.where(ok[..., None], self.radiance, 0.0)

    def sample_position(self, ref_p, sample2, active,
                        u_coin=None) -> PositionSample:
        """A point on the light, uniform by area (area.cpp:29-45); an area
        light takes no alias coin."""
        ps = sample_position(self.mesh_data, sample2)
        ps.is_valid = ps.is_valid & active
        return ps

    def sample_position_pdf(self, ref_p, its, active):
        """``sampling_weight / total_area`` where the hit is on this light
        (area.cpp:48-59, mesh.cpp:457-466)."""
        ok = active & (its.mesh_id == self.mesh_index)
        inv_area = safe_div(torch.ones_like(self.mesh_data.total_area),
                            self.mesh_data.total_area)
        return torch.where(ok, self.sampling_weight * inv_area, 0.0)


def area_light_weight(radiance, mesh_data: MeshData):
    """Unnormalized sampling weight = total area * luminance
    (area.cpp:9-14)."""
    return mesh_data.total_area * rgb2luminance(radiance)
