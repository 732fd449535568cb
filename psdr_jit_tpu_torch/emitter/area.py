"""Area light attached to a mesh (counterpart of
``psdr_jit_tpu/emitter/area.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import rgb2luminance
from ..shape.mesh import MeshData
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

    def __repr__(self) -> str:
        return f"AreaLight[radiance={self.radiance.tolist()}]"


@dataclasses.dataclass
class AreaLightData:
    """Configured area light. ``sampling_weight`` is the light's share of
    all emitters' weights (scene.cpp:489-515)."""

    radiance: torch.Tensor          # (3,)
    sampling_weight: torch.Tensor   # ()
    mesh_data: MeshData
    mesh_index: int = -1


def area_light_weight(radiance, mesh_data: MeshData):
    """Unnormalized sampling weight = total area * luminance
    (area.cpp:9-14)."""
    return mesh_data.total_area * rgb2luminance(radiance)
