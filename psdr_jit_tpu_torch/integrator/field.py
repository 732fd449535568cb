"""AOV extraction (counterpart of ``psdr_jit_tpu/integrator/field.py``;
reference src/integrator/field.cpp): one field of the camera hit a lane,
with an optional per-object filter. One intersection a lane, through
``SceneData.ray_intersect``; no draws."""

from __future__ import annotations

import torch

from ..core.types import Ray
from .base import Integrator

FIELDS = ("bsdf", "segmentation", "silhouette", "position", "depth",
          "geoNormal", "shNormal", "uv")


class FieldExtractionIntegrator(Integrator):
    """FieldExtractionIntegrator("field [object]"): ``field`` one of
    :data:`FIELDS`; ``object`` keeps only the hits on meshes whose
    ``Mesh.id`` is that string, or, as ``obj:<k>``, on mesh ``k``."""

    def __init__(self, field: str):
        parts = field.split()
        if not parts or parts[0] not in FIELDS:
            raise ValueError(f"Unsupported field: {field!r}; one of {FIELDS}")
        self.field = parts[0]
        self.object = parts[1] if len(parts) > 1 else ""

    def Li(self, sd, sampler, ray, active, diff: bool = False,
           vjp_ok: bool = False, tape=None):
        if not diff:
            ray = Ray(ray.o.detach(), ray.d.detach())
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path",
                               tape=tape)
        # the environment map's bounding mesh has no BSDF (field.cpp:53-56)
        active = active & its.valid & (sd.bsdf_slot(its) >= 0)
        if self.object:
            if self.object.startswith("obj:"):
                allowed = [int(self.object[4:])]
            else:
                allowed = [i for i, mid in enumerate(sd.mesh_ids)
                           if mid == self.object]
            keep = torch.zeros_like(active)
            for k in allowed:
                keep = keep | (its.mesh_id == k)
            active = active & keep
        f = self.field
        if f == "segmentation":
            result = its.mesh_id.to(torch.float32)[..., None].expand(
                its.t.shape + (3,))
        elif f == "bsdf":
            result = sd.eval_bsdf(its, its.wi, active)
        elif f == "silhouette":
            result = torch.ones(its.t.shape + (3,), dtype=torch.float32,
                                device=its.t.device)
        elif f == "position":
            result = its.p
        elif f == "depth":
            result = its.t[..., None].expand(its.t.shape + (3,))
        elif f == "geoNormal":
            result = its.n
        elif f == "shNormal":
            result = its.sh_frame.n
        else:  # "uv"
            result = torch.stack([its.uv[..., 0], its.uv[..., 1],
                                  torch.zeros_like(its.t)], dim=-1)
        return torch.where(active[..., None], result, 0.0)
