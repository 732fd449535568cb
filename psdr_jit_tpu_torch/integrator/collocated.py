"""Collocated point light: ``BSDF(wi, wi) * intensity / t^2`` at the camera
hit (counterpart of ``psdr_jit_tpu/integrator/collocated.py``; reference
src/integrator/collocated.cpp). One intersection a lane, through
``SceneData.ray_intersect``; no draws."""

from __future__ import annotations

import torch

from ..core.math import safe_div
from ..core.types import Ray
from .base import Integrator


def _rgb(v) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float32).detach().reshape(-1)
    return v.repeat(3) if v.shape[0] == 1 else v


class CollocatedIntegrator(Integrator):
    """CollocatedIntegrator(intensity): a light at the camera's eye of
    ``intensity`` (a scalar is taken for all three channels)."""

    def __init__(self, intensity):
        self.m_intensity = intensity

    # the reference's attribute name (psdr.cpp binds 'm_intensity')
    @property
    def m_intensity(self) -> torch.Tensor:
        return self.intensity

    @m_intensity.setter
    def m_intensity(self, v):
        self.intensity = _rgb(v)
        self._on_device = {}

    def _intensity_on(self, device) -> torch.Tensor:
        """The intensity on ``device``, copied there once (a copy each
        chunk would make the host wait for the card)."""
        if self.intensity.device == device:
            return self.intensity
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = self.intensity.to(device)
        return self._on_device[key]

    def Li(self, sd, sampler, ray, active, diff: bool = False,
           vjp_ok: bool = False, tape=None):
        if not diff:
            ray = Ray(ray.o.detach(), ray.d.detach())
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path",
                               tape=tape)
        active = active & its.valid
        value = sd.eval_bsdf(its, its.wi, active)
        value = value * safe_div(torch.ones_like(its.t),
                                 its.t * its.t)[..., None]
        value = value * self._intensity_on(value.device)
        return torch.where(active[..., None], value, 0.0)
