"""Lambertian BSDF with a constant reflectance (counterpart of
``psdr_jit_tpu/bsdf/diffuse.py``; textured reflectance is not ported)."""

from __future__ import annotations

import torch

from .bsdf import BSDF


class DiffuseBSDF(BSDF):
    def __init__(self, reflectance=(0.5, 0.5, 0.5), twoSide: bool = False):
        self.reflectance = reflectance
        self.twoSide = bool(twoSide)

    @property
    def reflectance(self) -> torch.Tensor:
        """The constant RGB reflectance, ``(3,)`` float32. A tensor set
        here keeps its autograd graph, so a training step can set it."""
        return self._reflectance

    @reflectance.setter
    def reflectance(self, value):
        refl = torch.as_tensor(value, dtype=torch.float32).reshape(-1)
        if refl.numel() == 1:
            refl = refl.repeat(3)
        if refl.numel() != 3:
            raise NotImplementedError(
                "DiffuseBSDF takes a constant RGB reflectance; textured "
                "reflectance comes with the rest of the BSDF surface")
        self._reflectance = refl

    def __repr__(self) -> str:
        return f"DiffuseBSDF[reflectance={self.reflectance.tolist()}]"
