"""BSDF base class and the per-lane dispatch (counterpart of
``psdr_jit_tpu/bsdf/bsdf.py``).

The JAX package dispatches by a masked loop over the scene's BSDF
instances. Every BSDF of the port is a constant ``DiffuseBSDF``, so here
each lane gathers its material's reflectance and two-sided flag by slot
from the stacked table of :func:`material_table` (``SceneData.materials``)
and evaluates once; lanes without a material (slot -1) get the loop's
zeros."""

from __future__ import annotations

import torch

from ..core.records import BSDFSample


class BSDF:
    """Interface of a material: ``eval`` (f cos theta_o, differentiable),
    ``sample`` (a detached :class:`BSDFSample`) and ``pdf`` (detached),
    all on local-frame directions of an intersection ``its``."""

    twoSide: bool = False

    def __repr__(self) -> str:
        return type(self).__name__


def material_table(bsdfs, device):
    """``(reflectance (n, 3), two_side (n,) bool)`` of the scene's BSDFs."""
    from .diffuse import DiffuseBSDF

    if not all(isinstance(b, DiffuseBSDF) for b in bsdfs):
        raise NotImplementedError("only constant DiffuseBSDFs are ported")
    refl = torch.stack([b.reflectance.to(device) for b in bsdfs])
    two = torch.tensor([b.twoSide for b in bsdfs], dtype=torch.bool).to(
        device)
    return refl, two


def _lanes(materials, slot):
    refl, two = materials
    j = torch.clamp(slot, min=0).long()
    return refl[j], two[j], slot >= 0


def eval_dispatch(materials, slot, its, wo, active):
    """``(..., 3)`` f cos theta_o of each lane's material; 0 for slot -1.
    ``materials`` is :func:`material_table`'s."""
    from .diffuse import diffuse_eval

    refl, two, has = _lanes(materials, slot)
    return diffuse_eval(refl, two, its.wi, wo, active & has)


def sample_dispatch(materials, slot, its, rnd3, active) -> BSDFSample:
    from .diffuse import diffuse_sample

    _, two, has = _lanes(materials, slot)
    m = active & has
    bs = diffuse_sample(two, its.wi, rnd3, m)
    return BSDFSample(wo=torch.where(m[..., None], bs.wo, 0.0),
                      pdf=torch.where(m, bs.pdf, 0.0), eta=bs.eta,
                      is_valid=bs.is_valid)


def pdf_dispatch(materials, slot, its, wo, active):
    from .diffuse import diffuse_pdf

    _, two, has = _lanes(materials, slot)
    return diffuse_pdf(two, its.wi, wo, active & has)
