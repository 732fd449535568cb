"""BSDF base class and the per-lane dispatch (counterpart of
``psdr_jit_tpu/bsdf/bsdf.py``).

The JAX package dispatches by a masked loop over the scene's BSDF
instances. Here the loop runs over BSDF *types*: :func:`material_table`
(``SceneData.materials``) stacks each type's parameters into one table
with a row a slot (zeros in the rows of other types' slots), each lane
gathers its material's row by slot, every type present evaluates its
lanes in one pass, and the results combine with ``torch.where``. A
textured parameter is read per lane at the hit's ``uv`` from one atlas of
the type's textures (``core.bitmap.BitmapTable``). So the launches of a
bounce do not grow with the number of BSDF instances or textures. Lanes
without a material (slot -1) get zeros."""

from __future__ import annotations

import dataclasses

import torch

from ..core.bitmap import Bitmap, BitmapTable
from ..core.math import detached
from ..core.records import BSDFSample

DIFFUSE, MICROFACET = 0, 1


class BSDF:
    """Interface of a material: ``eval`` (f cos theta_o, differentiable),
    ``sample`` (a detached :class:`BSDFSample`) and ``pdf`` (detached),
    all on local-frame directions of an intersection ``its``.
    ``_tensor_fields`` names the attributes that hold its parameters
    (tensors or bitmaps), which the scene compile maps."""

    twoSide: bool = False
    _tensor_fields: tuple = ()

    def __repr__(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Materials:
    """The scene's BSDFs as per-type tables, a row a slot."""

    kind: torch.Tensor      # (n,) int64 type of each slot
    two_side: torch.Tensor  # (n,) bool
    # type -> its parameters, a BitmapTable each: DIFFUSE (reflectance,),
    # MICROFACET (specular, diffuse, roughness)
    params: dict


def material_table(bsdfs, device) -> Materials:
    """Per-type parameter tables of the scene's BSDFs on ``device``."""
    from .diffuse import DiffuseBSDF
    from .microfacet import MicrofacetBSDF

    kinds, rows = [], {DIFFUSE: [], MICROFACET: []}
    z3, z1 = Bitmap.from_value(0.0, 3), Bitmap.from_value(0.0, 1)
    for b in bsdfs:
        if isinstance(b, DiffuseBSDF):
            kinds.append(DIFFUSE)
            d, m = (b.reflectance,), (z3, z3, z1)
        elif isinstance(b, MicrofacetBSDF):
            kinds.append(MICROFACET)
            d, m = (z3,), (b.specularReflectance, b.diffuseReflectance,
                           b.roughness)
        else:
            raise NotImplementedError(
                f"{type(b).__name__}: only DiffuseBSDF and MicrofacetBSDF "
                "are ported")
        rows[DIFFUSE].append(d)
        rows[MICROFACET].append(m)
    params = {k: tuple(BitmapTable.build([r[i] for r in rows[k]], device)
                       for i in range(len(rows[k][0])))
              for k in sorted(set(kinds))}
    return Materials(
        kind=torch.tensor(kinds, dtype=torch.int64).to(device),
        two_side=torch.tensor([b.twoSide for b in bsdfs],
                              dtype=torch.bool).to(device),
        params=params)


def _passes(materials, slot, active):
    """``(type, its lanes, its parameter tables, the lanes' slots,
    two-sided flags)`` for each type present."""
    if not materials.params:
        return
    j = torch.clamp(slot, min=0).long()
    m = active & (slot >= 0)
    kind, two = materials.kind[j], materials.two_side[j]
    for k, tables in materials.params.items():
        mk = m & (kind == k) if len(materials.params) > 1 else m
        yield k, mk, tables, j, two


def _roughness(tables, j, uv):
    """The Microfacet lanes' roughness, detached (sampling and pdfs)."""
    with detached():
        return tables[2].eval(j, uv)[..., 0]


def eval_dispatch(materials, slot, its, wo, active):
    """``(..., 3)`` f cos theta_o of each lane's material at its hit's
    ``uv``; 0 for slot -1. ``materials`` is :func:`material_table`'s."""
    from .diffuse import diffuse_eval
    from .microfacet import microfacet_eval

    out = torch.zeros(wo.shape, dtype=torch.float32, device=wo.device)
    for k, m, tables, j, two in _passes(materials, slot, active):
        p = [t.eval(j, its.uv) for t in tables]
        if k == DIFFUSE:
            val = diffuse_eval(p[0], two, its.wi, wo, m)
        else:
            val = microfacet_eval(p[0], p[1], p[2][..., 0], two, its.wi, wo,
                                  m)
        out = torch.where(m[..., None], val, out)
    return out


def sample_dispatch(materials, slot, its, rnd3, active) -> BSDFSample:
    from .diffuse import diffuse_sample
    from .microfacet import microfacet_sample

    shape = rnd3.shape[:-1]
    out = BSDFSample(
        wo=rnd3.new_zeros(shape + (3,)), pdf=rnd3.new_zeros(shape),
        eta=rnd3.new_ones(shape),
        is_valid=torch.zeros(shape, dtype=torch.bool, device=rnd3.device))
    for k, m, tables, j, two in _passes(materials, slot, active):
        if k == DIFFUSE:
            bs = diffuse_sample(two, its.wi, rnd3, m)
        else:
            bs = microfacet_sample(_roughness(tables, j, its.uv), two,
                                   its.wi, rnd3, m)
        out = BSDFSample(wo=torch.where(m[..., None], bs.wo, out.wo),
                         pdf=torch.where(m, bs.pdf, out.pdf), eta=out.eta,
                         is_valid=torch.where(m, bs.is_valid, out.is_valid))
    return out


def pdf_dispatch(materials, slot, its, wo, active):
    from .diffuse import diffuse_pdf
    from .microfacet import microfacet_pdf

    out = torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    for k, m, tables, j, two in _passes(materials, slot, active):
        if k == DIFFUSE:
            val = diffuse_pdf(two, its.wi, wo, m)
        else:
            val = microfacet_pdf(_roughness(tables, j, its.uv), two, its.wi,
                                 wo, m)
        out = torch.where(m, val, out)
    return out
