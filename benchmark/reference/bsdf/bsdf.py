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
without a material (slot -1) get zeros.

Two types hold more than bitmaps. The per-vertex Microfacet BSDFs'
tables are concatenated into one, with a first row a slot
(``bsdf/microfacet_pv.py``). A normal map's nested BSDFs form a
``Materials`` of their own (``Materials.nested``), with a slot there for
each normal-map slot (``Materials.inner``): the normal map's pass builds
the perturbed intersections and dispatches them by type again
(``bsdf/normalmap.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.bitmap import Bitmap, BitmapTable
from ..core.math import detached
from ..core.object import Object
from ..core.records import BSDFSample

(DIFFUSE, MICROFACET, ROUGH_CONDUCTOR, ROUGH_DIELECTRIC, MICROFACET_PV,
 NORMALMAP) = range(6)


# each type's parameters in the rows of the other types' slots: a type's
# pass evaluates every lane, and values such as a roughness or an index of
# 0 would put infinities into the masked lanes' derivatives, where autograd
# multiplies them by 0 and leaves NaNs (the JAX package evaluates each
# instance with its own parameters)
_FILL = {DIFFUSE: (0.0,), MICROFACET: (0.0, 0.0, 0.5),
         ROUGH_CONDUCTOR: (0.5, 0.5, 1.0, 0.0, 0.0),
         ROUGH_DIELECTRIC: (0.5, 0.5, 1.5), NORMALMAP: ((0.5, 0.5, 1.0),)}


class BSDF(Object):
    """Interface of a material: ``eval`` (f cos theta_o, differentiable),
    ``sample`` (a detached :class:`BSDFSample`) and ``pdf`` (detached),
    all on local-frame directions of an intersection ``its`` (its ``wi``,
    ``uv``, ``bc``, ``face_indices`` and ``dp_du``; an
    :class:`~psdr_jit_tpu_torch.core.types.Intersection`).
    ``_tensor_fields`` names the attributes that hold its parameters
    (tensors, bitmaps or a nested BSDF), which the scene compile maps.

    The methods evaluate this one BSDF on every lane, through the scene's
    dispatch on a table of one slot: the type's functional form
    (``diffuse_eval``, ``microfacet_sample``, ...) with the BSDF's
    parameters read at each lane's ``uv``."""

    twoSide: bool = False
    _tensor_fields: tuple = ()

    def _lanes(self, ref, active):
        """``(the one-slot material table, slot 0 a lane, active)`` on the
        device of ``ref`` (..., 3)."""
        shape, device = ref.shape[:-1], ref.device
        slot = torch.zeros(shape, dtype=torch.int64, device=device)
        if active is None:
            active = torch.ones(shape, dtype=torch.bool, device=device)
        return material_table([self], device), slot, active

    def eval(self, its, wo, active=None):
        """f(wi, wo) cos(theta_o) at local ``wo`` (..., 3): (..., 3),
        attached to the parameters and the directions."""
        table, slot, active = self._lanes(wo, active)
        return eval_dispatch(table, slot, its, wo, active)

    def sample(self, its, rnd3, active=None) -> BSDFSample:
        """A direction from the uniforms ``rnd3`` (..., 3); detached."""
        with detached():
            table, slot, active = self._lanes(rnd3, active)
            return sample_dispatch(table, slot, its, rnd3, active)

    def pdf(self, its, wo, active=None):
        """The solid-angle density of ``wo``; detached."""
        with detached():
            table, slot, active = self._lanes(wo, active)
            return pdf_dispatch(table, slot, its, wo, active)

    def anisotropic(self) -> bool:
        return False

    def to_string(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Materials:
    """The scene's BSDFs as per-type tables, a row a slot."""

    kind: torch.Tensor      # (n,) int64 type of each slot
    two_side: torch.Tensor  # (n,) bool
    # type -> its parameters: a BitmapTable each for DIFFUSE (reflectance,),
    # MICROFACET (specular, diffuse, roughness), ROUGH_CONDUCTOR (alpha_u,
    # alpha_v, eta, k, specular), ROUGH_DIELECTRIC (alpha_u, alpha_v, eta)
    # and NORMALMAP (nmap,); MICROFACET_PV (the (rows, 7) per-vertex table,
    # each slot's first row (n,) int64)
    params: dict
    nested: Optional["Materials"] = None  # a normal map's nested BSDFs
    inner: Optional[torch.Tensor] = None  # (n,) int64 slot in nested


def _bitmaps(b):
    """``(type, parameter bitmaps)`` of a BSDF with bitmap parameters."""
    from .diffuse import DiffuseBSDF
    from .microfacet import MicrofacetBSDF
    from .normalmap import NormalMapBSDF
    from .roughconductor import RoughConductorBSDF
    from .roughdielectric import RoughDielectricBSDF

    if isinstance(b, DiffuseBSDF):
        return DIFFUSE, (b.reflectance,)
    if isinstance(b, MicrofacetBSDF):
        return MICROFACET, (b.specularReflectance, b.diffuseReflectance,
                            b.roughness)
    if isinstance(b, RoughConductorBSDF):
        return ROUGH_CONDUCTOR, (b.alpha_u, b.alpha_v, b.eta, b.k,
                                 b.specular_reflectance)
    if isinstance(b, RoughDielectricBSDF):
        return ROUGH_DIELECTRIC, (b.alpha_u, b.alpha_v, Bitmap.from_value(
            b.eta_value, 1))
    if isinstance(b, NormalMapBSDF):
        return NORMALMAP, (b.nmap,)
    raise NotImplementedError(f"{type(b).__name__}: not a BSDF of the port")


def material_table(bsdfs, device) -> Materials:
    """Per-type parameter tables of the scene's BSDFs on ``device``."""
    from .microfacet_pv import MicrofacetBSDFPerVertex, packed_table

    kinds, maps = [], []
    for b in bsdfs:
        if isinstance(b, MicrofacetBSDFPerVertex):
            kinds.append(MICROFACET_PV)
            maps.append(None)
        else:
            k, m = _bitmaps(b)
            kinds.append(k)
            maps.append(m)
    params = {}
    for k in sorted(set(kinds) - {MICROFACET_PV}):
        # each slot's own bitmaps in this type's table, _FILL for the
        # other types' slots
        first = maps[kinds.index(k)]
        fill = [Bitmap.from_value(v, bm.channels)
                for v, bm in zip(_FILL[k], first)]
        rows = [m if kk == k else fill for kk, m in zip(kinds, maps)]
        params[k] = tuple(BitmapTable.build([r[i] for r in rows], device)
                          for i in range(len(first)))
    if MICROFACET_PV in kinds:
        tables, offset, row = [], [], 0
        for kk, b in zip(kinds, bsdfs):
            offset.append(row)
            if kk == MICROFACET_PV:
                tables.append(packed_table(b).to(device))
                row += tables[-1].shape[0]
        params[MICROFACET_PV] = (torch.cat(tables), torch.tensor(
            offset, dtype=torch.int64, device=device))
    nested = inner = None
    if NORMALMAP in kinds:
        wrapped = [b.bsdf for kk, b in zip(kinds, bsdfs) if kk == NORMALMAP]
        nested = material_table(wrapped, device)
        inner = (torch.cumsum(torch.tensor(
            [kk == NORMALMAP for kk in kinds], dtype=torch.int64), 0) - 1)
        inner = torch.where(torch.tensor(kinds) == NORMALMAP, inner,
                            -1).to(device)
    return Materials(
        kind=torch.tensor(kinds, dtype=torch.int64).to(device),
        two_side=torch.tensor([b.twoSide for b in bsdfs],
                              dtype=torch.bool).to(device),
        params=params, nested=nested, inner=inner)


def _passes(materials, slot, active):
    """``(type, its lanes, its parameters, the lanes' slots, two-sided
    flags)`` for each type present."""
    if not materials.params:
        return
    j = torch.clamp(slot, min=0).long()
    m = active & (slot >= 0)
    kind, two = materials.kind[j], materials.two_side[j]
    for k, tables in materials.params.items():
        mk = m & (kind == k) if len(materials.params) > 1 else m
        yield k, mk, tables, j, two


def _detached_eval(table, j, uv):
    """A parameter's lane values, detached (sampling and pdfs)."""
    with detached():
        return table.eval(j, uv)[..., 0]


def _pv_values(tables, j, its, m):
    """The per-vertex table interpolated at each lane's hit: ``(..., 7)``."""
    from .microfacet_pv import interpolate

    table, offset = tables
    rows = offset[j][..., None] + its.face_indices.long()
    return interpolate(table, torch.where(m[..., None], rows, 0), its.bc)


def _nested(materials, j):
    return materials.nested, materials.inner[j]


def eval_dispatch(materials, slot, its, wo, active):
    """``(..., 3)`` f cos theta_o of each lane's material at its hit's
    ``uv``; 0 for slot -1. ``materials`` is :func:`material_table`'s."""
    from .diffuse import diffuse_eval
    from .microfacet import microfacet_eval
    from .microfacet_pv import microfacet_pv_eval
    from .normalmap import normalmap_eval
    from .roughconductor import roughconductor_eval
    from .roughdielectric import roughdielectric_eval

    out = torch.zeros(wo.shape, dtype=torch.float32, device=wo.device)
    for k, m, tables, j, two in _passes(materials, slot, active):
        if k == MICROFACET_PV:
            v = _pv_values(tables, j, its, m)
            val = microfacet_pv_eval(v[..., 0:3], v[..., 3:6], v[..., 6],
                                     two, its.wi, wo, m)
            out = torch.where(m[..., None], val, out)
            continue
        p = [t.eval(j, its.uv) for t in tables]
        if k == DIFFUSE:
            val = diffuse_eval(p[0], two, its.wi, wo, m)
        elif k == MICROFACET:
            val = microfacet_eval(p[0], p[1], p[2][..., 0], two, its.wi, wo,
                                  m)
        elif k == ROUGH_CONDUCTOR:
            val = roughconductor_eval(p[0][..., 0], p[1][..., 0], p[2], p[3],
                                      p[4], two, its.wi, wo, m)
        elif k == ROUGH_DIELECTRIC:
            val = roughdielectric_eval(p[0][..., 0], p[1][..., 0],
                                       p[2][..., 0], two, its.wi, wo, m)
        else:
            val = normalmap_eval(p[0], *_nested(materials, j), two, its, wo,
                                 m)
        out = torch.where(m[..., None], val, out)
    return out


def sample_dispatch(materials, slot, its, rnd3, active) -> BSDFSample:
    """Each lane's material's detached sample, with the relative index
    ``eta`` it crossed (1 where it reflects or has no material)."""
    from .diffuse import diffuse_sample
    from .microfacet import ggx_reflection_sample, microfacet_sample
    from .normalmap import normalmap_sample
    from .roughdielectric import roughdielectric_sample

    shape = rnd3.shape[:-1]
    out = BSDFSample(
        wo=rnd3.new_zeros(shape + (3,)), pdf=rnd3.new_zeros(shape),
        eta=rnd3.new_ones(shape),
        is_valid=torch.zeros(shape, dtype=torch.bool, device=rnd3.device))
    uv = its.uv
    for k, m, tables, j, two in _passes(materials, slot, active):
        if k == DIFFUSE:
            bs = diffuse_sample(two, its.wi, rnd3, m)
        elif k == MICROFACET:
            bs = microfacet_sample(_detached_eval(tables[2], j, uv), two,
                                   its.wi, rnd3, m)
        elif k == ROUGH_CONDUCTOR:
            bs = ggx_reflection_sample(
                _detached_eval(tables[0], j, uv),
                _detached_eval(tables[1], j, uv), two, its.wi, rnd3, m)
        elif k == ROUGH_DIELECTRIC:
            bs = roughdielectric_sample(
                *(_detached_eval(t, j, uv) for t in tables), two, its.wi,
                rnd3, m)
        elif k == MICROFACET_PV:
            with detached():
                rough = _pv_values(tables, j, its, m)[..., 6]
            bs = microfacet_sample(rough, two, its.wi, rnd3, m)
        else:
            with detached():
                nmap = tables[0].eval(j, uv)
            bs = normalmap_sample(nmap, *_nested(materials, j), two, its,
                                  rnd3, m)
        out = BSDFSample(wo=torch.where(m[..., None], bs.wo, out.wo),
                         pdf=torch.where(m, bs.pdf, out.pdf),
                         eta=torch.where(m, bs.eta, out.eta),
                         is_valid=torch.where(m, bs.is_valid, out.is_valid))
    return out


def pdf_dispatch(materials, slot, its, wo, active):
    """Each lane's material's detached solid-angle density of ``wo``."""
    from .diffuse import diffuse_pdf
    from .microfacet import ggx_reflection_pdf, microfacet_pdf
    from .normalmap import normalmap_pdf
    from .roughdielectric import roughdielectric_pdf

    out = torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    uv = its.uv
    for k, m, tables, j, two in _passes(materials, slot, active):
        if k == DIFFUSE:
            val = diffuse_pdf(two, its.wi, wo, m)
        elif k == MICROFACET:
            val = microfacet_pdf(_detached_eval(tables[2], j, uv), two,
                                 its.wi, wo, m)
        elif k == ROUGH_CONDUCTOR:
            val = ggx_reflection_pdf(_detached_eval(tables[0], j, uv),
                                     _detached_eval(tables[1], j, uv), two,
                                     its.wi, wo, m)
        elif k == ROUGH_DIELECTRIC:
            val = roughdielectric_pdf(
                *(_detached_eval(t, j, uv) for t in tables), two, its.wi,
                wo, m)
        elif k == MICROFACET_PV:
            with detached():
                rough = _pv_values(tables, j, its, m)[..., 6]
            val = microfacet_pdf(rough, two, its.wi, wo, m)
        else:
            with detached():
                nmap = tables[0].eval(j, uv)
            val = normalmap_pdf(nmap, *_nested(materials, j), two, its, wo,
                                m)
        out = torch.where(m, val, out)
    return out
