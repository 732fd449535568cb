"""The rough conductor, rough dielectric, per-vertex Microfacet and normal
map BSDFs of psdr_jit_tpu_torch against the JAX package's, on the CPU:
each BSDF's eval (and its gradient to ``wo``), sample (with ``eta``) and
pdf on seeded lanes over the whole sphere, the per-vertex tables'
gradient, the dispatch over a material table holding all six types, each
type through ``interop`` and back, renderC of the Cornell box with
each BSDF (``tests/test_bsdf_render.py _cbox_with``'s scenes) at 16x16,
and a training step of the dielectric and normal-map boxes against
``jax.vjp`` of renderD.

Both packages take the same seeded numpy inputs (and draw the same
samples in the renders), so each comparison is lane for lane; each bound
is stated beside its measured value.
"""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import (BSDF_CASES, BSDF_DEPTH, bsdf_cbox_arrays, bsdf_nmap,
                        bsdf_setup)
from psdr_jit_tpu.bsdf import bsdf as jdispatch
from psdr_jit_tpu.core import math as jmath
from psdr_jit_tpu.core.bitmap import Bitmap as JBitmap
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.bsdf import bsdf as tdispatch
from psdr_jit_tpu_torch.core import math as tmath
from psdr_jit_tpu_torch.utils.image import write_image
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
N = 4096
V = 10  # rows of the per-vertex tables
W, SPP, SEED = 16, 4, 3
# rel L1 bounds of the lane-by-lane comparisons: samples, pdfs and most
# evaluations agree to a few 1e-7; on a few lanes of the per-vertex
# Microfacet, 1 - cos^2 of a half vector near the normal cancels and a last
# bit of the normalisation (1/sqrt here, rsqrt in XLA) grows to 4e-5 of
# the lane's value, and autodiff orders a gradient's sums otherwise
BOUND, EVAL_BOUND, GRAD_BOUND = 1e-6, 2e-6, 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


class JIts(types.SimpleNamespace):
    """The fields of an intersection the JAX BSDFs read, with ``replace``."""

    def replace(self, **kw):
        return JIts(**{**vars(self), **kw})


def _texture(rng, h, w, c, lo, hi):
    return rng.uniform(lo, hi, (h, w, c)).astype(np.float32)


def _pair(case, rng):
    """``(JAX BSDF, port BSDF)`` of a unit-test case."""
    two = case.endswith("-2s")
    kind = case.removesuffix("-2s")
    if kind == "conductor":
        args = dict(alpha_u=0.3, alpha_v=0.1, eta=(0.2, 0.92, 1.1),
                    k=(3.9, 2.45, 2.14), specular_reflectance=(0.9, 0.7, 0.5))
        return (psdr.RoughConductorBSDF(**args, twoSide=two),
                pt.RoughConductorBSDF(**args, twoSide=two))
    if kind == "conductor-tex":
        tex = _texture(rng, 5, 7, 1, 0.05, 0.6)
        return (psdr.RoughConductorBSDF(JBitmap.from_array(tex), 0.2),
                pt.RoughConductorBSDF(pt.Bitmap.from_array(_t(tex)), 0.2))
    if kind == "dielectric":
        return (psdr.RoughDielectricBSDF(0.25, 0.15, 1.5, twoSide=two),
                pt.RoughDielectricBSDF(0.25, 0.15, 1.5, twoSide=two))
    if kind == "pv":
        spec = _texture(rng, V, 3, 1, 0.02, 0.3)[..., 0]
        diff = _texture(rng, V, 3, 1, 0.1, 0.9)[..., 0]
        rough = rng.uniform(0.2, 0.8, V).astype(np.float32)
        return (psdr.MicrofacetBSDFPerVertex(spec, diff, rough, twoSide=two),
                pt.MicrofacetBSDFPerVertex(_t(spec), _t(diff), _t(rough),
                                           twoSide=two))
    nmap = _texture(rng, 6, 5, 3, 0.2, 0.8)
    nmap[..., 2] = rng.uniform(0.7, 1.0, (6, 5)).astype(np.float32)
    if kind == "normalmap-diffuse":
        return (psdr.NormalMapBSDF(nmap, psdr.DiffuseBSDF((0.6, 0.5, 0.4))),
                pt.NormalMapBSDF(_t(nmap), pt.DiffuseBSDF((0.6, 0.5, 0.4))))
    # a two-sided map over a one-sided Microfacet
    args = ((0.1, 0.2, 0.3), (0.4, 0.3, 0.2), 0.35)
    return (psdr.NormalMapBSDF(nmap, psdr.MicrofacetBSDF(*args), twoSide=True),
            pt.NormalMapBSDF(_t(nmap), pt.MicrofacetBSDF(*args),
                             twoSide=True))


def _lanes(rng):
    """Seeded lanes: ``wi``, ``wo`` over the whole sphere, ``rnd3``, and
    the hit's ``uv`` (in [-0.3, 1.3]^2: wrapped lookups), barycentrics,
    mesh-local vertex ids and ``dp_du`` (0 on a quarter of the lanes, as
    on meshes without texture coordinates)."""
    wi, wo = _unit(rng, N), _unit(rng, N)
    rnd3 = rng.random((N, 3)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (N, 2)).astype(np.float32)
    bc = rng.random((N, 2)).astype(np.float32)
    flip = bc.sum(-1) > 1.0
    bc[flip] = 1.0 - bc[flip]
    fi = rng.integers(0, V, (N, 3)).astype(np.int32)
    dp_du = rng.standard_normal((N, 3)).astype(np.float32)
    dp_du[rng.random(N) < 0.25] = 0.0
    return dict(wi=wi, wo=wo, rnd3=rnd3, uv=uv, bc=bc, face_indices=fi,
                dp_du=dp_du)


def _its(lanes, jax_side: bool):
    keys = ("wi", "uv", "bc", "face_indices", "dp_du")
    if jax_side:
        return JIts(**{k: jnp.asarray(lanes[k]) for k in keys})
    return types.SimpleNamespace(**{k: _t(lanes[k]) for k in keys})


def _jax_all(bsdfs, slot, lanes):
    """The JAX package's dispatch: eval, its gradient to ``wo``, sample and
    pdf, as numpy."""
    its = _its(lanes, True)
    act = jnp.ones(N, bool)
    slot = jnp.asarray(slot)
    val, vjp = jax.vjp(lambda o: jdispatch.eval_dispatch(
        bsdfs, slot, its, o, act), jnp.asarray(lanes["wo"]))
    (grad,) = vjp(jnp.ones((N, 3), jnp.float32))
    bs = jdispatch.sample_dispatch(bsdfs, slot, its,
                                   jnp.asarray(lanes["rnd3"]), act)
    pdf = jdispatch.pdf_dispatch(bsdfs, slot, its, jnp.asarray(lanes["wo"]),
                                 act)
    return {k: np.asarray(v) for k, v in dict(
        val=val, grad=grad, wo=bs.wo, pdf_s=bs.pdf, eta=bs.eta,
        valid=bs.is_valid, pdf=pdf).items()}


def _port_all(bsdfs, slot, lanes):
    """The port's side of :func:`_jax_all`."""
    mats = tdispatch.material_table(bsdfs, CPU)
    its = _its(lanes, False)
    act = torch.ones(N, dtype=torch.bool)
    slot = _t(slot)
    wo = _t(lanes["wo"]).requires_grad_()
    val = tdispatch.eval_dispatch(mats, slot, its, wo, act)
    (grad,) = torch.autograd.grad(val.sum(), wo)
    bs = tdispatch.sample_dispatch(mats, slot, its, _t(lanes["rnd3"]), act)
    pdf = tdispatch.pdf_dispatch(mats, slot, its, _t(lanes["wo"]), act)
    return {k: v.detach().numpy() for k, v in dict(
        val=val, grad=grad, wo=bs.wo, pdf_s=bs.pdf, eta=bs.eta,
        valid=bs.is_valid, pdf=pdf).items()}


def _check(out, ref, what):
    """Lane-by-lane agreement: validity bitwise, ``eta`` on the valid lanes
    bitwise, the sample and the pdf within ``BOUND`` rel L1, eval within
    ``EVAL_BOUND``, its gradient within ``GRAD_BOUND``; returns the
    measured rel L1s."""
    np.testing.assert_array_equal(out["valid"], ref["valid"], err_msg=what)
    ok = ref["valid"]
    np.testing.assert_array_equal(out["eta"][ok], ref["eta"][ok],
                                  err_msg=what)
    rels = {k: _rel(out[k], ref[k]) for k in ("val", "grad", "pdf")}
    rels.update({k: _rel(out[k][ok], ref[k][ok]) for k in ("wo", "pdf_s")})
    bounds = dict(val=EVAL_BOUND, grad=GRAD_BOUND, pdf=BOUND, wo=BOUND,
                  pdf_s=BOUND)
    assert all(v < bounds[k] for k, v in rels.items()), (what, rels)
    return rels


UNIT_CASES = ("conductor", "conductor-2s", "conductor-tex", "dielectric",
              "dielectric-2s", "pv", "pv-2s", "normalmap-diffuse",
              "normalmap-microfacet")


def test_fresnel_matches_jax():
    """``fresnel_conductor`` (RGB complex index) and ``fresnel_dielectric``
    (eta 1.5 and 1, cosines over [-1, 1] with exact 0 and +-1, so lanes
    with total internal reflection) against ``core/math.py``: conductor
    measured rel L1 0 (bound 1e-6); the dielectric's four outputs
    bitwise."""
    rng = np.random.default_rng(30)
    cos = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    cos[:3] = (0.0, 1.0, -1.0)
    eta = np.tile(np.float32([0.2, 0.92, 1.1]), (N, 1))
    k = np.tile(np.float32([3.9, 2.45, 2.14]), (N, 1))
    ref = np.asarray(jmath.fresnel_conductor(jnp.asarray(eta), jnp.asarray(k),
                                             jnp.asarray(cos)))
    out = tmath.fresnel_conductor(_t(eta), _t(k), _t(cos)).numpy()
    assert _rel(out, ref) < BOUND
    for e in (1.5, 1.0):
        jr = jmath.fresnel_dielectric(jnp.float32(e), jnp.asarray(cos))
        tr = tmath.fresnel_dielectric(torch.full((N,), e), _t(cos))
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(a.numpy(), np.broadcast_to(
                np.asarray(b), (N,)))
        if e == 1.5:
            assert int((tr[0] == 1.0).sum()) > 100  # total internal reflection


@pytest.mark.parametrize("case", UNIT_CASES)
def test_bsdf_matches_jax(case):
    """Each BSDF alone on 4,096 seeded lanes, against the JAX package's:
    eval and its gradient to ``wo``, the sample's ``wo``, pdf, ``eta`` and
    validity, and the pdf. Validity and ``eta`` are equal. Measured rel
    L1 at most: sampled ``wo`` 2.8e-7, sampled pdf 4.6e-7, pdf 4.6e-7
    (bound 1e-6 each); eval 1.3e-6 (per-vertex, bound 2e-6; else at
    most 2.3e-7); its gradient 1.2e-5 (per-vertex, bound 2e-5; the
    dielectric 2.9e-6, else at most 1.5e-6)."""
    rng = np.random.default_rng(31 + UNIT_CASES.index(case))
    jb, tb = _pair(case, rng)
    lanes = _lanes(rng)
    slot = np.zeros(N, np.int32)
    ref = _jax_all((jb,), slot, lanes)
    out = _port_all([tb], slot, lanes)
    _check(out, ref, case)
    assert ref["valid"].mean() > 0.2 and np.abs(ref["val"]).sum() > 0
    if case.startswith("dielectric"):
        inside = lanes["wi"][:, 2] < 0
        refracted = ref["valid"] & (ref["eta"] != 1.0)
        # lanes leaving the inside, refracted (eta 1/1.5) and reflected
        # (eta 1: among them total internal reflection)
        assert (refracted & inside).sum() > 100 or case.endswith("-2s")
        assert (ref["valid"] & (ref["eta"] == 1.0) & inside).sum() > 100 \
            or case.endswith("-2s")
        assert (refracted & ~inside).sum() > 100


def test_microfacet_pv_table_gradient_matches_jax():
    """The gradient of a weighted sum of the per-vertex Microfacet's eval to
    its three tables (``jax.grad`` against autograd through the packed
    table's gather): measured rel L1 specular 6.8e-8, diffuse 3.3e-8,
    roughness 4.0e-6 (bound 2e-5, ``GRAD_BOUND``)."""
    rng = np.random.default_rng(40)
    jb, tb = _pair("pv", rng)
    lanes = _lanes(rng)
    wgt = rng.uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    its = _its(lanes, True)
    act = jnp.ones(N, bool)

    def jloss(tables):
        b = copy.copy(jb)
        b.specularReflectance, b.diffuseReflectance, b.roughness = tables
        return jnp.sum(b.eval(its, jnp.asarray(lanes["wo"]), act) * wgt)

    jg = jax.grad(jloss)((jb.specularReflectance, jb.diffuseReflectance,
                          jb.roughness))
    tabs = [getattr(tb, n).clone().requires_grad_() for n in
            ("specularReflectance", "diffuseReflectance", "roughness")]
    tb.specularReflectance, tb.diffuseReflectance, tb.roughness = tabs
    mats = tdispatch.material_table([tb], CPU)
    val = tdispatch.eval_dispatch(mats, torch.zeros(N, dtype=torch.int64),
                                  _its(lanes, False), _t(lanes["wo"]),
                                  torch.ones(N, dtype=torch.bool))
    tg = torch.autograd.grad((val * _t(wgt)).sum(), tabs)
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        assert np.abs(np.asarray(b)).sum() > 0
        assert _rel(a.numpy(), b) < GRAD_BOUND


def _mixed():
    """A JAX and a port material table of all six types: a Diffuse, a
    Microfacet, a rough conductor, a two-sided rough dielectric, a
    per-vertex Microfacet and a normal map over a rough conductor."""
    rng = np.random.default_rng(50)
    pairs = [(psdr.DiffuseBSDF([0.7, 0.5, 0.3]), pt.DiffuseBSDF(
        [0.7, 0.5, 0.3])),
        (psdr.MicrofacetBSDF((0.04,) * 3, (0.5, 0.4, 0.3), 0.3),
         pt.MicrofacetBSDF((0.04,) * 3, (0.5, 0.4, 0.3), 0.3)),
        _pair("conductor", rng), _pair("dielectric-2s", rng),
        _pair("pv", rng)]
    nmap = _texture(rng, 4, 4, 3, 0.3, 0.7)
    nmap[..., 2] = 1.0
    pairs.append((psdr.NormalMapBSDF(nmap, psdr.RoughConductorBSDF(0.2)),
                  pt.NormalMapBSDF(_t(nmap), pt.RoughConductorBSDF(0.2))))
    return tuple(p[0] for p in pairs), [p[1] for p in pairs], rng


def test_mixed_dispatch_matches_jax():
    """The dispatch by type (one pass a type, the normal map's nested BSDFs
    dispatched again) over a table of all six types and lanes without a
    material (slot -1), against the JAX package's masked loop over
    instances: eval, its gradient, sample with ``eta`` (refracted lanes
    keep theirs: the dispatch carries the sample's ``eta``) and pdf.
    Measured rel L1: eval 1.3e-7, its gradient 3.3e-7, sampled ``wo``
    1.1e-7, sampled pdf 4.0e-7, pdf 1.7e-7 (``_check``'s bounds); validity
    and ``eta`` equal; 0 and ``eta`` 1 without a material."""
    jbsdfs, tbsdfs, rng = _mixed()
    lanes = _lanes(rng)
    slot = rng.integers(-1, 6, N).astype(np.int32)
    ref = _jax_all(jbsdfs, slot, lanes)
    out = _port_all(tbsdfs, slot, lanes)
    _check(out, ref, "mixed")
    none = slot < 0
    assert not out["val"][none].any() and not out["valid"][none].any()
    assert (out["eta"][none] == 1.0).all()
    for k in range(6):
        assert ref["valid"][slot == k].any(), k
    refracted = out["valid"] & (out["eta"] != 1.0)
    assert refracted.sum() > 50 and (slot[refracted] == 3).all()


def _jax_bsdf_scene(case, w=W, spp=SPP):
    """``chip_smoke.bsdf_cbox_arrays``'s scene through the JAX package's
    API: ``_cbox_with`` (``tests/test_bsdf_render.py``) with the BSDF on
    the short block (mesh 1; ``_cbox_with`` itself indexes ``meshes[-2]``,
    the green wall, which its comment calls the short block), or, for the
    normal map, over a Microfacet on the UV-mapped tall block of
    ``textured_cbox_arrays``."""
    from test_torch_texture import _jax_textured_box

    if case == "normalmap":
        sc = _jax_textured_box(w, spp, (16, 8), sppe=0)
        nested = psdr.MicrofacetBSDF((0.1,) * 3, (0.4,) * 3, 0.3)
        sc.add_BSDF(psdr.NormalMapBSDF(bsdf_nmap(), nested), "nmap")
        sc.meshes[2].bsdf_id = len(sc.bsdfs) - 1
        return sc
    sc = make_cbox(width=w, height=w, spp=spp)
    block = sc.meshes[1]
    if case == "conductor":
        b = psdr.RoughConductorBSDF(alpha_u=0.2, alpha_v=0.08)
    elif case == "dielectric":
        b = psdr.RoughDielectricBSDF(alpha_u=0.2, int_ior=1.5)
    else:
        nv = block.num_vertices
        b = psdr.MicrofacetBSDFPerVertex(
            np.full((nv, 3), 0.05, np.float32),
            np.tile(np.linspace(0.1, 0.9, nv)[:, None], (1, 3)).astype(
                np.float32),
            np.full((nv,), 0.4, np.float32))
    sc.add_BSDF(b, "test_mat")
    block.bsdf_id = len(sc.bsdfs) - 1
    return sc


@pytest.mark.parametrize("case", BSDF_CASES)
def test_interop_round_trip(case):
    """Each new type carries across ``interop``: ``bsdf_cbox_arrays`` equals
    ``scene_to_arrays`` of the scene built through the JAX package's API
    key by key, and a port scene built from it writes the same arrays
    back."""
    jsc = _jax_bsdf_scene(case)
    want = pt.scene_to_arrays(jsc)
    got = bsdf_cbox_arrays(case, W, W, SPP, 0, 0, tex=(16, 8))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    back = pt.scene_to_arrays(pt.Scene.from_arrays(got, device=CPU))
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(back[k], v), k


def _jax_render(jsc, depth):
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        return np.asarray(psdr.PathTracer(depth).renderC(jsc, 0, seed=SEED))
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old


@pytest.mark.parametrize("case", BSDF_CASES)
def test_bsdf_scene_renderC_matches_jax(case):
    """renderC of each BSDF scene at 16x16, spp 4 (``PathTracer(4)`` for
    the dielectric, ``PathTracer(2)`` else), the port tracing the JAX
    package's camera rays: measured rel L1 conductor 2.8e-7, dielectric
    9.0e-6, per-vertex 2.2e-6, normal map 3.2e-7 (bound 2e-5; XLA
    contracts the jitted render's multiply-adds, and the dielectric's
    refractions at depth 4 carry the last bits furthest)."""
    from test_torch_texture import _jax_rays

    jsc = _jax_bsdf_scene(case)
    jsc.configure()
    sc = pt.Scene.from_arrays(bsdf_cbox_arrays(case, W, W, SPP, 0, 0,
                                               tex=(16, 8)), device=CPU)
    sc.configure()
    depth = BSDF_DEPTH[case]
    ref = _jax_render(jsc, depth)
    with _jax_rays(jsc):
        img = pt.PathTracer(depth).renderC(sc, 0, seed=SEED).numpy()
    assert np.isfinite(img).all() and float(np.abs(ref).sum()) > 0
    assert _rel(img, ref) < 2e-5


# the training step of the boxes whose rays leave the one-sided path: the
# dielectric's refracted lanes (wo.z < 0) and the normal map's nested
# evaluations, the interior term at spp 2 with bsdf_setup's parameters
# (the edge terms move with geometry alone; the room's step holds them); a
# pixel whose two renderD images differ by more than FLIP (L1 over the
# channels) holds a visibility test that an ulp flipped between the
# packages, and both sides leave it out of the loss
STEP_CASES, STEP_SPP, FLIP = ("dielectric", "normalmap"), 2, 1e-3


def _jax_bsdf_step(case, jsc, target, port_image):
    """The JAX package's renderD (the interior term: the scene has sppe
    and sppse 0) at ``bsdf_setup``'s parameters (the block's vertex
    offsets ``dv``, the light's ``radiance`` and the dielectric's
    ``alpha`` or the normal map's ``nmap``), the pixels to keep (those
    within ``FLIP`` of ``port_image``), and the loss ``sum(keep (renderD
    - target)^2)`` with its gradients by ``jax.vjp``, as numpy."""
    nm = case == "normalmap"
    mesh, em = jsc.meshes[2 if nm else 1], jsc.emitters[0]
    holder = jsc.bsdfs[6].nmap if nm else jsc.bsdfs[5].alpha_u
    name = "nmap" if nm else "alpha"
    base = mesh.vertex_positions_raw, em.radiance, holder.data
    integ = psdr.PathTracer(BSDF_DEPTH[case])
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"

    def render(p):
        mesh.vertex_positions_raw = base[0] + p["dv"]
        em.radiance = p["radiance"]
        holder.data = p[name]
        return integ.renderD(jsc, 0, seed=SEED)

    try:
        img, vjp = jax.vjp(render, {"dv": jnp.zeros_like(base[0]),
                                    "radiance": base[1], name: base[2]})
        img = np.asarray(img)
        keep = np.abs(port_image - img).sum(-1) <= FLIP
        resid = (img - target) * keep[:, None]
        (grads,) = vjp(jnp.asarray(2.0 * resid))
    finally:
        mesh.vertex_positions_raw, em.radiance, holder.data = base
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
    return (img, keep, float(np.square(resid.astype(np.float64)).sum()),
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.mark.parametrize("case", STEP_CASES)
def test_bsdf_scene_step_matches_jax(case):
    """One training step of the dielectric box (``PathTracer(4)``) and of
    the normal-map box (``PathTracer(2)``) at 16x16, spp 2, the interior
    term, with ``bsdf_setup``'s parameters, against ``jax.vjp`` of the JAX
    package's renderD, the port tracing the JAX package's camera rays.
    Pixels flipped by an ulp (``FLIP``) leave both losses: measured 3 of
    the dielectric's 256 and 2 of the normal map's (bound 6; grazing
    shadow rays, most after refraction at depth 4, whose hit points XLA's
    contracted multiply-adds move); the kept pixels' images differ by
    6.2e-7 and 1.0e-5 rel L1 (bound 1e-4). Measured rel loss 1.2e-7 and
    2.0e-6 (bound 1e-4); gradients (bound 1e-3): radiance 3.7e-8 and
    2.3e-6, vertex offsets 1.4e-5 and 6.1e-4 (the path-space Jacobians of
    refracted and perturbed lanes), the dielectric's alpha 1.1e-4, the
    normal map 5.4e-4. Every parameter gets a gradient."""
    from test_torch_texture import _jax_rays

    target = np.random.default_rng(SEED).random((W * W, 3)).astype(
        np.float32)
    jsc = _jax_bsdf_scene(case, spp=STEP_SPP)
    jsc.configure()
    sc = pt.Scene.from_arrays(bsdf_cbox_arrays(
        case, W, W, STEP_SPP, 0, 0, tex=(16, 8)), device=CPU)
    sc.configure()
    integ = pt.PathTracer(BSDF_DEPTH[case])
    with _jax_rays(jsc):
        image = integ.renderD(sc, 0, seed=SEED).detach().numpy()
        ref_img, keep, ref_loss, ref = _jax_bsdf_step(case, jsc, target,
                                                      image)
        params, apply_params = bsdf_setup(sc, case)
        tgt, w = torch.from_numpy(target), torch.from_numpy(keep)
        loss, grads, img_t = integ.loss_and_grad(
            sc, params, apply_params,
            lambda rows, pix: ((rows - tgt[pix]) ** 2).sum(-1) * w[pix],
            seed=SEED)
    rels = {k: _rel(grads[k].numpy(), v) for k, v in ref.items()}
    assert (~keep).sum() <= 6
    assert np.array_equal(img_t.numpy(), image)
    assert _rel(image[keep], ref_img[keep]) < 1e-4
    assert abs(float(loss) - ref_loss) / ref_loss < 1e-4
    for k, want in ref.items():
        assert grads[k].shape == want.shape, k
        assert np.abs(want).sum() > 0, k
        assert rels[k] < 1e-3, k


def test_unported_types_still_raise(tmp_path):
    """With every BSDF of the JAX package ported, a material of a type the
    port does not know still raises. An intrinsic camera now carries over
    through ``interop``, and a bitmap reads its image file (a missing one
    raises ``FileNotFoundError``)."""
    class Velvet(tdispatch.BSDF):
        pass

    with pytest.raises(NotImplementedError, match="Velvet"):
        tdispatch.material_table([Velvet()], CPU)
    jsc = make_cbox(width=8, height=8, spp=1)
    cam = psdr.PerspectiveCamera.from_intrinsic(
        500.0, 500.0, 4.0, 4.0, 1e-6, 1e7)
    cam.to_world = jsc.sensors[0].to_world
    jsc.add_Sensor(cam)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    assert sc.sensors[1].use_intrinsic and not sc.sensors[0].use_intrinsic
    assert (sc.sensors[1].fx, sc.sensors[1].cy) == (500.0, 4.0)
    with pytest.raises(FileNotFoundError):
        pt.Bitmap3f(str(tmp_path / "albedo.exr"))
    img = np.random.default_rng(2).random((3, 5, 3)).astype(np.float32)
    write_image(str(tmp_path / "albedo.exr"), img)
    np.testing.assert_array_equal(
        pt.Bitmap3f(str(tmp_path / "albedo.exr")).data.numpy(), img)
