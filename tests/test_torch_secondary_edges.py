"""The secondary-edge term of psdr_jit_tpu_torch (``sppse > 0``) against
the JAX package's, on the CPU: the Walker alias table and its sampler,
``HyperCubeDistribution``, ``sample_boundary_segment_direct``,
``eval_secondary_edge``, the guiding grid of
``preprocess_secondary_edges``, and the training step with the term, on the
Cornell box and on a perspective version of ``tests/test_grad_edges.py``'s
shadow scene, unguided and guided.

Both packages draw the same samples (``pcg4d``), so each comparison is
lane for lane. The JAX side runs with ``MEGA_MODE`` "off" and the exact
f32 edge adjoint (``SPLAT_TRANSPOSE = "rows"``).

Where the bits differ, and the bounds that follow (each with its measured
value in the test):

* the edge table's CDF: XLA's CPU cumsum associates its sums otherwise
  than torch's (which accumulates in float64 on the CPU), a few ulp at the
  table's end. The edge point moves by that much along its edge, and a
  segment that grazes the light's plane (``pdf ~ 1 / cos``) magnifies it.
  The sampling tests give the port the JAX package's table (through the
  scene compile's table cache, ``Scene._sec_edge_distrb_cache``) and hold
  the math to 1e-5; the steps use the port's own table;
* fused multiply-adds: XLA's CPU compiler contracts multiply-adds inside
  a jitted function (the camera transform, ``u * total - cdf[i-1]``), which
  flips the ``SHADOW_EPSILON`` tests of a few lanes in ten thousand
  (``tests/test_torch_fused.py``). The sampling tests call the JAX
  functions eagerly, which rounds every operation as the port does;
  the guiding grid and the steps run jitted.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import train_setup
from psdr_jit_tpu.core import distribution as jd
from psdr_jit_tpu.core import transform as jxf
from psdr_jit_tpu.integrator import edge as je
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.core import distribution as td
from psdr_jit_tpu_torch.core.sampler import Sampler
from psdr_jit_tpu_torch.integrator import base as tbase
from psdr_jit_tpu_torch.integrator import edge as te
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

W, SPP, SPPE, SPPSE, DEPTH, SEED = 16, 4, 4, 4, 2, 3
TARGET = np.random.default_rng(0).random((W * W, 3)).astype(np.float32)
N_LANES = 1 << 14


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_modes(fn):
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        return fn()
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old


def _jax_table(jdist):
    """The JAX package's DiscreteDistribution as the port's."""
    rows = jdist.alias_rows
    return td.DiscreteDistribution(
        pmf=_t(jdist.pmf), cdf=_t(jdist.cdf),
        alias_rows=None if rows is None else _t(rows))


# ---------------------------------------------------------------------------
# alias tables and the guiding grid's distribution
# ---------------------------------------------------------------------------

def _masses(kind):
    rng = np.random.default_rng(5)
    if kind == "zeros":
        return np.zeros(3000, np.float32)
    m = rng.random(5000).astype(np.float32)
    if kind == "sparse":
        m[rng.random(5000) < 0.7] = 0.0
    elif kind == "peaked":
        m = m ** 8
        m[17] = 1e4
    return m


@pytest.mark.parametrize("kind", ["dense", "sparse", "peaked", "zeros"])
def test_alias_rows_bitwise(kind):
    """The host build of the Walker alias rows is the JAX package's bit
    for bit, the degenerate all-zero table included."""
    m = _masses(kind)
    ref = np.asarray(jd._build_alias_rows(m))
    got = td.build_alias_rows(m).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("coin", [True, False])
def test_sample_alias_matches_jax(coin):
    """``_sample_alias`` and ``sample_reuse`` through the alias rows, with
    and without the coin: indices and pmf bit for bit, ``u'`` to 1e-6
    (measured 0: the same f32 operations)."""
    m = _masses("sparse")
    jdist = jd.DiscreteDistribution.init(m).with_alias()
    dist = _jax_table(jdist)
    assert dist.needs_coin and jdist.needs_coin
    s = Sampler(11, torch.arange(N_LANES))
    u, c = s.next_1d(), s.next_1d()
    jc = jnp.asarray(c.numpy()) if coin else None
    j_idx, j_p, j_u = jdist._sample_alias(jnp.asarray(u.numpy()), jc)
    idx, p, u_new = dist._sample_alias(u, c if coin else None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_p))
    np.testing.assert_allclose(u_new.numpy(), np.asarray(j_u), rtol=0,
                               atol=1e-6)
    j_idx, j_pdf, _ = jdist.sample_reuse(jnp.asarray(u.numpy()), jc)
    idx, pdf, _ = dist.sample_reuse(u, c if coin else None)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(j_pdf), rtol=1e-6)


@pytest.mark.parametrize("res", [(4, 4, 4), (16, 16, 16)])
def test_hypercube_matches_jax(res):
    """``HyperCubeDistribution`` over the same masses (a dense CDF at 64
    cells, alias rows at 4,096). Each package's own build: alias rows bit
    for bit, CDFs within 1e-6 relative (their sums associate differently).
    On the JAX package's table: cell coordinates and the cells
    ``sample_reuse`` picks equal, warped samples and ``pdf`` within 1e-6
    relative (measured 0). (On its own CDF the reused in-cell coordinate
    ``(u total - cdf[i-1]) / pmf[i]`` magnifies the CDFs' last bits by
    ``total / pmf[i]``: measured 9e-4 of a unit at 64 cells.)"""
    n = res[0] * res[1] * res[2]
    mass = np.random.default_rng(2).random(n).astype(np.float32) ** 4
    jh = jd.HyperCubeDistribution.init(res, mass).with_alias()
    own = td.HyperCubeDistribution.init(res, mass).with_alias()
    assert own.needs_coin == jh.needs_coin == (n > td.SEARCHSORTED_DENSE_MAX)
    np.testing.assert_allclose(own.distrb.cdf.numpy(),
                               np.asarray(jh.distrb.cdf), rtol=1e-6)
    if own.needs_coin:
        np.testing.assert_array_equal(own.distrb.alias_rows.numpy(),
                                      np.asarray(jh.distrb.alias_rows))
    th = td.HyperCubeDistribution(res=res, distrb=_jax_table(jh.distrb))
    cells = torch.arange(n)
    np.testing.assert_array_equal(
        th.cell_coords(cells).numpy(),
        np.asarray(jh.cell_coords(jnp.arange(n))))
    s = Sampler(4, torch.arange(N_LANES))
    u3 = s.next_nd(3)
    coin = s.next_1d() if th.needs_coin else None
    jw, jpdf = jh.sample_reuse(jnp.asarray(u3.numpy()), None if coin is None
                               else jnp.asarray(coin.numpy()))
    w, pdf = th.sample_reuse(u3, coin)
    np.testing.assert_array_equal(
        torch.floor(w * torch.tensor(res, dtype=torch.float32)).numpy(),
        np.floor(np.asarray(jw) * np.asarray(res, np.float32)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    np.testing.assert_allclose(th.pdf(w).numpy(),
                               np.asarray(jh.pdf(jnp.asarray(w.numpy()))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# boundary segments, the guiding integrand and the guiding grid (cbox)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cbox():
    """``(jax scene data, port scene, port scene data with the JAX
    package's edge table)`` of the 16x16 box with sppse 4."""
    jsc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=SPPSE)
    jsc.configure()
    jsd = jax.lax.stop_gradient(jsc.data)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    own = sc.configure()
    sc._sec_edge_distrb_cache = _jax_table(jsd.sec_edge_distrb)
    shared = sc.configure_data()
    return jsd, sc, own, shared


@pytest.fixture(scope="module")
def samples3():
    s = Sampler(7, torch.arange(N_LANES))
    return s.next_nd(3)


def test_edge_table_matches_jax(cbox, samples3):
    """The global edge table (mesh order) equals the JAX package's up to
    the last bit of a face normal; the length CDFs differ in the last bits
    only (measured 1.7e-7 relative), and the edges the port's own table
    picks for 16,384 draws equal the JAX package's."""
    jsd, _, own, _ = cbox
    for f in ("p0", "e1", "n0", "n1", "p2"):
        np.testing.assert_allclose(
            getattr(own.sec_edge, f).detach().numpy(),
            np.asarray(getattr(jsd.sec_edge, f)), rtol=0, atol=1e-6,
            err_msg=f)
    np.testing.assert_array_equal(own.sec_edge.is_boundary.numpy(),
                                  np.asarray(jsd.sec_edge.is_boundary))
    np.testing.assert_allclose(own.sec_edge_distrb.cdf.numpy(),
                               np.asarray(jsd.sec_edge_distrb.cdf),
                               rtol=1e-6)
    u = samples3[:, 0]
    j_idx, _, _ = jsd.sec_edge_distrb.sample_reuse(jnp.asarray(u.numpy()))
    idx, _, _ = own.sec_edge_distrb.sample_reuse(u)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


def test_boundary_segment_matches_jax(cbox, samples3):
    """``sample_boundary_segment_direct`` on the box, on the JAX package's
    edge table: ``is_valid`` equal on every lane (bound 99.9%), ``p0``,
    ``p2`` and ``pdf`` within 1e-5 relative on the lanes both take
    (measured 0: the same IEEE-rounded operations)."""
    jsd, _, _, sd = cbox
    jb = jsd.sample_boundary_segment_direct(jnp.asarray(samples3.numpy()))
    tb = sd.sample_boundary_segment_direct(samples3)
    jv, tv = np.asarray(jb.is_valid), tb.is_valid.numpy()
    assert (jv == tv).mean() >= 0.999
    assert 0.3 < tv.mean() < 0.9
    ok = jv & tv
    for f in ("p0", "p2", "pdf", "edge", "edge2", "n"):
        ref = np.asarray(getattr(jb, f))[ok]
        got = getattr(tb, f).detach().numpy()[ok]
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-5 * scale, f
    assert tb.p0.requires_grad is False  # no parameter carries a gradient


def test_eval_secondary_edge_guiding_values(cbox, samples3):
    """``eval_secondary_edge(diff=False)``, the guiding integrand, on
    16,384 lanes on the JAX package's edge table: the lanes with a value
    agree on all but one in a thousand (measured 1 of 1,295: a camera-ray
    SHADOW_EPSILON test), their values within 1e-5 relative (measured
    9.4e-7), the whole within 1e-3 rel L1 (measured 3.8e-4, the flipped
    lane)."""
    jsd, _, _, sd = cbox
    _, jval = je.eval_secondary_edge(jsd, jsd.sensors[0],
                                     jnp.asarray(samples3.numpy()),
                                     diff=False)
    idx, val = te.eval_secondary_edge(sd, sd.sensors[0], samples3,
                                      diff=False)
    jval, val = np.asarray(jval), val.numpy()
    assert (idx == -1).all() and np.isfinite(val).all()
    jn, tn = (jval != 0).any(-1), (val != 0).any(-1)
    assert jn.sum() > 500
    assert (jn != tn).sum() <= max(1, jn.sum() // 1000)
    both = jn & tn
    rel = np.abs(val - jval)[both].max(-1) / np.abs(jval[both]).max(-1)
    assert rel.max() < 1e-5
    assert _rel(val, jval) < 1e-3


def test_guiding_grid_matches_jax(cbox):
    """``preprocess_secondary_edges(scene, 0, [4, 4, 4, 2], 2)`` on the
    JAX package's edge table: the cell masses within 1e-4 rel L1 (measured
    1.4e-6; the JAX round runs jitted)."""
    jsd, sc, _, sd = cbox
    reso = [4, 4, 4, 2]
    jint = psdr.PathTracer(DEPTH)

    class _Scene:  # the JAX integrator reads scene.data only
        data = jsd

    jint.preprocess_secondary_edges(_Scene, 0, reso, 2)
    sc._data = sd
    integ = pt.PathTracer(DEPTH)
    integ.preprocess_secondary_edges(sc, 0, reso, 2)
    jw, tw = jint.warpper[0], integ.warpper[0]
    assert tw.res == tuple(reso[:3]) and not tw.needs_coin
    jm, tm = np.asarray(jw.distrb.pmf), tw.distrb.pmf.numpy()
    assert (jm > 0).sum() > 4
    assert _rel(tm, jm) < 1e-4


# ---------------------------------------------------------------------------
# the training step with the secondary-edge term
# ---------------------------------------------------------------------------

def _cbox_jax_step(sppse):
    """The JAX package's step on the box, with ``test_torch_fused.py``'s
    four parameters."""
    sc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE, sppse=sppse)
    sc.configure()
    m0, m2 = sc.meshes[0], sc.meshes[2]
    base0 = jnp.asarray(m0.to_world_raw)
    verts = jnp.asarray(m2.vertex_positions_raw)
    tgt = jnp.asarray(TARGET)

    def apply(p):
        m0.to_world_raw = base0.at[0, 3].add(p["tx"])
        m2.vertex_positions_raw = verts + p["dv"]
        sc.bsdfs[1].reflectance.data = jnp.broadcast_to(
            p["alb"], jnp.shape(sc.bsdfs[1].reflectance.data))
        sc.emitters[0].radiance = p["rad"]

    p0 = {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(verts),
          "alb": jnp.asarray(sc.bsdfs[1].reflectance.data).reshape(-1)[:3],
          "rad": jnp.asarray(sc.emitters[0].radiance)}
    loss, g, img = _jax_modes(lambda: psdr.PathTracer(DEPTH).loss_and_grad(
        sc, p0, apply,
        lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
        seed=SEED))
    return (float(loss), {k: np.asarray(v) for k, v in g.items()},
            np.asarray(img), {k: np.asarray(v) for k, v in p0.items()})


def _cbox_port_step(np_params, sppse=SPPSE, **kw):
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(make_cbox(
        width=W, height=W, spp=SPP, sppe=SPPE, sppse=sppse)), device=CPU)
    _, apply, loss_fn = train_setup(sc, seed=0)
    loss, g, img = pt.PathTracer(DEPTH).loss_and_grad(
        sc, pt.params_to_torch(np_params, device=CPU), apply, loss_fn,
        seed=SEED, **kw)
    return float(loss), {k: v.numpy() for k, v in g.items()}, img.numpy()


@pytest.fixture(scope="module")
def cbox_step():
    return _cbox_jax_step(SPPSE)


STEP_RTOL = {"tx": 1e-2, "dv": 0.15, "alb": 1e-2, "rad": 1e-2}


def test_loss_and_grad_matches_jax(cbox_step):
    """The three-estimator step on the box (16x16, spp 4, sppe 4, sppse 4,
    depth 2) against the JAX package's: loss within 2e-4 (measured
    2.6e-5), image 1e-3 (3.9e-4), the translation, reflectance and
    radiance gradients 1e-2 (1.6e-5, 2.4e-3, 8.8e-6), the block's vertex
    offsets 0.15 (7.9e-2). The secondary-edge term moves the offsets by
    22% (against the step with sppse 0). Its lanes are heavy-tailed, and
    the few that graze a face decide the offsets' last percents: at sppse
    16 the port's closest hit (K1's FMA hit test) and the JAX package's
    (no FMAs) disagree on 2 of 372 valid lanes, and the JAX package's own
    jitted and eager pullbacks of the same lanes differ by 7-35% a
    triangle table (measured); the shadow scene below, which has no
    grazing edge, holds the term's derivative to 1e-5 both on boundary
    edges (the quad) and on silhouettes between two faces (the box)."""
    j_loss, j_grads, j_img, p0 = cbox_step
    loss, grads, img = _cbox_port_step(p0)
    assert abs(loss - j_loss) <= 2e-4 * abs(j_loss)
    assert img.shape == (W * W, 3) and np.isfinite(img).all()
    assert _rel(img, j_img) < 1e-3
    assert set(grads) == set(j_grads)
    for k, ref in j_grads.items():
        got = grads[k]
        assert got.shape == ref.shape and np.isfinite(got).all(), k
        assert np.abs(got).sum() > 0, k
        assert _rel(got, ref) < STEP_RTOL[k], (k, _rel(got, ref))
    _, g0, _ = _cbox_port_step(p0, sppse=0)
    assert _rel(grads["dv"], g0["dv"]) > 0.05
    for k in ("alb", "rad"):  # the term carries no material gradient
        np.testing.assert_array_equal(grads[k], g0[k])


def test_se_chunk_size_invariance(monkeypatch):
    """The step does not depend on how its secondary-edge pass is
    chunked: loss and image bit for bit, gradients up to the order of
    their sums."""
    p0 = {"tx": np.float32(0.0),
          "dv": np.zeros((20, 3), np.float32),
          "alb": np.float32([0.7, 0.7, 0.7]),
          "rad": np.float32([20.0, 20.0, 8.0])}
    ref = _cbox_port_step(p0)
    monkeypatch.setattr(tbase, "SE_CHUNK_LANES", 300)
    out = _cbox_port_step(p0)
    assert out[0] == ref[0]
    np.testing.assert_array_equal(out[2], ref[2])
    for k in ref[1]:
        np.testing.assert_allclose(out[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6 * np.abs(ref[1][k]).max(),
                                   err_msg=k)


def _quad(v, flip=False, edges=True):
    """``test_grad_edges.py``'s planar quad with face normals."""
    m = psdr.Mesh()
    m.use_face_normals = True
    m.enable_edges = edges
    m.load_raw(np.asarray(v, np.float32),
               np.asarray([[0, 2, 1], [0, 3, 2]] if flip
                          else [[0, 1, 2], [0, 2, 3]], np.int32))
    return m


def _box(lo, hi):
    """A closed box with face normals, each face wound outward, so that
    its edges are shared by two faces (none is a boundary edge)."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    v = np.asarray([[(hi if i & 1 else lo)[0], (hi if i & 2 else lo)[1],
                     (hi if i & 4 else lo)[2]] for i in range(8)], np.float32)
    quads = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 3, 7, 5)]
    faces = []
    for a, b, c, d in quads:
        for tri in ((a, b, c), (a, c, d)):
            n = np.cross(v[tri[1]] - v[tri[0]], v[tri[2]] - v[tri[0]])
            out = v[list(tri)].mean(0) - (lo + hi) / 2
            faces.append(tri if n @ out > 0 else tri[::-1])
    m = psdr.Mesh()
    m.use_face_normals = True
    m.enable_edges = True
    m.load_raw(v, np.asarray(faces, np.int32))
    return m


SHADOW_W = 16


def _shadow_scene(sppse, occluder="quad"):
    """``tests/test_grad_edges.py``'s shadow scene seen through a
    perspective camera: a receiver plane at z = 0, a small light at z = 4
    facing down, an occluder at z = 2 over x in [-1, 1], and a camera at
    (2.5, 0, 10) looking down on x in [1.5, 3.5] (the occluder's edge
    x = 1 and the light stay out of view). The occluder is the quad of
    ``test_grad_edges.py``, whose edges are all boundary edges, or a
    closed box over z in [1.8, 2.2], whose shadow edge in view is cast by
    its top edge at x = 1: an edge between two faces, a silhouette seen
    from the light (the top face turned to it, the side face x = 1 turned
    away). Only the occluder's edges are enabled, so with spp 0 and sppe 0
    every gradient of the occluder comes from the secondary-edge term."""
    sc = psdr.Scene()
    sc.opts.width = sc.opts.height = SHADOW_W
    sc.opts.spp, sc.opts.sppe, sc.opts.sppse = 0, 0, sppse
    cam = psdr.PerspectiveCamera(11.4, 0.1, 100.0)
    cam.to_world = np.asarray(jxf.look_at([2.5, 0.0, 10.0], [2.5, 0.0, 0.0],
                                          [0.0, 1.0, 0.0]), np.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.DiffuseBSDF([0.8, 0.8, 0.8]), "rho")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    sc.add_Mesh(_quad([[-10, -10, 0], [10, -10, 0], [10, 10, 0],
                       [-10, 10, 0]], edges=False), None, "rho")
    hl = 0.05
    sc.add_Mesh(_quad([[-hl, -hl, 4], [hl, -hl, 4], [hl, hl, 4],
                       [-hl, hl, 4]], flip=True, edges=False), None, "black",
                psdr.AreaLight([200.0, 200.0, 200.0]))
    sc.add_Mesh(_quad([[-1, -3, 2], [1, -3, 2], [1, 3, 2], [-1, 3, 2]])
                if occluder == "quad" else _box([-1, -3, 1.8], [1, 3, 2.2]),
                None, "black")
    return sc


SHADOW_TARGET = np.random.default_rng(1).random(
    (SHADOW_W * SHADOW_W, 3)).astype(np.float32)


def _shadow_jax_step(sppse, warp_reso=None, occluder="quad"):
    """The JAX package's step on the shadow scene with the occluder's
    translation along x (``tx``) and the light's radiance (``rad``) as the
    parameters; with ``warp_reso`` guided by a table it builds first.
    Returns ``(loss, grads, image, params, table)``."""
    sc = _shadow_scene(sppse, occluder)
    sc.configure()
    occ = sc.meshes[2]
    base = jnp.asarray(occ.to_world_raw)
    tgt = jnp.asarray(SHADOW_TARGET)

    def apply(p):
        occ.to_world_raw = base.at[0, 3].add(p["tx"])
        sc.emitters[0].radiance = p["rad"]

    p0 = {"tx": jnp.float32(0.0), "rad": jnp.asarray(sc.emitters[0].radiance)}
    integ = psdr.PathTracer(1)
    table = None
    if warp_reso is not None:
        integ.preprocess_secondary_edges(sc, 0, warp_reso, 1)
        table = integ.warpper[0]
    loss, g, img = _jax_modes(lambda: integ.loss_and_grad(
        sc, p0, apply,
        lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
        seed=SEED))
    return (float(loss), {k: np.asarray(v) for k, v in g.items()},
            np.asarray(img), {k: np.asarray(v) for k, v in p0.items()}, table)


def _shadow_port_step(np_params, sppse, held=None, occluder="quad", **kw):
    """The port's step; ``held`` is a guiding table the integrator holds
    (``warpper[0]``) before the call."""
    jsc = _shadow_scene(sppse, occluder)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    occ = sc.meshes[2]
    base = occ.to_world_raw.clone()
    tgt = torch.from_numpy(SHADOW_TARGET)

    def apply(p):
        occ.to_world_raw = base + torch.nn.functional.pad(
            p["tx"].reshape(1, 1), (3, 0, 0, 3))
        sc.emitters[0].radiance = p["rad"]

    integ = pt.PathTracer(1)
    if held is not None:
        integ.warpper[0] = held
    loss, g, img = integ.loss_and_grad(
        sc, pt.params_to_torch(np_params, device=CPU), apply,
        lambda rows, pix: ((rows - tgt[pix]) ** 2).sum(-1), seed=SEED, **kw)
    return float(loss), {k: v.numpy() for k, v in g.items()}, img.numpy()


@pytest.fixture(scope="module", params=["quad", "box"])
def shadow_step(request):
    return request.param, _shadow_jax_step(16, occluder=request.param)


def test_se_only_step_matches_jax(shadow_step):
    """spp 0, sppe 0, sppse 16 on the shadow scene: the image is zero, the
    light's radiance gets no gradient (the term's value is detached), and
    the occluder's translation gets its gradient from the secondary-edge
    term alone, within 1e-5 of the JAX package's (measured 3.1e-7 with the
    quad, whose edges are boundary edges, and 1.3e-7 with the box,
    whose shadow edge is a silhouette between two faces). With sppse 0 the
    same step gives exactly 0."""
    occluder, (j_loss, j_g, j_img, p0, _) = shadow_step
    if occluder == "box":  # every lane takes the silhouette test
        sd = pt.Scene.from_arrays(pt.scene_to_arrays(
            _shadow_scene(16, occluder)), device=CPU).configure()
        assert not sd.sec_edge.is_boundary.any()
    loss, g, img = _shadow_port_step(p0, 16, occluder=occluder)
    assert not img.any() and not j_img.any()
    assert abs(loss - j_loss) <= 1e-6 * abs(j_loss)
    assert not g["rad"].any() and not j_g["rad"].any()
    assert abs(float(j_g["tx"])) > 1.0
    assert _rel(g["tx"], j_g["tx"]) < 1e-5
    _, g0, _ = _shadow_port_step(p0, 0, occluder=occluder)
    assert float(g0["tx"]) == 0.0


def test_guided_step_matches_jax():
    """The same step guided by one table: the JAX package's
    ``preprocess_secondary_edges(..., [16, 16, 16, 1], 1)`` (4,096 cells,
    so alias rows and their coin) handed to the port as ``warp=``: the
    translation gradient within 1e-5 of the JAX package's guided step
    (measured 1.2e-6). Left unset, ``warp`` is the table the integrator
    holds; ``warp=None`` samples unguided whatever it holds: the unguided
    step's gradient bit for bit."""
    j_loss, j_g, _, p0, table = _shadow_jax_step(16, [16, 16, 16, 1])
    assert table.needs_coin
    warp = td.HyperCubeDistribution(res=table.res,
                                    distrb=_jax_table(table.distrb))
    _, g, _ = _shadow_port_step(p0, 16, warp=warp)
    assert _rel(g["tx"], j_g["tx"]) < 1e-5
    _, g_held, _ = _shadow_port_step(p0, 16, held=warp)
    assert float(g_held["tx"]) == float(g["tx"])
    _, g_un, _ = _shadow_port_step(p0, 16, held=warp, warp=None)
    _, g_ref, _ = _shadow_port_step(p0, 16)
    assert float(g_un["tx"]) == float(g_ref["tx"]) != float(g["tx"])
