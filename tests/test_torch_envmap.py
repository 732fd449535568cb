"""Environment maps, bitmaps and the Microfacet BSDF of psdr_jit_tpu_torch
against the JAX package's, on the CPU: function by function on seeded
inputs, the closed forms of ``tests/test_envmap.py`` through the port, and
the slice, BASELINE config #3's scene on the stand-in assets of
``chip_smoke.envmap_standin`` (a subdivision-2 mesh and a 32x64 map, whose
7,812-cell importance table samples by alias rows with a coin) at 16x16,
spp 4, sppe 4, sppse 4, ``PathTracer(1)``: renderC, the forward-mode
renderD tangent along the mesh's x translation, and the training step
unguided and guided, with gradients to the vertex offsets and the radiance
texture.

Both packages draw the same samples (``pcg4d``), so each comparison is
lane for lane. ``atan2``, ``acos``, ``sin``, ``cos`` and ``exp2`` differ
in their last bits between XLA's and torch's CPU backends, and so do the
two builds of the importance table (up to 7.6e-6 in a mass of up to 123
here) and hence its alias rows: the tests hand the port the JAX package's table
(``interop.scene_to_arrays(..., cell_table=True)``), with which the alias
draws are bitwise. Each bound is stated beside its measured value. The
JAX side runs with ``MEGA_MODE`` "off" and the exact f32 edge adjoint
(``SPLAT_TRANSPOSE = "rows"``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import envmap_arrays, envmap_standin, forward_mode
from psdr_jit_tpu.core import bitmap as jbitmap
from psdr_jit_tpu.core import math as jmath
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu.bsdf.ggx import GGXDistribution as JGGX
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.bsdf import microfacet as tmf
from psdr_jit_tpu_torch.bsdf.ggx import GGXDistribution
from psdr_jit_tpu_torch.core import bitmap as tbitmap
from psdr_jit_tpu_torch.core import distribution as td
from psdr_jit_tpu_torch.core import transform as txf
from psdr_jit_tpu_torch.core.math import ray_intersect_scene_aabb
from psdr_jit_tpu_torch.core.sampler import Sampler
from psdr_jit_tpu_torch.core.types import Ray
from psdr_jit_tpu_torch.utils.image import write_image
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

W, SPP, SUBDIV, MAP_HW, SEED = 16, 4, 2, (32, 64), 3
N = 4096
TARGET = np.random.default_rng(0).random((W * W, 3)).astype(np.float32)
MESH_TO_WORLD = np.asarray([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                            [0, 0, 1.0, -100.0], [0, 0, 0, 1.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_modes(fn):
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        return fn()
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old


def _unit(rng, n, upper=False):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return v.astype(np.float32)


# ---------------------------------------------------------------------------
# bitmaps, GGX, Microfacet, the scene box
# ---------------------------------------------------------------------------

BITMAP_CASES = {  # (H, W, UV transform (scale, rot, trans), flip_v, envmap)
    "constant": ((1, 1), (1.0, 0.0, (0.0, 0.0)), True, False),
    "wrap": ((5, 7), (1.3, 0.4, (0.1, -0.2)), True, False),
    "envmap": ((6, 9), (1.0, 0.0, (0.0, 0.0)), False, True),
}


@pytest.mark.parametrize("case", sorted(BITMAP_CASES))
def test_bitmap_eval_matches_jax(case):
    """The lookup and its gradients to the texture and to ``uv`` against
    ``core/bitmap.py _eval_bitmap``, at 4,096 seeded points (uv in [-0.3,
    1.3]^2, so wrapping is exercised). Measured rel L1 at most: values
    1.1e-7, gradients to the texture 6.0e-8, to uv 1.8e-7 (bound 1e-5
    each)."""
    (h, w), (scale, rot, trans), flip, env = BITMAP_CASES[case]
    rng = np.random.default_rng(11)
    data = rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (N, 2)).astype(np.float32)
    wgt = rng.uniform(0.5, 1.5, (N, 3)).astype(np.float32)

    def jf(d, u):
        out = jbitmap._eval_bitmap(d, jnp.float32(scale), jnp.float32(rot),
                                   jnp.asarray(trans, jnp.float32), u, flip,
                                   env)
        return jnp.sum(out * wgt), out

    (_, jout), (jgd, jgu) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        jnp.asarray(data), jnp.asarray(uv))
    d_t, uv_t = _t(data).requires_grad_(), _t(uv).requires_grad_()
    bm = tbitmap.Bitmap(d_t, scale, rot, trans)
    out = bm.eval(uv_t, flip_v=flip, envmap_mode=env)
    gd, gu = torch.autograd.grad((out * _t(wgt)).sum(), (d_t, uv_t),
                                 allow_unused=True)
    assert out.shape == (N, 3)
    assert _rel(out.detach().numpy(), jout) < 1e-5
    assert _rel(gd.numpy(), jgd) < 1e-5
    if case == "constant":
        assert gu is None and not np.asarray(jgu).any()
    else:
        assert _rel(gu.numpy(), jgu) < 1e-5


def test_ggx_matches_jax():
    """``GGXDistribution`` eval, smith_g1, the visible-normal sample and its
    pdf on 4,096 seeded directions with per-lane alpha, against
    ``bsdf/ggx.py``. Measured rel L1: D and G1 bitwise, m 8.8e-8, pdf
    3.8e-7 (bound 1e-5)."""
    rng = np.random.default_rng(12)
    wi, m = _unit(rng, N, True), _unit(rng, N, True)
    alpha = rng.uniform(0.05, 0.8, N).astype(np.float32)
    s3 = rng.random((N, 3)).astype(np.float32)
    jd, td_ = JGGX(jnp.asarray(alpha)), GGXDistribution(_t(alpha))
    assert _rel(td_.eval(_t(m)).numpy(), jd.eval(jnp.asarray(m))) < 1e-5
    assert _rel(td_.smith_g1(_t(wi), _t(m)).numpy(),
                jd.smith_g1(jnp.asarray(wi), jnp.asarray(m))) < 1e-5
    jm, jpdf = jd.sample(jnp.asarray(wi), jnp.asarray(s3))
    tm, tpdf = td_.sample(_t(wi), _t(s3))
    assert _rel(tm.numpy(), jm) < 1e-5
    assert _rel(tpdf.numpy(), jpdf) < 1e-5
    assert bool(torch.isfinite(tpdf).all()) and float(tpdf.min()) >= 0.0


@pytest.mark.parametrize("two_side", [False, True])
def test_microfacet_matches_jax(two_side):
    """``MicrofacetBSDF`` eval (and its gradient to ``wo``), sample and pdf
    on 4,096 seeded direction pairs over the whole sphere, one- and
    two-sided, against ``bsdf/microfacet.py``. Measured rel L1 at most:
    eval 1.1e-7, its gradient 2.0e-7, sampled wo 1.8e-7, sampled pdf
    4.5e-7, pdf 1.6e-7 (bound 1e-5); the sampled lanes' validity is
    equal."""
    rng = np.random.default_rng(13 + two_side)
    wi, wo = _unit(rng, N), _unit(rng, N)
    rnd3 = rng.random((N, 3)).astype(np.float32)
    spec, diff, rough = (0.2, 0.9, 0.9), (0.3, 0.2, 0.1), 0.3
    jb = psdr.MicrofacetBSDF(spec, diff, rough, twoSide=two_side)
    its = types.SimpleNamespace(wi=jnp.asarray(wi),
                                uv=jnp.zeros((N, 2), jnp.float32))
    act = jnp.ones(N, bool)

    def jeval(o):
        return jb.eval(its, o, act)

    jval, jvjp = jax.vjp(jeval, jnp.asarray(wo))
    (jgrad,) = jvjp(jnp.ones((N, 3), jnp.float32))
    jbs = jb.sample(its, jnp.asarray(rnd3), act)
    jpdf = jb.pdf(its, jnp.asarray(wo), act)

    lanes = torch.ones(N, dtype=torch.bool)
    two = torch.full((N,), two_side)
    sp = _t(np.tile(np.float32(spec), (N, 1)))
    df = _t(np.tile(np.float32(diff), (N, 1)))
    rg = torch.full((N,), rough)
    wo_t = _t(wo).requires_grad_()
    val = tmf.microfacet_eval(sp, df, rg, two, _t(wi), wo_t, lanes)
    (grad,) = torch.autograd.grad(val.sum(), wo_t)
    bs = tmf.microfacet_sample(rg, two, _t(wi), _t(rnd3), lanes)
    pdf = tmf.microfacet_pdf(rg, two, _t(wi), _t(wo), lanes)
    assert float(np.abs(np.asarray(jval)).sum()) > 0
    assert _rel(val.detach().numpy(), jval) < 1e-5
    assert _rel(grad.numpy(), jgrad) < 1e-5
    np.testing.assert_array_equal(bs.is_valid.numpy(),
                                  np.asarray(jbs.is_valid))
    ok = bs.is_valid.numpy()
    assert ok.mean() > 0.3
    assert _rel(bs.wo.numpy()[ok], np.asarray(jbs.wo)[ok]) < 1e-5
    assert _rel(bs.pdf.numpy()[ok], np.asarray(jbs.pdf)[ok]) < 1e-5
    assert _rel(pdf.numpy(), jpdf) < 1e-5


def test_scene_aabb_matches_jax():
    """``ray_intersect_scene_aabb`` from inside a box, with a third of the
    rays' direction components set to exactly 0: the exit distance,
    face normal and geometry factor equal the JAX package's (rel 1e-6),
    and a zero component never makes the exit distance 0."""
    rng = np.random.default_rng(14)
    lo, hi = np.float32([-3, -1, -2]), np.float32([4, 2, 5])
    o = rng.uniform(lo + 0.1, hi - 0.1, (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    d[rng.random((N, 3)) < 0.33] = 0.0
    d[np.all(d == 0.0, axis=1), 0] = 1.0
    jt, jn, jg = jmath.ray_intersect_scene_aabb(
        JRay(jnp.asarray(o), jnp.asarray(d)), jnp.asarray(lo),
        jnp.asarray(hi))
    t, n, g = ray_intersect_scene_aabb(Ray(_t(o), _t(d)), _t(lo), _t(hi))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)
    assert float(t.min()) > 0.0 and bool(torch.isfinite(t).all())


# ---------------------------------------------------------------------------
# the stand-in scene: JAX scene, port scene, the environment map's functions
# ---------------------------------------------------------------------------

def _jax_standin(w=W, spp=SPP, sppe=SPP, sppse=SPP):
    """BASELINE config #3's scene on the stand-in assets, built through the
    JAX package's API as ``tests/scenes.py make_bunny_envmap`` builds it."""
    verts, faces, tex = envmap_standin(SUBDIV, MAP_HW, 0)
    sc = psdr.Scene()
    sc.opts = psdr.RenderOption(w, w, spp, sppe, sppse)
    cam = psdr.PerspectiveCamera(80, 0.000001, 10000000.0)
    cam.to_world = jnp.asarray(np.diag([-1.0, 1.0, -1.0, 1.0]), jnp.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(psdr.MicrofacetBSDF([0.2, 0.9, 0.9], [0.01] * 3, 0.3),
                "bunny")
    mesh = psdr.Mesh()
    mesh.load_raw(verts, faces)
    sc.add_Mesh(mesh, MESH_TO_WORLD, "bunny", None)
    sc.add_EnvironmentMap(psdr.EnvironmentMap(tex))
    return sc


def _port_scene(jsc):
    """``(port scene on the CPU with the JAX package's importance table,
    its own table)``."""
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc, cell_table=True),
                              device=CPU)
    env = sc.emitter_env
    table = env._cell_distrb_cache
    sc.configure()
    own = env._cell_distrb_cache
    env._cell_distrb_cache = table
    sc._data = sc.configure_data()
    return sc, own


@pytest.fixture(scope="module")
def standin():
    """``(jax scene, its data, port scene, the port's own table)``."""
    jsc = _jax_standin()
    jsc.configure()
    sc, own = _port_scene(jsc)
    return jsc, jax.lax.stop_gradient(jsc.data), sc, own


def test_standin_arrays_match_jax_api(standin):
    """``chip_smoke.envmap_arrays`` (numpy, for the card's machine) is bit
    for bit what ``interop.scene_to_arrays`` makes of the scene built
    through the JAX package's API."""
    jsc = standin[0]
    ref = pt.scene_to_arrays(jsc)
    got = envmap_arrays(W, W, SPP, SPP, SPP, SUBDIV, MAP_HW, 0)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


def test_scene_compile_matches_jax(standin):
    """The round trip ``scene_from_arrays(scene_to_arrays(jax scene))``
    compiles to the JAX package's scene data: the triangle tables with the
    bounding mesh at the tail of the Morton order, the dispatch slots, the
    sky box, the emitter's weight and bounding-mesh index; the port's own
    importance table has the JAX package's masses to 6.2e-8 of the
    largest (bound 1e-5; ``sin`` and the lookups round differently) and
    alias rows above 2,048 cells, so its sampling takes the coin."""
    _, jsd, sc, own = standin
    td_ = sc.data
    assert td_.tri.p0.shape[0] == 20 * 4 ** SUBDIV + 12
    for f in ("p0", "e1", "e2", "n0", "face_normal", "face_area"):
        np.testing.assert_allclose(getattr(td_.tri, f).numpy(),
                                   np.asarray(getattr(jsd.tri, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    for name in ("face_normal_mask", "face_mesh_id", "mesh_bsdf_slot",
                 "mesh_emitter_slot"):
        np.testing.assert_array_equal(getattr(td_, name).numpy(),
                                      np.asarray(getattr(jsd, name)), name)
    np.testing.assert_allclose(td_.lower.numpy(), np.asarray(jsd.lower),
                               rtol=1e-6)
    np.testing.assert_allclose(td_.upper.numpy(), np.asarray(jsd.upper),
                               rtol=1e-6)
    env, jenv = td_.emitters[0], jsd.emitters[0]
    assert env.mesh_index == jenv.mesh_index == 1
    assert float(env.sampling_weight) == float(jenv.sampling_weight) == 1.0
    assert own.res == tuple(jenv.cell_distrb.res) == (126, 62)
    jpmf = np.asarray(jenv.cell_distrb.distrb.pmf)
    assert np.abs(own.distrb.pmf.numpy() - jpmf).max() < 1e-5 * jpmf.max()
    assert own.needs_coin and td_.emitter_coin_needed


def test_scene_compile_takes_cached_table(standin):
    """A scene compile (which a training step runs every step) takes the
    table of the last ``configure()`` and builds none, even from an
    attached radiance."""
    sc = standin[2]
    env = sc.emitter_env
    base = env.radiance.data
    env.radiance.data = base.clone().requires_grad_()
    try:
        sd = sc.configure_data()
    finally:
        env.radiance.data = base
    cached = env._cell_distrb_cache.distrb
    assert sd.emitters[0].cell_distrb.distrb.alias_rows is cached.alias_rows
    assert sd.emitters[0].cell_distrb.distrb.pmf is cached.pmf
    assert sd.emitters[0].radiance.data.requires_grad


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(15)
    return (rng.random((N, 2)).astype(np.float32),
            rng.random(N).astype(np.float32))


@pytest.mark.parametrize("coin", [False, True])
def test_envmap_sampling_matches_jax(standin, lanes, coin):
    """``sample_direction`` and ``sample_position`` on the JAX package's
    7,812-cell table, with and without the alias coin: the cells drawn are
    bitwise the JAX package's; directions (``sin``/``cos``) and pdfs
    within 1e-5 rel L1 (measured 7.3e-9 and 2.5e-8); the point on the sky
    box, its pdf and ``sample_position_pdf`` there (``atan2``, ``acos``)
    within 1e-5 (measured 4.1e-9, 3.6e-8, 4.3e-8), and the last equals the
    sample's own pdf within 1e-5 (measured 1.3e-7)."""
    _, jsd, sc, _ = standin
    env, jenv = sc.data.emitters[0], jsd.emitters[0]
    uv, u_coin = lanes
    c = _t(u_coin) if coin else None
    jc = jnp.asarray(u_coin) if coin else None
    wu, _ = env.cell_distrb.sample_reuse(_t(uv), c)
    jwu, _ = jenv.cell_distrb.sample_reuse(jnp.asarray(uv), jc)
    res = np.asarray(env.cell_distrb.res)
    np.testing.assert_array_equal(np.floor(wu.numpy() * res),
                                  np.floor(np.asarray(jwu) * res))
    d, pdf = env.sample_direction(_t(uv), c)
    jd, jpdf = jenv.sample_direction(jnp.asarray(uv), jc)
    assert _rel(d.numpy(), jd) < 1e-5 and _rel(pdf.numpy(), jpdf) < 1e-5
    ref_p = np.random.default_rng(16).uniform(-30, 30, (N, 3)).astype(
        np.float32) + np.float32([0, 0, -100])
    act = np.ones(N, bool)
    ps = env.sample_position(_t(ref_p), _t(uv), _t(act), c)
    jps = jenv.sample_position(jnp.asarray(ref_p), jnp.asarray(uv),
                               jnp.asarray(act), u_coin=jc)
    assert _rel(ps.p.numpy(), jps.p) < 1e-5
    assert _rel(ps.pdf.numpy(), jps.pdf) < 1e-5
    np.testing.assert_array_equal(ps.n.numpy(), np.asarray(jps.n))
    its = types.SimpleNamespace(p=ps.p, n=ps.n, mesh_id=torch.full(
        (N,), env.mesh_index, dtype=torch.int32))
    jits = types.SimpleNamespace(p=jps.p, n=jps.n, mesh_id=jnp.full(
        (N,), jenv.mesh_index, jnp.int32))
    back = env.sample_position_pdf(_t(ref_p), its, _t(act))
    jback = jenv.sample_position_pdf(jnp.asarray(ref_p), jits,
                                     jnp.asarray(act))
    assert _rel(back.numpy(), jback) < 1e-5
    # the density the sample reports is the density of the point it lands
    # on (no emitter-selection factor: the map is the only emitter)
    assert _rel(back.numpy(), ps.pdf.numpy()) < 1e-5


def test_envmap_eval_direction_matches_jax(standin):
    """``eval_direction`` and its gradients to the direction and to the
    texture on 4,096 seeded directions and the two poles, against the JAX
    package's. Measured rel L1: radiance 1.0e-7, d/dwi 1.1e-7, d/dtexture
    3.1e-7 (bounds 1e-5, 1e-4, 1e-5). At the poles the port's gradients
    are finite: the 1e-6 clamp inside acos keeps d(acos) finite, and
    torch's atan2 has a zero gradient at the origin, where XLA's is NaN
    (so the direction gradient is compared off the poles)."""
    _, jsd, sc, _ = standin
    env, jenv = sc.data.emitters[0], jsd.emitters[0]
    wi = np.concatenate([_unit(np.random.default_rng(17), N),
                         np.float32([[0, 1, 0], [0, -1, 0]])])
    wgt = np.random.default_rng(18).uniform(0.5, 1.5, wi.shape).astype(
        np.float32)
    act = np.ones(wi.shape[0], bool)

    def jf(d, tex):
        e = jenv.replace(radiance=jbitmap.Bitmap(tex))
        out = e.eval_direction(d, jnp.asarray(act))
        return jnp.sum(out * wgt), out

    (_, jout), (jgd, jgt) = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        jnp.asarray(wi), jnp.asarray(jenv.radiance.data))
    wi_t = _t(wi).requires_grad_()
    tex = env.radiance.data.clone().requires_grad_()
    e = tbitmap.Bitmap(tex)
    out = dataclasses.replace(env, radiance=e).eval_direction(wi_t, _t(act))
    gd, gt = torch.autograd.grad((out * _t(wgt)).sum(), (wi_t, tex))
    assert _rel(out.detach().numpy(), jout) < 1e-5
    assert _rel(gd[:-2].numpy(), np.asarray(jgd)[:-2]) < 1e-4
    assert _rel(gt.numpy(), jgt) < 1e-5
    assert bool(torch.isfinite(gd[-2:]).all()) and bool(
        torch.isfinite(gt).all())


def test_textured_bsdf_and_image_files_raise(tmp_path):
    """A textured BSDF parameter, which raised before hits carried texture
    coordinates, now builds its material table, whose lanes read the
    texture as ``Bitmap.eval`` does, bit for bit; an image path, which
    raised before the port read image files, now loads the file, and a
    missing file raises ``FileNotFoundError``."""
    from psdr_jit_tpu_torch.bsdf.bsdf import MICROFACET, material_table

    sc = pt.Scene(device=CPU)
    tex = np.random.default_rng(4).random((2, 3, 3)).astype(np.float32)
    sc.add_BSDF(pt.MicrofacetBSDF(tex), "m")
    uv = torch.rand(64, 2)
    spec = material_table(sc.bsdfs, CPU).params[MICROFACET][0]
    assert torch.equal(spec.eval(torch.zeros(64, dtype=torch.int64), uv),
                       sc.bsdfs[0].specularReflectance.eval(uv))
    for make in (pt.EnvironmentMap, pt.Bitmap3f):
        with pytest.raises(FileNotFoundError):
            make(str(tmp_path / "missing.exr"))
    sky = np.random.default_rng(5).random((4, 8, 4)).astype(np.float32)
    write_image(str(tmp_path / "sky.exr"), sky)
    assert torch.equal(pt.EnvironmentMap(str(tmp_path / "sky.exr")).radiance
                       .data, torch.from_numpy(sky[..., :3].copy()))
    assert torch.equal(pt.Bitmap3f(str(tmp_path / "sky.exr")).data,
                       torch.from_numpy(sky[..., :3].copy()))
    assert pt.Bitmap1f(0.3).data.shape == (1, 1, 1)
    assert pt.Bitmap3f(np.ones((4, 5, 3))).resolution == (5, 4)
    with pytest.raises(ValueError, match="one envmap"):
        sc.add_EnvironmentMap(pt.EnvironmentMap())
        sc.add_EnvironmentMap(pt.EnvironmentMap())


# ---------------------------------------------------------------------------
# closed forms through the port (tests/test_envmap.py)
# ---------------------------------------------------------------------------

def _quad(pts):
    m = pt.Mesh()
    m.use_face_normals = True
    m.enable_edges = False
    m.load_raw(np.asarray(pts, np.float32),
               np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    return m


def _plane_under_sky(L=1.0, rho=0.6, w=32, envres=(8, 16)):
    """A diffuse plane at z = 0 seen from above by an orthographic camera,
    under a uniform map of radiance L (``tests/test_envmap.py:17``)."""
    sc = pt.Scene(device=CPU)
    sc.opts = pt.RenderOption(w, w, 32, 0, 0)
    cam = pt.OrthographicCamera(0.1, 100.0)
    cam.to_world = txf.look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0],
                               [0.0, 1.0, 0.0])
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF([rho, rho, rho]), "rho")
    sc.add_Mesh(_quad([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]]),
                None, "rho")
    sc.add_EnvironmentMap(pt.EnvironmentMap(np.full(envres + (3,), L,
                                                    np.float32)))
    return sc


def test_uniform_sky_diffuse_plane():
    """A diffuse plane under a uniform sky L has radiance rho L
    (``tests/test_envmap.py:49``, rtol 0.03)."""
    L, rho = 2.0, 0.6
    sc = _plane_under_sky(L=L, rho=rho)
    img = pt.PathTracer(1).renderC(sc, 0, seed=0).reshape(32, 32, 3)
    np.testing.assert_allclose(float(img[8:24, 8:24, 0].mean()), rho * L,
                               rtol=0.03)


def test_uniform_sky_seen_directly():
    """Camera rays that miss the geometry end on the bounding mesh and
    return the map's radiance (``tests/test_envmap.py:59``, rtol 1e-3)."""
    L = 2.0
    sc = _plane_under_sky(L=L)
    sc.meshes[0].to_world_raw = txf.scale([0.05, 0.05, 1.0])
    img = pt.PathTracer(1).renderC(sc, 0, seed=0).reshape(32, 32, 3)
    np.testing.assert_allclose(img[:4, :4, 0].numpy(), L, rtol=1e-3)


def test_envmap_nee_vs_bsdf_sampling():
    """Direct light from a non-uniform map by NEE alone and by BSDF
    sampling alone agree (``tests/test_envmap.py:74``: within 15%), which
    holds ``sample_position`` and ``sample_position_pdf`` to each other."""
    rng = np.random.default_rng(0)
    tex = rng.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    tex[2] *= 10.0
    sc = _plane_under_sky()
    sc.emitters[0].radiance = pt.Bitmap3f(tex)
    sc.configure()
    means = [np.mean([float(pt.Direct(mis).renderC(sc, 0, seed).mean())
                      for seed in range(4)]) for mis in (0, 1)]
    assert abs(means[0] - means[1]) < 0.15 * max(means), means


def test_envmap_scale_tangent_is_the_image():
    """The image is linear in the map's scale, so renderD's forward
    tangent along it equals the difference of two renders
    (``tests/test_envmap.py:88``, rtol 1e-3)."""
    sc = _plane_under_sky(L=1.0)
    sc.configure()
    integ = pt.PathTracer(1)
    env = sc.emitters[0]

    def set_scale(v):
        env.scale = v

    img1, dimg = forward_mode(integ, sc, set_scale, torch.ones(()), 1.0,
                              seed=0)
    env.scale = 2.0
    img2 = integ.renderD(sc, 0, seed=0)
    env.scale = 1.0
    np.testing.assert_allclose(dimg.numpy(), (img2 - img1).numpy(),
                               rtol=1e-3, atol=1e-4)
    assert float(dimg.abs().mean()) > 0.1


def _envmap_shadow_scene(w=32, sppse=64, rho=0.8, L=1.0):
    """A diffuse receiver at z = 0 under a uniform sky L, a black occluder
    quad at z = 2 (edges on), an orthographic camera on x in [1.5, 3.5]
    (``tests/test_envmap.py:135``)."""
    sc = pt.Scene(device=CPU)
    sc.opts = pt.RenderOption(w, w, 4, 0, sppse)
    cam = pt.OrthographicCamera(0.1, 100.0)
    cam.to_world = txf.look_at([2.5, 0.0, 10.0], [2.5, 0.0, 0.0],
                               [0.0, 1.0, 0.0])
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF([rho, rho, rho]), "rho")
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    sc.add_Mesh(_quad([[-12, -12, 0], [12, -12, 0], [12, 12, 0],
                       [-12, 12, 0]]), None, "rho")
    occ = pt.Mesh()
    occ.use_face_normals = True
    occ.load_raw(np.asarray([[-1, -3, 2], [1, -3, 2], [1, 3, 2], [-1, 3, 2]],
                            np.float32),
                 np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    sc.add_Mesh(occ, None, "black")
    sc.add_EnvironmentMap(pt.EnvironmentMap(np.full((8, 16, 3), L,
                                                    np.float32)))
    return sc, occ


def _mean_tx_tangent(sc, occ, seed):
    base = occ.to_world_raw.clone()

    def set_tx(v):
        occ.to_world_raw = base + torch.nn.functional.pad(v.reshape(1, 1),
                                                          (3, 0, 0, 3))

    _, tangent = forward_mode(pt.PathTracer(1), sc, set_tx, torch.zeros(()),
                              1.0, seed=seed)
    return float(tangent.mean())


def test_envmap_secondary_edge_gradient_oracle():
    """The envmap boundary estimator (light points on the sky box)
    reproduces the quadrature-exact derivative of the mean image under
    the occluder's translation (``tests/test_envmap.py:216``: rtol 0.25
    over 6 seeds; the oracle is the JAX test's)."""
    from test_envmap import _envmap_shadow_oracle

    sc, occ = _envmap_shadow_scene()
    sc.configure()
    g = np.mean([_mean_tx_tangent(sc, occ, seed) for seed in range(6)])
    expect = _envmap_shadow_oracle(0.8, 1.0)
    assert expect < 0
    np.testing.assert_allclose(g, expect, rtol=0.25)


def test_envmap_interior_alone_misses_gradient():
    """Without the secondary-edge term the interior misses most of it
    (``tests/test_envmap.py:240``)."""
    from test_envmap import _envmap_shadow_oracle

    sc, occ = _envmap_shadow_scene(sppse=0)
    sc.configure()
    assert abs(_mean_tx_tangent(sc, occ, 0)) < 0.25 * abs(
        _envmap_shadow_oracle())


def test_multi_emitter_mis_partitions_unity():
    """Map and area light: NEE alone, BSDF sampling alone and MIS agree in
    expectation (``tests/test_envmap.py:259``: within 5% and 8%), which
    holds the map's pdf to carry its emitter-selection probability, as in
    the JAX package (a documented deviation from the reference)."""
    sc = _plane_under_sky(w=32, rho=0.6, L=0.4)
    sc.opts.spp = 256
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "black")
    sc.add_Mesh(_quad([[2, -1, 4], [2, 1, 4], [4, 1, 4], [4, -1, 4]]), None,
                "black", pt.AreaLight([6.0, 6.0, 6.0]))
    sc.configure()
    assert len(sc.data.emitters) == 2
    means = [float(pt.Direct(mis).renderC(sc, 0, seed=mis + 1).mean())
             for mis in (0, 1, 2)]
    assert abs(means[2] - means[0]) < 0.05 * means[0], means
    assert abs(means[2] - means[1]) < 0.08 * means[1], means


def test_portrait_ortho_film_inside_sky_box():
    """A portrait film's rows lie inside the sky box, so every row shows
    the lit plane, not the map (``tests/test_envmap.py:281``)."""
    L, rho = 0.4, 0.6
    sc = _plane_under_sky(L=L, rho=rho, w=16)
    sc.opts = pt.RenderOption(16, 48, 64, 0, 0)
    img = pt.PathTracer(1).renderC(sc, 0, seed=2).reshape(48, 16, 3)
    rows = img.mean((1, 2)).numpy()
    assert np.all(np.abs(rows - rho * L) < 0.35 * rho * L), rows


def test_bsdf_dispatch_matches_jax():
    """The dispatch by BSDF type (one pass a type, ``torch.where`` across)
    against the JAX package's masked loop over instances, on 4,096 lanes
    of three materials (a Microfacet, a two-sided and a one-sided diffuse)
    and lanes without one (slot -1): eval, sample and pdf. Measured rel
    L1: eval 4.0e-9, sampled wo 6.3e-8, sampled pdf 3.9e-7, pdf 2.9e-8
    (bound 1e-5); the sampled lanes' validity is equal."""
    from psdr_jit_tpu.bsdf import bsdf as jb
    from psdr_jit_tpu_torch.bsdf import bsdf as tb

    rng = np.random.default_rng(20)
    wi, wo = _unit(rng, N), _unit(rng, N)
    rnd3 = rng.random((N, 3)).astype(np.float32)
    slot = rng.integers(-1, 3, N).astype(np.int32)
    jbsdfs = (psdr.MicrofacetBSDF((0.04,) * 3, (0.5, 0.4, 0.3), 0.3),
              psdr.DiffuseBSDF([0.7, 0.5, 0.3]), psdr.DiffuseBSDF([0.2] * 3))
    tbsdfs = [pt.MicrofacetBSDF((0.04,) * 3, (0.5, 0.4, 0.3), 0.3),
              pt.DiffuseBSDF([0.7, 0.5, 0.3]), pt.DiffuseBSDF([0.2] * 3)]
    jbsdfs[1].twoSide = tbsdfs[1].twoSide = True
    jits = types.SimpleNamespace(wi=jnp.asarray(wi),
                                 uv=jnp.zeros((N, 2), jnp.float32))
    tits = types.SimpleNamespace(wi=_t(wi), uv=torch.zeros(N, 2))
    act = np.ones(N, bool)
    mats = tb.material_table(tbsdfs, CPU)
    val = tb.eval_dispatch(mats, _t(slot), tits, _t(wo), _t(act))
    jval = jb.eval_dispatch(jbsdfs, jnp.asarray(slot), jits, jnp.asarray(wo),
                            jnp.asarray(act))
    bs = tb.sample_dispatch(mats, _t(slot), tits, _t(rnd3), _t(act))
    jbs = jb.sample_dispatch(jbsdfs, jnp.asarray(slot), jits,
                             jnp.asarray(rnd3), jnp.asarray(act))
    pdf = tb.pdf_dispatch(mats, _t(slot), tits, _t(wo), _t(act))
    jpdf = jb.pdf_dispatch(jbsdfs, jnp.asarray(slot), jits, jnp.asarray(wo),
                           jnp.asarray(act))
    assert _rel(val.numpy(), jval) < 1e-5 and float(val.abs().sum()) > 0
    np.testing.assert_array_equal(bs.is_valid.numpy(),
                                  np.asarray(jbs.is_valid))
    ok = bs.is_valid.numpy()
    assert _rel(bs.wo.numpy()[ok], np.asarray(jbs.wo)[ok]) < 1e-5
    assert _rel(bs.pdf.numpy()[ok], np.asarray(jbs.pdf)[ok]) < 1e-5
    assert _rel(pdf.numpy(), jpdf) < 1e-5
    assert not val.numpy()[slot < 0].any() and not ok[slot < 0].any()


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

def _jax_step(jsc, warp=None):
    """The JAX package's ``loss_and_grad`` of the L2 loss against
    ``TARGET``, with gradients to the vertex offsets and the radiance
    texture (``bench.py _time_envmap``): ``(loss, dv, dtexture, image)``."""
    mesh, env = jsc.meshes[0], jsc.emitter_env
    bv, br = mesh.vertex_positions_raw, env.radiance
    tgt = jnp.asarray(TARGET)

    def apply(p):
        mesh.vertex_positions_raw = bv + p[0]
        env.radiance = jax.tree_util.tree_map(jnp.add, br, p[1])

    p0 = (jnp.zeros_like(bv), jax.tree_util.tree_map(jnp.zeros_like, br))
    try:
        loss, g, img = _jax_modes(lambda: psdr.PathTracer(1).loss_and_grad(
            jsc, p0, apply,
            lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
            seed=SEED, **({} if warp is None else {"warp": warp})))
    finally:
        mesh.vertex_positions_raw, env.radiance = bv, br
    return (float(loss), np.asarray(g[0]), np.asarray(g[1].data),
            np.asarray(img))


def _port_step(sc, warp=None):
    mesh, env = sc.meshes[0], sc.emitter_env
    bv, br = mesh.vertex_positions_raw.clone(), env.radiance.data.clone()
    tgt = _t(TARGET)

    def apply(p):
        mesh.vertex_positions_raw = bv + p["dv"]
        env.radiance.data = br + p["dr"]

    loss, g, img = pt.PathTracer(1).loss_and_grad(
        sc, {"dv": torch.zeros_like(bv), "dr": torch.zeros_like(br)}, apply,
        lambda rows, pix: ((rows - tgt[pix]) ** 2).sum(-1), seed=SEED,
        warp=warp)
    return float(loss), g["dv"].numpy(), g["dr"].numpy(), img.numpy()


def _compare_steps(ref, out, bounds):
    (jl, jdv, jdr, jimg), (l, dv, dr, img) = ref, out
    assert np.abs(jdv).sum() > 0 and np.abs(jdr).sum() > 0
    assert abs(l - jl) / abs(jl) < bounds["loss"]
    assert _rel(img, jimg) < bounds["image"]
    assert _rel(dv, jdv) < bounds["dv"]
    assert _rel(dr, jdr) < bounds["dr"]


def test_slice_renderC_matches_jax(standin):
    """renderC of the stand-in (measured 4.4e-7 rel L1, bound 1e-5)."""
    jsc, _, sc, _ = standin
    jimg = np.asarray(_jax_modes(
        lambda: psdr.PathTracer(1).renderC(jsc, 0, seed=SEED)))
    img = pt.PathTracer(1).renderC(sc, 0, seed=SEED).numpy()
    assert float(np.abs(jimg).sum()) > 0
    assert _rel(img, jimg) < 1e-5


def test_slice_renderD_tangent_matches_jax(standin):
    """renderD's forward-mode gradient image along the mesh's x
    translation, with all three terms (the tutorial's gradient image):
    measured rel L1 primal 4.9e-7 (bound 1e-5), tangent 3.7e-4 (bound
    2e-3): one pixel carries 0.068 of the tangent's 186 in L1, a lane
    whose hit test the two packages decide differently (seeds 5 and 7:
    5.8e-6, 4.2e-5)."""
    jsc, _, sc, _ = standin
    jm = jsc.meshes[0]
    base = jm.to_world_raw

    def jr(tx):
        jm.to_world_raw = base.at[0, 3].add(tx)
        return psdr.PathTracer(1).renderD(jsc, 0, seed=SEED)

    try:
        jp, jt = _jax_modes(lambda: jax.jvp(jr, (jnp.float32(0.0),),
                                            (jnp.float32(1.0),)))
    finally:
        jm.to_world_raw = base
    mesh = sc.meshes[0]
    tbase = mesh.to_world_raw.clone()

    def set_tx(v):
        mesh.to_world_raw = tbase + torch.nn.functional.pad(v.reshape(1, 1),
                                                            (3, 0, 0, 3))

    p, t = forward_mode(pt.PathTracer(1), sc, set_tx, torch.zeros(()), 1.0,
                        seed=SEED)
    assert float(np.abs(np.asarray(jt)).sum()) > 0
    assert _rel(p.numpy(), jp) < 1e-5
    assert _rel(t.numpy(), jt) < 2e-3


def test_slice_step_matches_jax(standin):
    """The unguided training step. Measured rel: loss 1.4e-7, image
    4.8e-7, vertex offsets 1.7e-5, texture 1.8e-6 (bounds 1e-5, 1e-5,
    1e-3, 1e-4): the vertex offsets' heavy-tailed secondary-edge lanes
    move with the last bits of their hit points."""
    jsc, _, sc, _ = standin
    _compare_steps(_jax_step(jsc), _port_step(sc),
                   {"loss": 1e-5, "image": 1e-5, "dv": 1e-3, "dr": 1e-4})


def test_slice_guided_step_matches_jax(standin):
    """The step guided by a [8, 4, 4, 4] table (128 cells, 4 samples a
    cell): the port's own table equals the JAX package's bit for bit here
    (the integrand's few valid samples sum in one order); the step is then
    given the JAX package's. Measured rel: loss 1.4e-7, image 4.8e-7,
    vertex offsets 8.4e-6, texture 1.8e-6 (bounds as unguided)."""
    jsc, _, sc, _ = standin
    jint = psdr.PathTracer(1)
    _jax_modes(lambda: jint.preprocess_secondary_edges(jsc, 0, [8, 4, 4, 4],
                                                       1))
    jw = jint.warpper[0]
    tint = pt.PathTracer(1)
    tint.preprocess_secondary_edges(sc, 0, [8, 4, 4, 4], 1)
    assert _rel(tint.warpper[0].distrb.pmf.numpy(), jw.distrb.pmf) < 1e-6
    rows = jw.distrb.alias_rows
    warp = td.HyperCubeDistribution(res=tuple(jw.res), distrb=td.
                                    DiscreteDistribution(
        pmf=_t(jw.distrb.pmf), cdf=_t(jw.distrb.cdf),
        alias_rows=None if rows is None else _t(rows)))
    _compare_steps(_jax_step(jsc, jw), _port_step(sc, warp),
                   {"loss": 1e-5, "image": 1e-5, "dv": 1e-3, "dr": 1e-4})


def test_slice_coin_schedule(standin):
    """Where the table takes a coin the general Li draws ``3 * depth``
    counters (next_2d, the coin, next_nd(3) a bounce): the sampler's
    counter after ``Li`` says so."""
    sc = standin[2]
    sd = sc.data
    s = Sampler(0, torch.arange(64))
    ray = sd.sensors[0].sample_primary_ray(torch.rand(64, 2), diff=False)
    pt.PathTracer(2).Li(sd, s, ray, torch.ones(64, dtype=torch.bool))
    assert sd.emitter_coin_needed and s.cnt == 3 * 2


def test_floored_primary_edge_table_matches_jax():
    """Above 2,048 primary edges ``configure()`` samples from the JAX
    package's floored table (silhouettes plus 1/16 of their length spread
    over every edge) with alias rows, and the edge sample draws a coin:
    on the 5,120-triangle stand-in (7,680 edges) the masses agree with the
    JAX package's to 3.8e-9 rel L1 (bound 1e-5: its sums run in another
    order), and given its table, the samples' pixels equal its own and
    the pdfs agree within 1e-5 (measured bitwise)."""
    from psdr_jit_tpu.sensor.sensor import sample_primary_edge as jspe
    from psdr_jit_tpu_torch.sensor.sensor import sample_primary_edge

    verts, faces, _ = envmap_standin(4, (4, 8), 0)
    jsc = psdr.Scene()
    jsc.opts = psdr.RenderOption(W, W, 1, 1, 0)
    cam = psdr.PerspectiveCamera(80, 0.000001, 10000000.0)
    cam.to_world = jnp.asarray(np.diag([-1.0, 1.0, -1.0, 1.0]), jnp.float32)
    jsc.add_Sensor(cam)
    jsc.add_BSDF(psdr.DiffuseBSDF([0.5] * 3), "d")
    mesh = psdr.Mesh()
    mesh.load_raw(verts, faces)
    jsc.add_Mesh(mesh, MESH_TO_WORLD, "d", None)
    jsc.configure()
    jinfo = jsc.data.sensors[0].edge_info
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    info = sc.configure().sensors[0].edge_info
    assert info.distrb.size == jinfo.distrb.size == 7680
    assert info.distrb.needs_coin and jinfo.distrb.needs_coin
    jpmf = np.asarray(jinfo.distrb.pmf)
    assert _rel(info.distrb.pmf.numpy(), jpmf) < 1e-5
    assert float(info.distrb.pmf.min()) > 0.0
    sdat = dataclasses.replace(sc.data.sensors[0], edge_info=dataclasses.
                               replace(info, distrb=td.DiscreteDistribution(
                                   pmf=_t(jinfo.distrb.pmf),
                                   cdf=_t(jinfo.distrb.cdf),
                                   alias_rows=_t(jinfo.distrb.alias_rows))))
    rng = np.random.default_rng(21)
    u, coin = rng.random(N).astype(np.float32), rng.random(N).astype(
        np.float32)
    es = sample_primary_edge(sdat, _t(u), _t(coin))
    jes = jspe(jsc.data.sensors[0], jnp.asarray(u), jnp.asarray(coin))
    np.testing.assert_array_equal(es.idx.numpy(), np.asarray(jes.idx))
    assert _rel(es.pdf.numpy(), jes.pdf) < 1e-5
