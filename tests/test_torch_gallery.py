"""The large-scene slice of psdr_jit_tpu_torch on the CPU: the gallery
scene builder, the Morton triangle order, the shading modules of the
general path tracer, the general detached Li and renderC, each against the
JAX package.

* ``chip_smoke.gallery_arrays`` (numpy, for the card's machine, which has
  no JAX) equals ``interop.scene_to_arrays(make_gallery(...))`` key by key
  and bit for bit.
* The Morton permutation equals the JAX package's, which runs its C++
  host library (``psdr_jit_tpu/native``), bit for bit; so do the
  configured triangle tables and per-face tables of a 652-triangle gallery
  (vertex normals to rounding: the two packages sum them in other orders).
* Warps, the diffuse BSDF (one- and two-sided), the area light's sampling
  and ``SceneData``'s shading interface agree with the JAX package's to
  f32 rounding on the same inputs (1e-5: the two packages evaluate the
  warp's sine and cosine polynomials in other orders, and the cosine
  hemisphere's ``z = sqrt(1 - x^2 - y^2)`` magnifies that near the
  horizon).
* ``PathTracer._li_general`` on the Cornell box draws as K2 does, lane for
  lane: against the port's plain K2 (``li_mega_plain``) it agrees within
  relative L1 5e-3, the JAX package's own bound between its general Li and
  its megakernel (``tests/test_megakernel.py``); measured 7.1e-4, 6.1e-4
  and 5.5e-4 at depth 1, 2 and 3 (the general Li's hit point is the
  path formulation's ``p0 + e1 u + e2 v``, K2's ``o + d t``).
* ``renderC`` against the JAX package's ``renderC`` (CPU, default backend,
  its general ``_li_xla``) at 16x16, spp 2, depth 2, on the 652- and
  5,132-triangle galleries and a two-sided Cornell box: relative L1 < 5e-3,
  the same bound; measured 6.0e-8, 6.0e-8 and 1.0e-4. The two packages'
  camera rays differ in the last bit (the JAX CPU backend contracts the
  camera transform into fused multiply-adds), which flips grazing tests on
  a few lanes of the box.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import gallery_arrays
from psdr_jit_tpu import native
from psdr_jit_tpu.bsdf.diffuse import DiffuseBSDF as JDiffuse
from psdr_jit_tpu.core import warp as jwarp
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu.shape.mesh import sample_position as j_sample_position
from psdr_jit_tpu_torch.bsdf.diffuse import (diffuse_eval, diffuse_pdf,
                                             diffuse_sample)
from psdr_jit_tpu_torch.core import warp
from psdr_jit_tpu_torch.integrator import base
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.ops import megakernel as mk
from psdr_jit_tpu_torch.scene.scene import morton_order
from psdr_jit_tpu_torch.shape.mesh import sample_position
from scenes import make_cbox, make_gallery
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
RTOL = 5e-3  # relative L1 between a general Li and a megakernel (JAX's)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.fixture(scope="module")
def gallery652():
    """The 652-triangle gallery (two spheres at subdivision 2 and the room)
    in both packages, configured."""
    jsc = make_gallery(16, 16, 2, n_spheres=2, subdiv=2)
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.configure()
    return jsc, sc


@pytest.mark.parametrize("size", [(16, 16, 2, 2, 2), (16, 16, 2, 4, 2),
                                  (64, 64, 2, 4, 3), (256, 256, 4, 80, 3)])
def test_gallery_arrays_match_make_gallery(size):
    w, h, spp, n_spheres, subdiv = size
    ref = pt.scene_to_arrays(make_gallery(w, h, spp, n_spheres=n_spheres,
                                          subdiv=subdiv))
    got = gallery_arrays(w, h, spp, n_spheres, subdiv)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("cloud", ["gallery", "normal", "grid", "flat",
                                   "one"])
def test_morton_order_matches_hostops(cloud):
    """The port's Morton permutation is the JAX package's C++ one, bit for
    bit: on the full gallery's centroids (computed by both packages) and
    on random clouds with equal codes, a flat axis and a single point."""
    assert native.available(), "the JAX package's C++ host library"
    rng = np.random.default_rng(7)
    if cloud == "gallery":
        jsc = make_gallery(256, 256, 4)
        sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
        c = sc._world_tri_centroids()
        np.testing.assert_array_equal(c, jsc._world_tri_centroids())
        assert c.shape == (102412, 3)
    elif cloud == "normal":
        c = rng.normal(size=(20000, 3)) * [3.0, 0.01, 700.0]
    elif cloud == "grid":
        c = rng.integers(0, 5, (5000, 3)) * 0.37 - 1.0
    elif cloud == "flat":
        c = np.concatenate([rng.uniform(-1, 1, (3000, 2)),
                            np.full((3000, 1), 2.5)], axis=1)
    else:
        c = np.ones((1, 3))
    c = np.asarray(c, np.float32)
    np.testing.assert_array_equal(morton_order(c), native.morton_order(c))


def test_configured_tables_match_jax(gallery652):
    """A 652-triangle gallery configures Morton-ordered: the permutation,
    the triangle tables and the per-face tables are the JAX package's."""
    jsc, sc = gallery652
    jd, sd = jsc.data, sc.data
    np.testing.assert_array_equal(sc._tri_perm, np.asarray(jsc._tri_perm))
    assert not np.array_equal(sc._tri_perm, np.arange(652))
    for name in ("face_mesh_id", "face_normal_mask"):
        np.testing.assert_array_equal(_np(getattr(sd, name)),
                                      _np(getattr(jd, name)), err_msg=name)
    for name in ("p0", "e1", "e2", "face_indices"):
        np.testing.assert_array_equal(_np(getattr(sd.tri, name)),
                                      _np(getattr(jd.tri, name)),
                                      err_msg=name)
    for name in ("n0", "n1", "n2", "face_normal", "face_area"):
        np.testing.assert_allclose(_np(getattr(sd.tri, name)),
                                   _np(getattr(jd.tri, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_warps_match_jax():
    u = np.random.default_rng(1).random((4000, 3)).astype(np.float32)
    u[:4, :2] = [[0.5, 0.5], [0.25, 0.5], [1.0, 0.5], [0.5, 1.0]]
    tu = torch.from_numpy(u)
    for name in ("square_to_uniform_disk_concentric",
                 "square_to_cosine_hemisphere",
                 "square_to_uniform_triangle"):
        np.testing.assert_allclose(
            getattr(warp, name)(tu[:, :2]).numpy(),
            np.asarray(getattr(jwarp, name)(jnp.asarray(u[:, :2]))),
            rtol=1e-5, atol=1e-5, err_msg=name)
    v = warp.square_to_cosine_hemisphere(tu[:, :2])
    np.testing.assert_allclose(
        warp.square_to_cosine_hemisphere_pdf(v).numpy(),
        np.asarray(jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(
            v.numpy()))), rtol=1e-6)


@pytest.mark.parametrize("two_side", [False, True])
def test_diffuse_bsdf_matches_jax(two_side):
    """The port's per-lane eval, sample and pdf of a constant diffuse BSDF
    against the JAX package's methods, one- and two-sided, for directions
    on both sides of the surface."""
    rng = np.random.default_rng(2)
    wi = rng.normal(size=(3000, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = rng.normal(size=(3000, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    rnd = rng.random((3000, 3)).astype(np.float32)
    act = rng.random(3000) < 0.9
    refl = [0.3, 0.6, 0.9]
    jb = JDiffuse(refl, two_side)
    jits = SimpleNamespace(wi=jnp.asarray(wi), uv=jnp.zeros((3000, 2)))
    ja, ta = jnp.asarray(act), torch.from_numpy(act)
    two = torch.full((3000,), two_side)
    twi, two_ = torch.from_numpy(wi), torch.from_numpy(wo)
    np.testing.assert_allclose(
        diffuse_eval(torch.tensor(refl), two, twi, two_, ta).numpy(),
        np.asarray(jb.eval(jits, jnp.asarray(wo), ja)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        diffuse_pdf(two, twi, two_, ta).numpy(),
        np.asarray(jb.pdf(jits, jnp.asarray(wo), ja)), rtol=1e-6, atol=1e-7)
    js = jb.sample(jits, jnp.asarray(rnd), ja)
    ts = diffuse_sample(two, twi, torch.from_numpy(rnd), ta)
    for name in ("wo", "pdf", "eta"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(ts.is_valid.numpy(),
                                  np.asarray(js.is_valid))


def test_area_light_sampling_matches_jax(gallery652):
    jsc, sc = gallery652
    u = np.random.default_rng(3).random((5000, 2)).astype(np.float32)
    (jem,), (tem,) = jsc.data.emitters, sc.data.emitters
    ref = j_sample_position(jem.mesh_data, jnp.asarray(u))
    out = sample_position(tem.mesh_data, torch.from_numpy(u))
    for name in ("p", "n", "pdf", "J"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.is_valid.numpy(),
                                  np.asarray(ref.is_valid))


def test_shading_interface_matches_jax(gallery652):
    """SceneData's intersection (path formulation) and its emitter and BSDF
    dispatch on rays leaving the gallery's surfaces."""
    jsc, sc = gallery652
    jd, sd = jax.lax.stop_gradient(jsc.data), sc.data
    rng = np.random.default_rng(4)
    n = 3000
    j = rng.integers(0, 652, n)
    b = rng.random((n, 2)) * 0.5
    tri = sd.tri
    o = (tri.p0.numpy()[j] + tri.e1.numpy()[j] * b[:, :1]
         + tri.e2.numpy()[j] * b[:, 1:]).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.random(n) < 0.9
    ja, ta = jnp.asarray(act), torch.from_numpy(act)
    jits = jd.ray_intersect(JRay(jnp.asarray(o), jnp.asarray(d)), ja,
                            mode="path")
    tits = sd.ray_intersect(pt.Ray(torch.from_numpy(o), torch.from_numpy(d)),
                            ta)
    same = (tits.tri_id.numpy() == np.asarray(jits.tri_id))
    assert same.mean() > 0.995 and tits.valid.numpy()[same].mean() > 0.5
    keep = same & tits.valid.numpy()
    for name in ("t", "p", "n", "wi"):
        np.testing.assert_allclose(getattr(tits, name).numpy()[keep],
                                   np.asarray(getattr(jits, name))[keep],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(tits.mesh_id.numpy()[keep],
                                  np.asarray(jits.mesh_id)[keep])
    # the dispatch on the JAX package's own hits, so both see one record
    tits.wi = torch.from_numpy(np.array(jits.wi))
    keep_t = torch.from_numpy(keep)
    for name in ("emitter_slot", "bsdf_slot"):
        np.testing.assert_array_equal(
            getattr(sd, name)(tits).numpy()[keep],
            np.asarray(getattr(jd, name)(jits))[keep], err_msg=name)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    rnd = rng.random((n, 3)).astype(np.float32)
    pairs = [
        ("Le", sd.Le(tits, ta & keep_t), jd.Le(jits, ja & keep)),
        ("eval_bsdf", sd.eval_bsdf(tits, torch.from_numpy(wo), ta & keep_t),
         jd.eval_bsdf(jits, jnp.asarray(wo), ja & keep)),
        ("pdf_bsdf", sd.pdf_bsdf(tits, torch.from_numpy(wo), ta & keep_t),
         jd.pdf_bsdf(jits, jnp.asarray(wo), ja & keep)),
        ("sample_bsdf.wo", sd.sample_bsdf(tits, torch.from_numpy(rnd),
                                          ta & keep_t).wo,
         jd.sample_bsdf(jits, jnp.asarray(rnd), ja & keep).wo),
        ("emitter_position_pdf", sd.emitter_position_pdf(
            tits.p, tits, ta & keep_t),
         jd.emitter_position_pdf(jits.p, jits, ja & keep)),
        ("sample_emitter_position.p", sd.sample_emitter_position(
            tits.p, torch.from_numpy(rnd[:, :2]), ta).p,
         jd.sample_emitter_position(jits.p, jnp.asarray(rnd[:, :2]), ja).p),
    ]
    for name, out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert float(sd.Le(tits, ta).abs().sum()) > 0


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_li_general_matches_megakernel_plain(depth):
    """The general Li on the Cornell box (forced past K2) against the
    plain K2 on the same lanes: the same estimator, draw for draw."""
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(
        make_cbox(width=32, height=32, spp=4)), device=CPU)
    sd = sc.configure()
    assert mk.applicable(sd)
    _, sampler, samples = interior_lane_setup(32, 32, 4, 5,
                                              torch.arange(32 * 32))
    ray = sd.sensors[0].sample_primary_ray(samples)
    act = torch.ones(samples.shape[0], dtype=torch.bool)
    ref = mk.li_mega_plain(*mk.build_tables(sd), ray.o, ray.d, act,
                           sampler.lane, sampler.seed_value, depth,
                           sampler.cnt)
    cnt0 = sampler.cnt
    out = pt.PathTracer(depth)._li_general(sd, sampler, ray, act)
    assert sampler.cnt == cnt0 + 2 * depth
    assert bool(torch.isfinite(out).all())
    rel = _rel(out, ref)
    print(f"li_general depth {depth}: rel L1 {rel:.3e}")
    assert rel < RTOL


@pytest.mark.parametrize("scene", ["gallery652", "gallery5132",
                                   "cbox_two_side"])
def test_renderC_matches_jax(scene, gallery652):
    """The slice: renderC of scenes outside K2's scope against the JAX
    package's renderC on the CPU."""
    if scene == "gallery652":
        jsc = gallery652[0]
    elif scene == "gallery5132":
        jsc = make_gallery(16, 16, 2, n_spheres=4, subdiv=3)
    else:
        jsc = make_cbox(width=16, height=16, spp=2)
        jsc.bsdfs[2].twoSide = True
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    assert not mk.applicable(sc.configure())
    ref = np.asarray(psdr.PathTracer(2).renderC(jsc, 0, seed=3))
    out = pt.PathTracer(2).renderC(sc, 0, seed=3)
    assert out.shape == (256, 3) and bool(torch.isfinite(out).all())
    assert float(out.sum()) > 0
    rel = _rel(out, ref)
    print(f"renderC {scene}: rel L1 {rel:.3e}")
    assert rel < RTOL


def test_gallery_render_is_partition_exact(gallery652, monkeypatch):
    """Any chunking and any pixel crop give the full frame's rows bit for
    bit (the global-lane sampler contract)."""
    _, sc = gallery652
    integ = pt.PathTracer(2)
    img = integ.renderC(sc, 0, seed=1)
    monkeypatch.setattr(base, "GENERAL_CHUNK_LANES", 96)
    assert torch.equal(integ.renderC(sc, 0, seed=1), img)
    crop = torch.arange(7, 250, 11)
    assert torch.equal(integ.renderC(sc, 0, seed=1, pix_id=crop), img[crop])
    assert base.interior_chunk_lanes(sc.data) == 96


def test_unit_ray_intersect_large_scene(gallery652):
    """A picking query on the gallery against the JAX package's."""
    jsc, sc = gallery652
    rng = np.random.default_rng(5)
    o = np.tile(np.float32([[5.0, 5.0, -9.0]]), (2000, 1))
    tgt = rng.uniform([0.5, 0.5, 0.5], [9.5, 9.5, 9.9], (2000, 3))
    d = ((tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)).astype(
        np.float32)
    ref = jsc.unit_ray_intersect(jnp.asarray(o), jnp.asarray(d))
    out = sc.unit_ray_intersect(o, d)
    same = out.tri_id.numpy() == np.asarray(ref.tri_id)
    assert same.mean() >= 0.999 and out.valid.numpy().mean() > 0.9
    np.testing.assert_allclose(out.t.numpy()[same], np.asarray(ref.t)[same],
                               rtol=1e-4)
