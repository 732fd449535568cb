"""psdr_jit_tpu_torch's scene compile against the JAX package's.

The Cornell box is built once in the JAX package (tests/scenes.make_cbox),
carried across with interop.scene_to_arrays, and compiled by both. Integer
tables must be equal; float tables agree to rtol 1e-5 with atol 1e-3 (the
box's coordinates reach 560, and the two packages round vertex-normal sums
and the camera inverse in different orders).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.integrator.base import interior_lane_setup as j_lane_setup
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.ops import megakernel as mk
from scenes import make_cbox

NPZ = os.path.join(os.path.dirname(__file__), "data", "cbox_scene.npz")
RTOL, ATOL = 1e-5, 1e-3
CPU = torch.device("cpu")  # the entry points default to the card


@pytest.fixture(scope="module")
def pair():
    jsc = make_cbox(width=32, height=32, spp=4)
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    return jax.lax.stop_gradient(jsc.data), sc.configure()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("field", ["p0", "e1", "e2", "n0", "n1", "n2",
                                   "face_normal", "face_area",
                                   "face_indices"])
def test_triangle_soa(pair, field):
    jd, td = pair
    ref, out = _np(getattr(jd.tri, field)), _np(getattr(td.tri, field))
    assert out.shape == ref.shape
    if field == "face_indices":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_dispatch_tables(pair):
    jd, td = pair
    for name in ("face_normal_mask", "face_mesh_id", "mesh_bsdf_slot",
                 "mesh_emitter_slot"):
        np.testing.assert_array_equal(_np(getattr(td, name)),
                                      _np(getattr(jd, name)))
    np.testing.assert_allclose(_np(td.lower), _np(jd.lower), rtol=RTOL)
    np.testing.assert_allclose(_np(td.upper), _np(jd.upper), rtol=RTOL)


def test_emitter_and_light_distribution(pair):
    jd, td = pair
    (jem,), (tem,) = jd.emitters, td.emitters
    np.testing.assert_allclose(_np(tem.sampling_weight),
                               _np(jem.sampling_weight), rtol=RTOL)
    jdist, tdist = jem.mesh_data.face_distrb, tem.mesh_data.face_distrb
    for name in ("pmf", "cdf"):
        np.testing.assert_allclose(_np(getattr(tdist, name)),
                                   _np(getattr(jdist, name)), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(_np(tdist.total), _np(jdist.total), rtol=RTOL)
    for name in ("pmf", "cdf"):
        np.testing.assert_allclose(_np(getattr(td.emitters_distrb, name)),
                                   _np(getattr(jd.emitters_distrb, name)),
                                   rtol=RTOL)
    np.testing.assert_allclose(_np(tem.mesh_data.total_area),
                               _np(jem.mesh_data.total_area), rtol=RTOL)


@pytest.mark.parametrize("k, name", list(enumerate(
    ["tri", "box", "attr", "light", "misc"])))
def test_megakernel_tables(pair, k, name):
    jd, td = pair
    ref, out = _np(jmk.build_tables(jd)[k]), _np(mk.build_tables(td)[k])
    assert out.shape == ref.shape, name
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_primary_rays(pair):
    jd, td = pair
    pix = np.random.default_rng(3).permutation(32 * 32)[:300].astype(np.int32)
    _, js, jsamples = j_lane_setup(32, 32, 4, jnp.uint32(11), jnp.asarray(pix))
    _, ts, tsamples = interior_lane_setup(32, 32, 4, 11, torch.from_numpy(pix))
    np.testing.assert_array_equal(_np(ts.lane), _np(js.lane).astype(np.int64))
    np.testing.assert_array_equal(tsamples.numpy(), np.asarray(jsamples))
    assert ts.cnt == js.cnt
    jray = jd.sensors[0].sample_primary_ray(jsamples, diff=False)
    tray = td.sensors[0].sample_primary_ray(tsamples)
    np.testing.assert_allclose(tray.o.numpy(), np.asarray(jray.o), rtol=RTOL)
    np.testing.assert_allclose(tray.d.numpy(), np.asarray(jray.d), rtol=RTOL)


def test_committed_scene_matches_make_cbox():
    """tests/data/cbox_scene.npz (which the card's smoke run renders, with
    no JAX there) is exactly what scene_to_arrays makes of make_cbox."""
    ref = pt.scene_to_arrays(make_cbox(width=512, height=512, spp=32))
    got = np.load(NPZ)
    assert sorted(got.keys()) == sorted(ref.keys())
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_scene_roundtrip_builds_same_objects():
    jsc = make_cbox(width=16, height=8, spp=2)
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    assert (sc.opts.width, sc.opts.height, sc.opts.spp) == (16, 8, 2)
    assert sc.num_meshes == jsc.num_meshes and sc.bsdf_ids == jsc.bsdf_ids
    assert [m.emitter_id for m in sc.meshes] == [m.emitter_id
                                                 for m in jsc.meshes]
    assert [m.bsdf_id for m in sc.meshes] == [m.bsdf_id for m in jsc.meshes]
    assert set(sc.param_map) == set(jsc.param_map)
    assert sc.device == CPU


def test_out_of_scope_scenes_raise():
    """A two-sided cbox renders through the general Li and trains
    through the attached general Li (it raised before the attached
    general Li was ported), and a 300-face extra mesh configures
    (Morton-ordered); a textured BSDF still raises. With no card, the
    entry points' default device raises instead of falling back."""
    jsc = make_cbox(width=8, height=8, spp=1)
    arrays = pt.scene_to_arrays(jsc)
    sc = pt.Scene.from_arrays(arrays, device=CPU)
    sc.bsdfs[1].twoSide = True
    assert not mk.applicable(sc.configure())
    img = pt.PathTracer(1).renderC(sc)
    assert img.shape == (64, 3) and bool(torch.isfinite(img).all())
    alb = sc.bsdfs[1].reflectance.clone()

    def apply(p):
        sc.bsdfs[1].reflectance = p["alb"]

    loss, grads, img1 = pt.PathTracer(1).loss_and_grad(
        sc, {"alb": alb}, apply, lambda rows, pix: rows.sum(-1))
    assert bool(torch.isfinite(loss)) and img1.shape == (64, 3)
    assert float(grads["alb"].abs().sum()) > 0
    big = pt.Scene.from_arrays(arrays, device=CPU)
    extra = pt.Mesh().load_raw(np.random.default_rng(0).random((900, 3)),
                               np.arange(900).reshape(300, 3))
    big.add_Mesh(extra, None, "white")
    sd = big.configure()
    assert sd.tri.p0.shape[0] == 332 and big._tri_perm.shape == (332,)
    assert sorted(big._tri_perm.tolist()) == list(range(332))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pt.Scene.from_arrays(arrays)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            pt.params_to_torch({"x": np.zeros(3)})
    with pytest.raises(NotImplementedError, match="only constant"):
        jsc.bsdfs[0].reflectance = jsc.bsdfs[0].reflectance.from_array(
            np.ones((2, 2, 3), np.float32))
        pt.scene_to_arrays(jsc)


def test_sensor_data(pair):
    jd, td = pair
    js, ts = jd.sensors[0], td.sensors[0]
    for name in ("sample_to_camera", "to_world", "world_to_sample",
                 "camera_pos", "camera_dir", "inv_area"):
        np.testing.assert_allclose(_np(getattr(ts, name)),
                                   _np(getattr(js, name)), rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    assert (ts.width, ts.height) == (js.width, js.height)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_distribution_sample_reuse(n):
    """Dense sample_reuse against the JAX package's, on random masses
    (including a zero mass) and uniforms up to and including 1."""
    from psdr_jit_tpu.core.distribution import DiscreteDistribution as JD
    from psdr_jit_tpu_torch.core.distribution import DiscreteDistribution

    rng = np.random.default_rng(n)
    mass = rng.uniform(0.0, 3.0, n).astype(np.float32)
    mass[n // 2] = 0.0 if n > 2 else mass[n // 2]
    u = np.concatenate([rng.random(5000), [0.0, 1.0]]).astype(np.float32)
    ref = JD.init(jnp.asarray(mass)).sample_reuse(jnp.asarray(u))
    out = DiscreteDistribution.init(torch.from_numpy(mass)).sample_reuse(
        torch.from_numpy(u))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    for r, o in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
