"""The intrinsic form of psdr_jit_tpu_torch's ``PerspectiveCamera``
(``from_intrinsic(fx, fy, cx, cy)`` and the six-float constructor) against
the JAX package's, on the Cornell box at 16x16 with a camera of
non-square pixels and an off-centre principal point.

- The camera compile's matrices agree to rtol 1e-5 (the two backends
  invert the camera matrix in different orders; measured ≤ 3e-7).
- ``interop`` carries the intrinsics both ways.
- ``renderC`` agrees within the bound of ``tests/test_torch_render.py``
  (relative L1 below 5e-3, fewer than 10% of pixels off by 1e-3).
- One ``loss_and_grad`` step (spp 4, sppe 4, depth 1, the four parameters
  of ``chip_smoke.train_setup``) agrees with the JAX package's, whose
  gradients come from ``jax.vjp`` (its megakernels in the Pallas
  interpreter), within the bounds of ``tests/test_torch_fused.py``'s step
  on the JAX package's rays: the port traces the JAX camera and edge rays
  (``_feed_jax_rays``), 5e-6 in loss, image and gradients, 1e-4 in the
  vertex offsets (measured: loss equal, image 7.4e-8, gradients at most
  8.6e-8, vertex offsets 2.4e-6). On its own rays, which differ from the JAX package's in
  the last bit, five of the 256 pixels see a grazing test flip (measured:
  image 1.4e-3, reflectance gradient 2.3e-2, loss 6.9e-5 off).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import train_setup
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu.sensor.sensor import sample_primary_edge as j_sample_pe
from psdr_jit_tpu_torch.core.types import Ray
from psdr_jit_tpu_torch.integrator import base as tbase
from psdr_jit_tpu_torch.sensor.sensor import SensorData
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
W, SPP, SPPE, SEED, DEPTH = 16, 4, 4, 3, 1
FX, FY, CX, CY = 1.45, 1.3, 0.47, 0.54
TARGET = np.random.default_rng(0).random((W * W, 3)).astype(np.float32)
JAX_RAYS_RTOL, DV_RTOL = 5e-6, 1e-4


def _jax_scene(form: str, spp=SPP, sppe=0):
    """The box with its camera replaced by the intrinsic one."""
    sc = make_cbox(width=W, height=W, spp=spp, sppe=sppe)
    fov_cam = sc.sensors[0]
    cam = (psdr.PerspectiveCamera.from_intrinsic(FX, FY, CX, CY, 1e-6, 1e7)
           if form == "from_intrinsic"
           else psdr.PerspectiveCamera(FX, FY, CX, CY, 1e-6, 1e7))
    cam.to_world_raw = fov_cam.to_world_raw
    sc.sensors[0] = cam
    sc._rebuild_param_map()
    return sc


def _rel(a, b):
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


@pytest.mark.parametrize("form", ["from_intrinsic", "six"])
def test_camera_compile_and_interop_match_jax(form):
    jsc = _jax_scene(form)
    arrays = pt.scene_to_arrays(jsc)
    np.testing.assert_array_equal(arrays["sensor.0.intrinsic"],
                                  [FX, FY, CX, CY])
    sc = pt.Scene.from_arrays(arrays, device=CPU)
    cam = sc.sensors[0]
    assert cam.use_intrinsic
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (FX, FY, CX, CY)
    assert (cam.near_clip, cam.far_clip) == (1e-6, 1e7)
    mine = (pt.PerspectiveCamera.from_intrinsic(FX, FY, CX, CY, 1e-6, 1e7)
            if form == "from_intrinsic"
            else pt.PerspectiveCamera(FX, FY, CX, CY, 1e-6, 1e7))
    assert vars(mine).keys() == vars(cam).keys()
    again = pt.scene_to_arrays(sc)
    assert sorted(again) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    jsd = jsc.sensors[0].configure_data(W, W)
    sd = cam.configure_data(W, W)
    for name in ("sample_to_camera", "to_world", "world_to_sample",
                 "camera_pos", "camera_dir", "inv_area"):
        np.testing.assert_allclose(getattr(sd, name).numpy(),
                                   np.asarray(getattr(jsd, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    from psdr_jit_tpu.core import transform as jxf
    from psdr_jit_tpu_torch.core import transform as xf
    np.testing.assert_array_equal(
        xf.perspective_intrinsic(FX, FY, CX, CY, 1e-6, 1e7).numpy(),
        np.asarray(jxf.perspective_intrinsic(FX, FY, CX, CY, 1e-6, 1e7)))


@pytest.mark.parametrize("form", ["from_intrinsic", "six"])
def test_renderc_matches_jax(form):
    jsc = _jax_scene(form)
    jsc.configure()
    ref = np.asarray(psdr.PathTracer(2).renderC(jsc, 0, seed=SEED))
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    img = pt.PathTracer(2).renderC(sc, 0, seed=SEED).numpy()
    assert img.shape == (W * W, 3) and np.isfinite(img).all()
    assert _rel(img, ref) < 5e-3
    assert (np.abs(img - ref).max(-1) > 1e-3).mean() < 0.1
    # the intrinsic camera sees another frame than the box's fov-39 one
    fov = pt.PathTracer(2).renderC(pt.Scene.from_arrays(pt.scene_to_arrays(
        make_cbox(width=W, height=W, spp=SPP)), device=CPU), 0, seed=SEED)
    assert _rel(img, fov.numpy()) > 0.05


def _jax_step():
    sc = _jax_scene("from_intrinsic", sppe=SPPE)
    sc.configure()
    arrays = pt.scene_to_arrays(sc)
    jsensor = jax.lax.stop_gradient(sc.data).sensors[0]
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
    old_mode, old_t = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "interpret", "rows"
    try:
        loss, g, img = psdr.PathTracer(DEPTH).loss_and_grad(
            sc, p0, apply,
            lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
            seed=SEED)
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old_mode, old_t
    return (arrays, jsensor, float(loss),
            {k: np.asarray(v) for k, v in g.items()}, np.asarray(img),
            {k: np.asarray(v) for k, v in p0.items()})


def _feed_jax_rays(monkeypatch, jsensor):
    """The port traces the JAX package's camera and primary-edge rays
    (``tests/test_torch_fused.py``'s helper, for the camera ``jsensor``)."""
    port_ray = SensorData.sample_primary_ray
    port_edge = tbase.sample_primary_edge

    def t(x):
        return torch.from_numpy(np.array(x))

    def camera(self, samples, diff=True):
        ray = port_ray(self, samples, diff)
        j = jsensor.sample_primary_ray(jnp.asarray(samples.detach().numpy()))
        return Ray(t(j.o) + (ray.o - ray.o.detach()),
                   t(j.d) + (ray.d - ray.d.detach()))

    def edge(sensor, sample1, u_coin=None):
        es = port_edge(sensor, sample1, u_coin)
        j = j_sample_pe(jsensor, jnp.asarray(sample1.numpy()),
                        None if u_coin is None else jnp.asarray(
                            u_coin.numpy()))
        return dataclasses.replace(es, ray_n=Ray(t(j.ray_n.o), t(j.ray_n.d)),
                                   ray_p=Ray(t(j.ray_p.o), t(j.ray_p.d)))

    monkeypatch.setattr(SensorData, "sample_primary_ray", camera)
    monkeypatch.setattr(tbase, "sample_primary_edge", edge)


def test_loss_and_grad_matches_jax(monkeypatch):
    arrays, jsensor, j_loss, j_grads, j_img, p0 = _jax_step()
    sc = pt.Scene.from_arrays(arrays, device=CPU)
    assert sc.sensors[0].use_intrinsic
    _, apply, loss_fn = train_setup(sc, seed=0)
    _feed_jax_rays(monkeypatch, jsensor)
    loss, grads, img = pt.PathTracer(DEPTH).loss_and_grad(
        sc, pt.params_to_torch(p0, device=CPU), apply, loss_fn, seed=SEED)
    loss, img = float(loss), img.numpy()
    assert abs(loss - j_loss) <= JAX_RAYS_RTOL * abs(j_loss)
    assert img.shape == (W * W, 3) and np.isfinite(img).all()
    assert _rel(img, j_img) < JAX_RAYS_RTOL
    assert set(grads) == set(j_grads)
    for k, ref in j_grads.items():
        got = grads[k].numpy()
        assert got.shape == ref.shape and np.isfinite(got).all(), k
        assert np.abs(ref).sum() > 0, k
        bound = DV_RTOL if k == "dv" else JAX_RAYS_RTOL
        assert _rel(got, ref) < bound, (k, _rel(got, ref))
