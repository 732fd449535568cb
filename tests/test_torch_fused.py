"""The training step of psdr_jit_tpu_torch (``PathTracer.loss_and_grad``:
the interior term through K2 stash, K3 and K4, the primary-edge term
through K2 pair) against the JAX package's ``loss_and_grad``.

Both packages take the same step on the Cornell box at 16x16, spp 4,
sppe 4, sppse 0, seed 3: the same scene (interop.scene_to_arrays), the same
parameters (interop.params_to_torch), the same pixel loss. The four
parameters are those of the JAX package's tests: a translation of the
light (mesh 0), the tall block's raw vertex offsets (mesh 2), the
reflectance of ``bsdfs[1]`` and the emitter radiance. The JAX side runs
with ``MEGA_MODE`` "off" (its general XLA path) and "interpret" (its
megakernels in the Pallas interpreter), and with the exact f32 edge
adjoint (``SPLAT_TRANSPOSE = "rows"``; its bf16 default is a TPU
bandwidth measure the port does not carry).

Bounds, and why: the two packages generate camera and edge rays that
differ in the last bit (the JAX package's CPU backend contracts the camera
transform into fused multiply-adds), which flips a grazing visibility test
on a few lanes in a thousand. Fed the JAX package's rays, the port matches
"interpret" to 5e-6 in loss, image and every gradient but the vertex
offsets' (1e-4; ``test_loss_and_grad_on_jax_rays_matches_jax``). With its
own rays it stays within loss 2e-4 (measured at most 3.2e-5), image 1e-3
(4.7e-4) and 1e-2 for the translation (7.2e-5), the radiance (1.6e-5) and
the reflectance (9.7e-3) gradients. The vertex-offset gradient lives on
the few lanes that see the block's top face, where one flipped lane moves
it by a percent: the JAX package's own two modes differ by 2.0e-2 on it at
depth 1 (measured), so its bound is 5e-2 (measured at most 3.2e-2).
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

W, SPP, SPPE, SEED = 16, 4, 4, 3
TARGET = np.random.default_rng(0).random((W * W, 3)).astype(np.float32)
LOSS_RTOL, IMG_RTOL = 2e-4, 1e-3
GRAD_RTOL = {"tx": 1e-2, "dv": 5e-2, "alb": 1e-2, "rad": 1e-2}
JAX_RAYS_RTOL = 5e-6


def _jax_step(depth, mode, spp=SPP, sppe=SPPE):
    sc = make_cbox(width=W, height=W, spp=spp, sppe=sppe)
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
    old_mode, old_t = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = mode, "rows"
    try:
        loss, g, img = psdr.PathTracer(depth).loss_and_grad(
            sc, p0, apply,
            lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
            seed=SEED)
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old_mode, old_t
    return (float(loss), {k: np.asarray(v) for k, v in g.items()},
            np.asarray(img), {k: np.asarray(v) for k, v in p0.items()})


def _port_scene(spp=SPP, sppe=SPPE):
    return pt.Scene.from_arrays(pt.scene_to_arrays(
        make_cbox(width=W, height=W, spp=spp, sppe=sppe)), device=CPU)


def _port_step(sc, depth, np_params):
    """The port's step with the JAX package's parameters ``np_params``
    (the target of ``train_setup`` is ``TARGET``)."""
    _, apply, loss_fn = train_setup(sc, seed=0)
    loss, g, img = pt.PathTracer(depth).loss_and_grad(
        sc, pt.params_to_torch(np_params, device=CPU), apply, loss_fn, seed=SEED)
    return float(loss), {k: v.numpy() for k, v in g.items()}, img.numpy()


def _rel(a, b):
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


@pytest.fixture(scope="module")
def jax_ref():
    cache = {}

    def get(depth, mode, **kw):
        key = (depth, mode, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _jax_step(depth, mode, **kw)
        return cache[key]

    return get


MODES_DEPTHS = [(m, d) for m in ("off", "interpret") for d in range(4)]


@pytest.mark.parametrize("mode, depth", MODES_DEPTHS)
def test_loss_and_grad_matches_jax(jax_ref, mode, depth):
    j_loss, j_grads, j_img, p0 = jax_ref(depth, mode)
    loss, grads, img = _port_step(_port_scene(), depth, p0)
    assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss)
    assert img.shape == (W * W, 3) and np.isfinite(img).all()
    assert _rel(img, j_img) < IMG_RTOL
    assert set(grads) == set(j_grads)
    for k, ref in j_grads.items():
        got = grads[k]
        assert got.shape == ref.shape and np.isfinite(got).all(), k
        if not ref.any():
            assert not got.any(), k
            continue
        assert _rel(got, ref) < GRAD_RTOL[k], (k, _rel(got, ref))
    # every parameter gets a gradient once the step has a bounce
    if depth > 0:
        assert all(np.abs(g).sum() > 0 for g in grads.values())


def _feed_jax_rays(monkeypatch):
    """Make the port trace the JAX package's camera and edge rays: each
    ray the port builds takes the JAX package's value for the same sample,
    and keeps the port's autograd graph (the camera pose carries no
    parameter here, so that graph adds nothing)."""
    jsc = make_cbox(width=W, height=W, spp=SPP, sppe=SPPE)
    jsc.configure()
    jsensor = jax.lax.stop_gradient(jsc.data).sensors[0]
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


@pytest.mark.parametrize("depth", range(4))
def test_loss_and_grad_on_jax_rays_matches_jax(jax_ref, monkeypatch, depth):
    """Fed the JAX package's rays, the port takes the step of the JAX
    package's megakernels ("interpret") to what the two packages' rounding
    of the scene compile leaves: measured at most 1.2e-7 in loss and
    image, 5.8e-7 in the translation, reflectance and radiance gradients,
    and 1.3e-5 in the vertex offsets, whose few top-face lanes magnify
    the last bits of the block's compiled vertices."""
    j_loss, j_grads, j_img, p0 = jax_ref(depth, "interpret")
    _feed_jax_rays(monkeypatch)
    loss, grads, img = _port_step(_port_scene(), depth, p0)
    assert abs(loss - j_loss) <= JAX_RAYS_RTOL * abs(j_loss)
    assert _rel(img, j_img) < JAX_RAYS_RTOL
    for k, ref in j_grads.items():
        assert grads[k].shape == ref.shape, k
        if not ref.any():
            assert not grads[k].any(), k
            continue
        bound = 1e-4 if k == "dv" else JAX_RAYS_RTOL
        assert _rel(grads[k], ref) < bound, (k, _rel(grads[k], ref))


def test_edges_only_matches_jax(jax_ref):
    """spp 0: the image is zero, the loss is that of a zero image, and the
    geometry gradients come from the primary edges alone."""
    j_loss, j_grads, j_img, p0 = jax_ref(2, "off", spp=0)
    loss, grads, img = _port_step(_port_scene(spp=0), 2, p0)
    assert not img.any() and not j_img.any()
    assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss)
    for k in ("alb", "rad"):
        assert not grads[k].any() and not j_grads[k].any(), k
    for k in ("tx", "dv"):
        assert np.abs(j_grads[k]).sum() > 0, k
        assert _rel(grads[k], j_grads[k]) < GRAD_RTOL[k], (
            k, _rel(grads[k], j_grads[k]))


def test_chunk_size_invariance(monkeypatch):
    """The step's result does not depend on how its passes are chunked:
    the image bit for bit, the loss and gradients up to the order of their
    sums."""
    p0 = {"tx": np.float32(0.0),
          "dv": np.zeros((_port_scene().meshes[2].vertex_positions_raw
                          .shape[0], 3), np.float32),
          "alb": np.float32([0.7, 0.7, 0.7]),
          "rad": np.float32([40.0, 40.0, 40.0])}
    ref = _port_step(_port_scene(), 2, p0)
    monkeypatch.setattr(tbase, "TRAIN_CHUNK_LANES", 200)
    out = _port_step(_port_scene(), 2, p0)
    np.testing.assert_array_equal(out[2], ref[2])
    assert abs(out[0] - ref[0]) <= 1e-6 * abs(ref[0])
    for k in ref[1]:
        np.testing.assert_allclose(out[1][k], ref[1][k], rtol=1e-5,
                                   atol=1e-6 * np.abs(ref[1][k]).max(),
                                   err_msg=k)


def test_step_leaves_the_scene_detached():
    """After the step the scene objects hold the parameters' values with
    no autograd graph, so the next step or a render starts clean."""
    sc = _port_scene()
    p = {"alb": torch.tensor([0.2, 0.3, 0.4]),
         "rad": torch.tensor([10.0, 20.0, 30.0])}

    def apply(q):
        sc.bsdfs[1].reflectance.data = q["alb"].reshape(1, 1, 3)
        sc.emitters[0].radiance = q["rad"]

    loss, grads, _ = pt.PathTracer(1).loss_and_grad(
        sc, p, apply, lambda rows, pix: rows.sum(-1))
    assert set(grads) == {"alb", "rad"} and torch.isfinite(loss)
    assert not sc.bsdfs[1].reflectance.data.requires_grad
    assert torch.equal(sc.emitters[0].radiance, p["rad"])
    assert not p["rad"].requires_grad


def test_unported_terms_and_scenes_raise():
    """The step never drops a term. The secondary-edge term (sppse > 0)
    runs: it moves the block's vertex-offset gradient and leaves the loss
    and image as they are. A scene outside the attached shade's scope (a
    two-sided material), which raised NotImplementedError before the
    attached general Li was ported, trains through it: its loss is the
    sum of its image, and its image renderC's up to the two
    formulations' rounding."""
    integ = pt.PathTracer(2)
    p0 = {"tx": np.float32(0.0), "dv": np.zeros((20, 3), np.float32),
          "alb": np.float32([0.7, 0.7, 0.7]),
          "rad": np.float32([20.0, 20.0, 8.0])}
    ref = _port_step(_port_scene(), 2, p0)
    sc = _port_scene()
    sc.opts.sppse = 4
    loss, grads, img = _port_step(sc, 2, p0)
    assert loss == ref[0]
    np.testing.assert_array_equal(img, ref[2])
    assert np.isfinite(grads["dv"]).all()
    assert _rel(grads["dv"], ref[1]["dv"]) > 0.05
    sc = _port_scene()
    sc.bsdfs[1].twoSide = True
    loss, grads, img = integ.loss_and_grad(sc, {}, lambda p: None,
                                           lambda rows, pix: rows.sum(-1),
                                           seed=SEED)
    assert grads == {} and abs(float(loss) - float(img.sum())) <= 1e-5 * abs(
        float(loss))
    assert _rel(img.numpy(), integ.renderC(sc, seed=SEED).numpy()) < 5e-3
