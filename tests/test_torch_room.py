"""BASELINE config #5's room (``tests/scenes.py make_room``: 14 meshes, 108
triangles, diffuse, Microfacet and rough-conductor materials, every edge
on) through psdr_jit_tpu_torch against the JAX package, on the CPU:
``chip_smoke.room_arrays`` against ``scene_to_arrays(make_room(...))``,
a frame, and one training step at 16x16, spp, sppe and sppse 2,
``PathTracer(1)``, with ``tests/test_room.py``'s three parameters (the
brass block's pose ``tx``, the prism's vertex offsets ``dv``, the light's
radiance ``dr``) against the JAX package's single-device
``jax.value_and_grad`` of renderD (``test_room.py:66-72``); and the port's
renderD pulled back against its own step.

Both packages draw the same samples (``pcg4d``), so the comparisons are
lane for lane. The JAX side runs with ``MEGA_MODE`` "off" and the exact f32
edge adjoint (``SPLAT_TRANSPOSE = "rows"``); its frame and step are
computed once (``jax_room``). Each bound is stated beside its measured
value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import ROOM_BRASS, ROOM_PRISM, room_arrays, room_setup
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from scenes import make_room
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
W, SPP, DEPTH, SEED = 16, 2, 1, 11


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


@pytest.fixture(scope="module")
def jax_room():
    """The JAX package's frame (``PathTracer(1).renderC``, seed 11), the
    target (the frame x 0.9, as ``test_room.py`` makes it) and the loss and
    gradients of ``sum((renderD - target)^2)`` at the three parameters'
    zero, as numpy."""
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    sc = make_room(width=W, height=W, spp=SPP, sppe=SPP, sppse=SPP)
    sc.configure()
    integ = psdr.PathTracer(DEPTH)
    brass, prism, em = sc.meshes[ROOM_BRASS], sc.meshes[ROOM_PRISM], \
        sc.emitters[0]
    base_raw, base_v, base_r = (brass.to_world_raw,
                                prism.vertex_positions_raw, em.radiance)
    try:
        frame = np.asarray(integ.renderC(sc, 0, seed=SEED))
        target = frame * np.float32(0.9)

        def loss_fn(p):
            brass.to_world_raw = base_raw.at[0, 3].add(p["tx"])
            prism.vertex_positions_raw = base_v + p["dv"]
            em.radiance = base_r + p["dr"]
            img = integ.renderD(sc, 0, seed=SEED)
            return jnp.sum(jnp.square(img - target))

        loss, grads = jax.value_and_grad(loss_fn)(
            {"tx": jnp.float32(0.0), "dv": jnp.zeros_like(base_v),
             "dr": jnp.zeros_like(base_r)})
    finally:
        brass.to_world_raw, prism.vertex_positions_raw, em.radiance = (
            base_raw, base_v, base_r)
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
    return dict(frame=frame, target=target, loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})


def _port_scene():
    sc = pt.Scene.from_arrays(room_arrays(W, W, SPP, SPP, SPP), device=CPU)
    sc.configure()
    return sc


def test_room_arrays_match_jax():
    """``chip_smoke.room_arrays`` is ``scene_to_arrays(make_room(...))``, key
    by key and bit for bit, with 14 meshes and 108 triangles."""
    want = pt.scene_to_arrays(make_room(W, W, SPP, SPP, SPP))
    got = room_arrays(W, W, SPP, SPP, SPP)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert int(got["counts"][0]) == 14
    assert sum(got[f"mesh.{i}.face_indices"].shape[0]
               for i in range(14)) == 108


def test_room_frame_matches_jax(jax_room):
    """renderC of the room at 16x16, spp 2, ``PathTracer(1)``, seed 11:
    measured rel L1 4.8e-8 (bound 1e-5), lit, the light panel in view."""
    img = pt.PathTracer(DEPTH).renderC(_port_scene(), 0, seed=SEED).numpy()
    ref = jax_room["frame"]
    assert np.isfinite(img).all() and img.max() > 1.0
    assert _rel(img, ref) < 1e-5


@pytest.fixture(scope="module")
def port_step(jax_room):
    sc = _port_scene()
    p0, apply = room_setup(sc)
    tgt = torch.from_numpy(jax_room["target"])
    loss, grads, img = pt.PathTracer(DEPTH).loss_and_grad(
        sc, p0, apply, lambda rows, pix: ((rows - tgt[pix]) ** 2).sum(-1),
        seed=SEED)
    return sc, float(loss), {k: v.numpy() for k, v in grads.items()}


def test_room_step_matches_jax(jax_room, port_step):
    """One training step with all three estimators and gradients to the
    brass block's pose, the prism's vertex offsets and the light's
    radiance, against ``jax.value_and_grad`` of the JAX package's renderD:
    measured rel loss 6.7e-8 (bound 1e-4), tx 3.3e-6 and dr 0 (bound
    1e-3), dv 3.2e-5 rel L1 (bound 0.15, the secondary-edge term's bound
    for grazing receiver rays, ``test_torch_secondary_edges.py``). Every
    parameter gets a gradient."""
    _, loss, grads = port_step
    assert abs(loss - jax_room["loss"]) / abs(jax_room["loss"]) < 1e-4
    bounds = {"tx": 1e-3, "dr": 1e-3, "dv": 0.15}
    for k, want in jax_room["grads"].items():
        assert grads[k].shape == want.shape, k
        assert np.abs(want).sum() > 0, k
        assert _rel(grads[k], want) < bounds[k], k


def test_room_renderD_matches_step(jax_room, port_step):
    """renderD of the room pulled back in reverse mode (the same loss by
    autograd) against the port's fused step: measured rel loss and
    gradients 0, bit for bit (bound 1e-4)."""
    sc, loss, grads = port_step
    p0, apply = room_setup(sc)
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    apply(p)
    img = pt.PathTracer(DEPTH).renderD(sc, 0, seed=SEED)
    l_d = ((img - torch.from_numpy(jax_room["target"])) ** 2).sum()
    g_d = torch.autograd.grad(l_d, list(p.values()))
    apply(p0)
    assert abs(float(l_d.detach()) - loss) / abs(loss) < 1e-4
    for k, g in zip(p, g_d):
        assert _rel(g.numpy(), grads[k]) < 1e-4, k
