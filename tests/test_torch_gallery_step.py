"""The gallery training step of ``bench.py _time_bvh_grad`` through
psdr_jit_tpu_torch against the JAX package's, on the CPU, at the bench's
smoke size (``PSDR_BENCH_SMOKE``): ``make_gallery`` with 4 spheres at
subdivision 2 (1,292 triangles, so every intersection takes K5's route,
here its plain version), the first sphere's edges on, 64x64, spp = sppe =
sppse = 1, ``PathTracer(1)``, seed 0, gradients to that sphere's raw
vertices and to the light's radiance.

``chip_smoke.gallery_arrays`` (numpy, for the card's machine) builds the
scene; ``chip_smoke.gallery_step_setup`` the parameters and the loss. The
JAX side runs with ``MEGA_MODE`` "off" and the exact f32 edge adjoint
(``SPLAT_TRANSPOSE = "rows"``). Each bound is stated beside its measured
value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import gallery_arrays, gallery_step_setup
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from scenes import make_gallery
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

# bench.py _time_bvh_grad at PSDR_BENCH_SMOKE=1
RES, SPP, DEPTH, N_SPHERES, SUBDIV, EDGE_SPHERES, SEED = 64, 1, 1, 4, 2, 1, 0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_step():
    """``bench.py _time_bvh_grad``'s step at the smoke size."""
    sc = make_gallery(width=RES, height=RES, spp=SPP, sppe=SPP, sppse=SPP,
                      n_spheres=N_SPHERES, subdiv=SUBDIV,
                      edge_spheres=EDGE_SPHERES)
    sc.configure()
    mesh, em = sc.meshes[6], sc.emitters[0]
    bv, br = mesh.vertex_positions_raw, em.radiance
    target = jnp.asarray(np.random.default_rng(0).random((RES * RES, 3)),
                         jnp.float32)

    def apply(p):
        mesh.vertex_positions_raw = bv + p["dv"]
        em.radiance = br + p["dr"]

    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        loss, g, img = psdr.PathTracer(DEPTH).loss_and_grad(
            sc, {"dv": jnp.zeros_like(bv), "dr": jnp.zeros_like(br)}, apply,
            lambda rows, pix: jnp.sum(jnp.square(rows - target[pix]), -1),
            seed=SEED)
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old
        mesh.vertex_positions_raw, em.radiance = bv, br
    return sc, float(loss), {k: np.asarray(v) for k, v in g.items()}, \
        np.asarray(img)


@pytest.fixture(scope="module")
def jax_step():
    return _jax_step()


def _arrays():
    return gallery_arrays(RES, RES, SPP, N_SPHERES, SUBDIV, sppe=SPP,
                          sppse=SPP, edge_spheres=EDGE_SPHERES)


def test_gallery_step_arrays_match_jax(jax_step):
    """``gallery_arrays`` with the step's edge terms and edge sphere equals
    ``scene_to_arrays`` of ``make_gallery(..., edge_spheres=1)``, key by
    key and bit for bit."""
    want = pt.scene_to_arrays(jax_step[0])
    got = _arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gallery_step_matches_jax(jax_step):
    """The step against the JAX package's: measured rel loss 1.2e-7, image
    6.6e-8 (bounds 1e-5), radiance gradient 0 (bound 1e-4), the sphere's
    vertex gradients 2.1e-4 (bound 1e-3: the edge terms' lanes that graze
    the sphere move with the last bits of their hit points)."""
    _, j_loss, j_grads, j_img = jax_step
    sc = pt.Scene.from_arrays(_arrays(), device=CPU)
    sc.configure()
    params, apply, pixel_loss = gallery_step_setup(sc)
    loss, grads, img = pt.PathTracer(DEPTH).loss_and_grad(
        sc, params, apply, pixel_loss, seed=SEED)
    assert np.isfinite(img.numpy()).all() and img.shape == (RES * RES, 3)
    assert abs(float(loss) - j_loss) / abs(j_loss) < 1e-5
    assert _rel(img.numpy(), j_img) < 1e-5
    assert np.abs(j_grads["dv"]).sum() > 0 and np.abs(j_grads["dr"]).sum() > 0
    assert _rel(grads["dr"].numpy(), j_grads["dr"]) < 1e-4
    assert _rel(grads["dv"].numpy(), j_grads["dv"]) < 1e-3
