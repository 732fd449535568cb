"""``tests/crosscheck.py``'s contract between psdr_jit_tpu_torch and the
JAX package, on the CPU: one deterministic small-box training step with
all three estimators (48x48, depth 2, spp = sppe = sppse = 4, seed 5;
gradients to the last mesh's raw vertices and to the radiance), computed
by the JAX package (``crosscheck.compute()``, its general path) and by
the port (its own route: the megakernels' plain versions), then held by
``crosscheck.compare`` to the gates of ``tests/test_tpu_smoke.py:110-111``:
loss < 5e-3, image < 1e-2, gradients < 0.05 (relative; the measured
values stand in the test).
"""

import numpy as np
import torch

import crosscheck
import psdr_jit_tpu_torch as pt
from scenes import make_cbox

CPU = torch.device("cpu")  # the entry points default to the card


def _port_compute():
    """``crosscheck.compute()``'s step through the port on the CPU:
    ``(loss, [dv, dr], image)``."""
    w = crosscheck.WIDTH
    s = crosscheck.SPP
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(make_cbox(
        width=w, height=w, spp=s, sppe=crosscheck.SPPE,
        sppse=crosscheck.SPPSE)), device=CPU)
    mesh, em = sc.meshes[-1], sc.emitters[0]
    bv, br = mesh.vertex_positions_raw.clone(), em.radiance.clone()
    target = torch.from_numpy(np.random.default_rng(0).random(
        (w * w, 3)).astype(np.float32))

    def apply(p):
        mesh.vertex_positions_raw = bv + p["dv"]
        em.radiance = br + p["dr"]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loss, g, img = pt.PathTracer(crosscheck.DEPTH).loss_and_grad(
            sc, {"dv": torch.zeros_like(bv), "dr": torch.zeros_like(br)},
            apply, lambda rows, pix: ((rows - target[pix]) ** 2).sum(-1),
            seed=crosscheck.SEED)
    finally:
        torch.set_num_threads(n)
    return float(loss), [g["dv"].numpy(), g["dr"].numpy()], img.numpy()


def test_crosscheck_contract():
    """``crosscheck.compare`` (reference first): measured loss 7.8e-6,
    image 5.7e-4, gradients 1.2e-2 (gates 5e-3, 1e-2, 0.05: the two
    packages draw the same samples, but their camera and edge rays differ
    in the last bit, XLA's CPU compiler contracting multiply-adds, which
    flips a few grazing lanes), every value finite."""
    ref = crosscheck.compute()
    out = _port_compute()
    rel = crosscheck.compare(ref, out)
    assert [g.shape for g in out[1]] == [g.shape for g in ref[1]]
    assert rel["finite"] and rel["loss"] < 5e-3 and rel["img"] < 1e-2 \
        and rel["grad"] < 0.05, rel
