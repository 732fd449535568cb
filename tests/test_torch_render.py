"""The slice end to end: psdr_jit_tpu_torch's PathTracer.renderC against
the JAX package's renderC (its general XLA path on the CPU) and against
tests/golden_cbox32.npy.

The port renders through the megakernel formulation (secondary rays start
at o + t*d) and the XLA path through the bilinear hit point, so a few
grazing visibility tests flip: the bound is the one tests/test_megakernel.py
accepts between the JAX package's own megakernel and XLA paths (relative L1
below 5e-3, fewer than 10% of pixels off by more than 1e-3).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import psdr_jit_tpu as jpsdr
import psdr_jit_tpu_torch as pt
from psdr_jit_tpu_torch.integrator import base
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_cbox32.npy")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scenes():
    jsc = make_cbox(width=32, height=32, spp=4)
    jsc.configure()
    return jsc, pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)


def _close(img, ref):
    rel = np.abs(img - ref).sum() / np.abs(ref).sum()
    frac = (np.abs(img - ref).max(-1) > 1e-3).mean()
    assert rel < 5e-3, rel
    assert frac < 0.1, frac


@pytest.mark.parametrize("seed", [0, 1])
def test_renderc_matches_jax(scenes, seed):
    jsc, sc = scenes
    ref = np.asarray(jpsdr.PathTracer(2).renderC(jsc, 0, seed=seed))
    img = pt.PathTracer(2).renderC(sc, 0, seed=seed)
    assert img.shape == (32 * 32, 3) and img.dtype == torch.float32
    _close(img.numpy(), ref)


def test_renderc_matches_golden(scenes):
    _, sc = scenes
    img = pt.PathTracer(2).renderC(sc, 0, seed=0).numpy()
    _close(img, np.load(GOLDEN))


@pytest.mark.parametrize("chunk_lanes", [256, 1000])
def test_crop_equals_full_frame_rows(scenes, chunk_lanes, monkeypatch):
    """Any pixel subset, at any chunk size, reproduces the full frame's
    rows bit for bit (lane = pixel * spp + s)."""
    _, sc = scenes
    integ = pt.PathTracer(3)
    full = integ.renderC(sc, 0, seed=7)
    monkeypatch.setattr(base, "CHUNK_LANES", chunk_lanes)
    crop = np.random.default_rng(chunk_lanes).permutation(32 * 32)[:333]
    part = integ.renderC(sc, 0, seed=7, pix_id=crop)
    assert torch.equal(part, full[torch.from_numpy(crop)])
    assert torch.equal(integ.renderC(sc, 0, seed=7), full)


def test_seed_and_batch_pix_conventions(scenes):
    _, sc = scenes
    integ = pt.PathTracer(1)
    sc.seed = 3
    assert torch.equal(integ.renderC(sc, 0, seed=-1),
                       integ.renderC(sc, 0, seed=3))
    rows = np.arange(40, 90)
    assert torch.equal(integ.renderC(sc, 0, seed=2, batch_pix=rows),
                       integ.renderC(sc, 0, seed=2, pix_id=rows))
    sc.seed = 0


def test_later_slices_raise(scenes):
    """renderD and the secondary-edge term of the training step
    (sppse > 0), once left to later slices, no longer raise. At sppe =
    sppse = 0 renderD is the interior term alone, the attached general
    Li: a finite image equal to renderC's (K2's formulation) as the JAX
    package's renderD equals its renderC (tests/test_render.py:116)."""
    _, sc = scenes
    integ = pt.PathTracer(2)
    assert (sc.opts.sppe, sc.opts.sppse) == (0, 0)
    d = integ.renderD(sc, 0, seed=2)
    c = integ.renderC(sc, 0, seed=2)
    assert d.shape == (32 * 32, 3) and bool(torch.isfinite(d).all())
    rel = (d - c).abs() / (c.abs() + 1e-4)
    assert float((rel < 1e-3).float().mean()) > 0.9
    np.testing.assert_allclose(float(d.mean()), float(c.mean()), rtol=1e-2)
    sc.opts.sppse = 1
    try:
        loss, grads, img = integ.loss_and_grad(
            sc, {}, lambda p: None, lambda rows, pix: rows.sum(-1))
        assert bool(torch.isfinite(loss)) and grads == {}
        assert img.shape == (32 * 32, 3)
    finally:
        sc.opts.sppse = 0


def test_port_imports_without_jax():
    code = ("import sys, psdr_jit_tpu_torch, psdr_jit_tpu_torch.ops._cuda; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
