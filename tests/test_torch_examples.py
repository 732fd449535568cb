"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU, small.

``torch_scenes.make_cbox`` and ``make_room`` build, through the port's
public API, the very arrays that ``interop.scene_to_arrays`` reads off
the JAX package's ``tests/scenes.py`` builders (bitwise). Then every
example's ``main()`` runs at 8x8 to 16x16 for one to three iterations,
with its own check where that check holds at that size:

* ``torch_batch_render`` (the crop bitwise the full frame's rows),
  ``torch_checkpointed_optimization`` (the resumed run bitwise the
  straight one on the CPU) and ``torch_sharded_render`` (two gloo ranks,
  the frame bitwise the unsharded one) keep their checks as they are;
* ``torch_fused_training``, ``torch_room_optimization`` and
  ``torch_multihost_training`` assert convergence after 40, 80 and 25
  Adam steps at 32x32 to 64x64, which a few steps at 8x8 cannot reach:
  they run with ``check=False``, and the test holds the direction of
  their first steps (the parameters move from the wrong start toward the
  truth) instead;
* the examples without a check of their own (``torch_field_aovs``,
  ``torch_forward_ad``, ``torch_forward_ad_envmap``,
  ``torch_inverse_albedo``, ``torch_secondary_edge_guiding``) are held to
  what their docstrings state: finite images written, the envmap scene's
  interior term exactly 0 and its edge terms not, the radiance moving
  toward the truth.

The two multi-process examples start two gloo ranks each, at a free local
port, each rank under a timeout, on one torch thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

import psdr_jit_tpu_torch as pt
from scenes import make_cbox, make_room
from torch_threads import _one_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import torch_scenes  # noqa: E402

RANK_TIMEOUT = 300  # seconds a rank may take before it is killed


@pytest.mark.parametrize("kind", ["cbox", "room"])
def test_scenes_match_jax_builders(kind):
    """``torch_scenes``' builders against ``tests/scenes.py``'s, array for
    array through ``interop.scene_to_arrays``: equal, dtypes included."""
    jax_make, port_make = {"cbox": (make_cbox, torch_scenes.make_cbox),
                           "room": (make_room, torch_scenes.make_room)}[kind]
    ref = pt.scene_to_arrays(jax_make(16, 12, 3, 2, 1))
    out = pt.scene_to_arrays(port_make(16, 12, 3, 2, 1, device="cpu"))
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_batch_render():
    import torch_batch_render

    assert torch_batch_render.main(device="cpu", size=16)


def test_field_aovs(tmp_path):
    import torch_field_aovs

    ranges = torch_field_aovs.main(str(tmp_path), device="cpu", size=16)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"aov_{f}.ppm" for f in torch_field_aovs.FIELDS)
    assert ranges["depth"][1] > 500.0  # the back wall, ~1,360 away
    assert ranges["segmentation"][1] == 7.0  # the last of meshes 1-7
    assert ranges["silhouette"][1] == 1.0


def test_forward_ad(tmp_path):
    import torch_forward_ad

    dimg = torch_forward_ad.main(str(tmp_path), device="cpu", size=16,
                                 spp=2)
    assert dimg.shape == (16, 16, 3) and np.isfinite(dimg).all()
    assert np.abs(dimg).sum() > 0
    assert {p.name for p in tmp_path.iterdir()} == {
        "cbox.ppm", "cbox_grad.npy", "cbox_grad.ppm"}


def test_forward_ad_envmap():
    """The docstring's claim: the interior term is exactly 0, the two edge
    terms are not."""
    import torch_forward_ad_envmap

    imgs = torch_forward_ad_envmap.main(device="cpu", size=16, n=2)
    assert not np.abs(imgs["interior"]).any()
    assert np.abs(imgs["primary-edge"]).sum() > 0
    assert np.abs(imgs["secondary-edge"]).sum() > 0


def test_inverse_albedo():
    """Two Adam steps from 0.3x the albedo and 3x the radiance: the too
    bright image pulls the radiance toward the truth (the albedo falls
    with it at first), and the scene gets its true values back."""
    import torch_inverse_albedo

    alb, rad, losses = torch_inverse_albedo.main(device="cpu", size=8,
                                                 iters=2)
    assert np.isfinite(losses).all() and bool(torch.isfinite(alb).all())
    assert bool((rad < 3.0 * torch.tensor([20.0, 20.0, 8.0])).all())
    sc_alb = torch_inverse_albedo.make_cbox(device="cpu").param_map[
        "BSDF[id=white]"].reflectance.data
    assert sc_alb.flatten().tolist() == pytest.approx([0.95] * 3)


def test_secondary_edge_guiding():
    import torch_secondary_edge_guiding

    grads = torch_secondary_edge_guiding.main(device="cpu", size=16, spp=2,
                                              reso=(4, 2, 2, 2), seeds=2)
    assert len(grads) == 2 and np.isfinite(grads).all()
    assert all(g != 0.0 for g in grads)


def test_fused_training():
    """Two steps (the asserts want 40 at 32x32): the wall's shift and the
    radiance's error shrink from their starts (40 and 0.8 x 20)."""
    import torch_fused_training

    dx, rad_err = torch_fused_training.main(device="cpu", size=8, iters=2,
                                            check=False)
    assert abs(dx) < 40.0 and rad_err < 0.8 * 20.0


def test_checkpointed_optimization():
    """The example's own check: on the CPU the resumed run is bitwise the
    straight one."""
    import torch_checkpointed_optimization

    bitwise, close = torch_checkpointed_optimization.main(
        device="cpu", size=8, iters=3, resume_at=2)
    assert bitwise and close


def test_room_optimization():
    """Two steps (the asserts want 80 at 64x64): the light's gain moves
    from 0 toward its truth, -0.3."""
    import torch_room_optimization

    tx, gain = torch_room_optimization.main(device="cpu", size=8, spp=1,
                                            iters=2, check=False)
    assert np.isfinite(tx) and -0.3 < gain < 0.0


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Rank processes on one torch thread each (beside the other pytest
    workers)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_sharded_render(one_thread_ranks):
    """Two gloo ranks: rank 0 asserts the sharded frame bitwise the
    unsharded one."""
    import torch_sharded_render

    assert torch_sharded_render.main(device="cpu", size=16,
                                     timeout=RANK_TIMEOUT)


def test_multihost_training(one_thread_ranks):
    """Two gloo ranks take two sharded steps (the assert wants 25 at
    32x32)."""
    import torch_multihost_training

    assert torch_multihost_training.main(device="cpu", size=8, iters=2,
                                         check=False, timeout=RANK_TIMEOUT)
