"""Pixel-sharded rendering over the ranks of a ``torch.distributed``
process group (counterpart of ``psdr_jit_tpu/parallel/mesh.py``).

Each rank renders its contiguous block of the pixels with the global
sample index (``integrator/base.py interior_lane_setup``), so any
partition of the pixels reproduces the full frame's samples exactly; each
edge pass splats only the rank's window of the global edge-sample lanes.
The ranks exchange sums only (``all_reduce``, and ``broadcast`` for the
guiding table): a rank's rows go into a zero-filled full frame, which is
summed across the ranks, so gloo carries the collectives on CPU tensors
and on CUDA ones (two ranks on one card), NCCL across cards.

The caller initialises ``torch.distributed`` (``init_process_group`` with
its address, world size and rank), as the JAX package's caller calls
``jax.distributed.initialize``; nothing here starts a group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..integrator.base import pixel_block, sum_across_ranks
from ..scene.scene import _checked_device


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The ranks a render or a training step is sharded over."""

    group: object          # torch.distributed group; None: the default one
    rank: int              # this process's rank in ``group``
    size: int              # the number of ranks in ``group``
    device: torch.device   # the device this rank renders on


def make_device_mesh(device="cuda", group=None) -> ProcessMesh:
    """This rank's :class:`ProcessMesh` over ``group`` (the default group
    when None), rendering on ``device`` (the current card unless told
    otherwise; ``"cpu"`` for CPU ranks). Raises where ``torch.distributed``
    is not initialised, or no card is visible for a CUDA device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("torch.distributed is not initialised: call "
                           "torch.distributed.init_process_group first")
    return ProcessMesh(group=group, rank=dist.get_rank(group),
                       size=dist.get_world_size(group),
                       device=_checked_device(device))


def render_sharded(integrator, scene, mesh: ProcessMesh, sensor_id: int = 0,
                   seed: int = 0, kind: str = "C"):
    """The full ``(n_pix, 3)`` frame on every rank, each rank rendering its
    pixel block: ``renderC`` (``kind`` "C") or ``renderD`` ("D": the edge
    passes split into lane windows and summed across the ranks, and the
    frame attached to the scene's parameters in both modes, its
    derivative summed across the ranks too). Every rank must call it with
    the same arguments. The frame's interior rows are the unsharded
    render's bit for bit."""
    from .shard import sync_guiding

    if kind not in ("C", "D"):
        raise ValueError(f"kind {kind!r}: 'C' or 'D'")
    if scene.device.type != mesh.device.type:
        raise ValueError(f"the scene is on {scene.device}, the mesh's rank "
                         f"on {mesh.device}")
    n_pix = scene.opts.num_pixels
    pix = pixel_block(n_pix, mesh, scene.device)
    if kind == "C":
        rows = integrator.renderC(scene, sensor_id, seed, pix_id=pix)
    else:
        sync_guiding(integrator, mesh, sensor_id)
        seed, _ = integrator._norm_args(scene, seed, None, None)
        rows = integrator.render_impl_sharded(
            scene.configure_data(scene._active_sensors), scene.opts, sensor_id, seed, pix, mesh)
    lo, hi = int(pix[0]), int(pix[-1]) + 1
    full = torch.cat([rows.new_zeros((lo, 3)), rows,
                      rows.new_zeros((n_pix - hi, 3))])
    return sum_across_ranks(full, mesh.group)
