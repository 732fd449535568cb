"""The pixel-sharded training step (counterpart of
``psdr_jit_tpu/parallel/shard.py``): each rank renders its pixel block and
its window of the edge-sample lanes, and the loss and the parameters'
gradients are summed across the ranks (``all_reduce``). The scene is
small and every rank holds all of it; so does the secondary-edge guiding
table, which :func:`sync_guiding` makes the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..integrator.base import pixel_block, sum_each_across_ranks
from ..scene.scene import tree_map
from .mesh import ProcessMesh


def _src(mesh: ProcessMesh) -> int:
    """The global rank of the mesh's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def sync_guiding(integrator, mesh: ProcessMesh, sensor_id: int = 0):
    """Make the secondary-edge guiding table of ``sensor_id`` the same on
    every rank: rank 0's, broadcast into the others' tables of the same
    shapes (each rank builds its own with ``preprocess_secondary_edges``
    first; on the card the build's float atomics may round differently
    from rank to rank). Returns the table, or None where no rank has one;
    raises where only some have one."""
    table = getattr(integrator, "warpper", {}).get(sensor_id)
    flag = torch.tensor([float(table is not None)], device=mesh.device)
    dist.all_reduce(flag, group=mesh.group)
    if float(flag) == 0.0:
        return None
    if float(flag) != mesh.size:
        raise ValueError(f"a guiding table for sensor {sensor_id} on "
                         f"{int(flag)} of {mesh.size} ranks")

    def bcast(t):
        t = t.clone()
        dist.broadcast(t, _src(mesh), group=mesh.group)
        return t

    table = tree_map(bcast, table)
    integrator.warpper[sensor_id] = table
    return table


def make_sharded_value_and_grad(loss_fn, mesh: ProcessMesh):
    """``f(params, pix, target) -> (loss, grads)`` over the ranks of
    ``mesh``: each rank calls ``loss_fn(params, pix_block, target_block)``
    on its contiguous block of ``pix`` and of ``target``'s rows, which must
    return the SUM of its pixels' losses; the losses and the gradients
    (``params`` a dict of tensors; ``grads`` its keys) are summed across
    the ranks."""

    def f(params, pix, target):
        block = pixel_block(pix.shape[0], mesh, pix.device)
        p = {k: torch.as_tensor(v).detach().requires_grad_()
             for k, v in params.items()}
        loss = loss_fn(p, pix[block], target[block])
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = dict(zip(p, sum_each_across_ranks(
            [g if g is not None else torch.zeros_like(v)
             for g, v in zip(grads, p.values())], mesh.group)))
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.group)
        return loss, grads

    return f


def make_fused_train_step(scene, integrator, mesh: ProcessMesh, apply_params,
                          pixel_loss, sensor_id: int = 0):
    """``step(params, seed=-1) -> (loss, grads, image)``: the training step
    of ``integrator.loss_and_grad`` (one forward and one adjoint) sharded
    over the ranks of ``mesh``: each rank runs the interior over its pixel
    block and pulls the full-frame loss cotangent back through its window
    of each edge pass's lanes; every rank gets the summed loss, the summed
    gradients and the full image. ``apply_params`` and ``pixel_loss`` as
    for ``loss_and_grad``; the guiding table is rank 0's
    (:func:`sync_guiding`). Every rank must call ``step`` with the same
    arguments."""
    from ..integrator.fused import loss_and_grad

    pixel_block(scene.opts.num_pixels, mesh, "cpu")  # the ranks divide it

    def step(params, seed: int = -1):
        warp = sync_guiding(integrator, mesh, sensor_id)
        return loss_and_grad(integrator, scene, params, apply_params,
                             pixel_loss, sensor_id, seed, warp=warp,
                             mesh=mesh)

    return step


def train_step_example(scene, integrator, mesh: ProcessMesh, param_get,
                       param_set, target, seed: int = 0):
    """One sharded loss and gradient of ``sum((renderD - target)^2)``
    through :func:`make_sharded_value_and_grad`: ``param_get()`` -> a dict
    of parameters, ``param_set(params)`` writes them onto the scene
    objects (afterwards they hold the values, detached). With edge terms
    each rank renders through ``render_impl_sharded``."""
    opts = scene.opts
    seed = int(seed) & 0xFFFFFFFF
    sync_guiding(integrator, mesh, 0)

    def loss_fn(params, pix, target_rows):
        param_set(params)
        sd = scene.configure_data(scene._active_sensors)
        if opts.sppe > 0 or opts.sppse > 0:
            img = integrator.render_impl_sharded(sd, opts, 0, seed, pix,
                                                 mesh)
        else:
            img = integrator._render_interior(sd, opts, 0, seed, pix,
                                              diff=True)
        return torch.square(img - target_rows).sum()

    step = make_sharded_value_and_grad(loss_fn, mesh)
    dev = scene.device
    params = param_get()
    try:
        return step(params,
                    torch.arange(opts.num_pixels, dtype=torch.int64,
                                 device=dev),
                    torch.as_tensor(target, dtype=torch.float32).to(dev))
    finally:
        param_set({k: torch.as_tensor(v).detach() for k, v in params.items()})
