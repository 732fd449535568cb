"""The training step: loss, parameter gradients and image in one forward
and one adjoint (counterpart of ``psdr_jit_tpu/integrator/fused.py``).

For a pixel-local loss each interior chunk owns its pixels, so the loss
cotangent of a chunk comes from that chunk's own rows. The step:

1. builds the scene data from the parameters once, on the CPU (the scene
   compile, ``Scene.configure_data``), and makes detached leaves of its
   float tensors that carry gradients;
2. per interior chunk: runs the attached forward (K2 stash and K3 on the
   megakernels' scene class, the attached general Li on any other), takes
   the loss and its cotangent ``g``, and calls ``backward(g)`` into the
   leaves (K4 on that class), holding one chunk's graph at a time;
3. pulls the full-frame ``g`` through the derivative-only primary-edge pass
   (K2 pair) and the derivative-only secondary-edge pass (``sppse > 0``:
   its visibility, receiver and camera rays through the closest hit, K1
   on the Cornell box), chunk by chunk, into the same leaves;
4. pushes the leaves' gradients back through the scene compile once, to
   the parameters.

The step is the entry span ``step`` (``utils.profiling``); its parts are
the spans ``compile`` (1), ``interior`` (2, with ``interior.pullback``),
``primary_edge`` and ``secondary_edge`` (3, each with its ``pullback``)
and ``compile.pullback`` (4).

Steps 1 and 4 are the JAX package's ``vjp(to_sd)`` / ``pull_cfg(sd_bar)``
(fused.py:288-305).

Sharded over the pixels of several ranks (:func:`fused_loss_grad_sharded`,
``parallel.shard.make_fused_train_step``), each rank runs step 2 over its
contiguous pixel block, builds the full-frame cotangent from every rank's
rows, runs step 3 over its window of each edge pass's lanes, and the loss
and the leaves' gradients are summed across the ranks before step 4.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import base as _base
from .base import (interior_chunk, pad_pixel_chunks, pixel_block,
                   shard_lane_window, sum_each_across_ranks)
from ..scene.scene import tree_map
from ..utils import profiling


def _leaves(sd):
    """``(sd_leaf, originals, leaves)``: ``sd`` with each float tensor that
    carries a gradient replaced by a detached leaf, once per tensor."""
    originals, leaves = [], {}

    def leaf(t):
        if not t.requires_grad:
            return t
        if id(t) not in leaves:
            leaves[id(t)] = t.detach().requires_grad_()
            originals.append(t)
        return leaves[id(t)]

    sd_leaf = tree_map(leaf, sd)
    return sd_leaf, originals, [leaves[id(t)] for t in originals]


@profiling.spanned("interior")
def _interior_scan(integrator, sd, opts, sensor_id: int, seed: int,
                   pixel_loss, pix):
    """Forward and adjoint of the interior term over the pixels ``pix``:
    gradients go into ``sd``'s leaves. Returns ``(loss, image (n, 3),
    g (n, 3))``, ``g`` the loss cotangent of the image rows."""
    n = pix.shape[0]
    if opts.spp == 0:
        rows = torch.zeros((n, 3), dtype=torch.float32, device=pix.device,
                           requires_grad=True)
        loss = pixel_loss(rows, pix).sum()
        (g,) = torch.autograd.grad(loss, rows)
        return loss.detach(), rows.detach(), g
    pix_chunks, row_valid = pad_pixel_chunks(pix, opts.spp,
                                             _base.TRAIN_CHUNK_LANES)
    loss = torch.zeros((), dtype=torch.float32, device=pix.device)
    images, gs = [], []
    for pix_chunk, valid in zip(pix_chunks, row_valid):
        out = interior_chunk(integrator, sd, opts, sensor_id, seed, opts.spp,
                             True, pix_chunk, vjp_ok=True)
        rows = out.detach().requires_grad_()
        loss_c = torch.where(valid, pixel_loss(rows, pix_chunk), 0.0).sum()
        (g,) = torch.autograd.grad(loss_c, rows)
        if out.requires_grad:
            with profiling.span("pullback"):
                out.backward(g)
        loss = loss + loss_c.detach()
        images.append(out.detach())
        gs.append(g)
    return loss, torch.cat(images)[:n], torch.cat(gs)[:n]


def _edge_pullbacks(integrator, sd, opts, sensor_id: int, seed: int, g_img,
                    shard=None):
    """Pull the image cotangent through the derivative-only edge passes
    into ``sd``'s leaves (integrator.cpp:179-198, path.cpp:274-294); an
    integrator without the secondary-edge term has no
    ``secondary_edge_vals``, and the step leaves the term out. ``shard =
    (rank, n_ranks)``: only the rank's window of each pass's lanes."""
    n_pix = opts.num_pixels

    def window(n_samples):
        return (None if shard is None
                else shard_lane_window(n_samples, shard[1], shard[0]))

    if opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
        with profiling.span("primary_edge"):
            integrator._render_primary_edges(sd, opts, sensor_id, seed,
                                             g_img, window(n_pix * opts.sppe))
    if opts.sppse > 0 and sd.sec_edge is not None:
        with profiling.span("secondary_edge"):
            integrator.render_secondary_edges(sd, opts, sensor_id, seed,
                                              g_img,
                                              window(n_pix * opts.sppse))


def fused_loss_grad(integrator, sd, opts, sensor_id: int, seed: int,
                    pixel_loss):
    """``(loss, image)`` of one step; the gradients accumulate in the
    ``.grad`` of ``sd``'s leaf tensors. ``pixel_loss(rows (m, 3), pix
    (m,)) -> (m,)`` must be pixel-local."""
    pix = torch.arange(opts.num_pixels, dtype=torch.int64,
                       device=sd.tri.p0.device)
    loss, image, g_img = _interior_scan(integrator, sd, opts, sensor_id,
                                        seed, pixel_loss, pix)
    _edge_pullbacks(integrator, sd, opts, sensor_id, seed, g_img)
    return loss, image


def _full_frame(rows, pix, n_pix: int, group):
    """The (n_pix, 3) frame whose ``pix`` rows are each rank's ``rows``:
    zeros elsewhere, summed across the ranks (adding zeros is exact)."""
    full = rows.new_zeros((n_pix, 3))
    full[pix] = rows
    dist.all_reduce(full, group=group)
    return full


def fused_loss_grad_sharded(integrator, sd, opts, sensor_id: int, seed: int,
                            pixel_loss, pix_shard, mesh):
    """:func:`fused_loss_grad` on one rank of ``mesh``
    (``parallel.mesh.ProcessMesh``; the JAX package's per-device body):
    the interior over ``pix_shard``, this rank's contiguous pixel block;
    the full-frame loss cotangent from every rank's rows; the edge passes
    over this rank's window of their lanes. Returns ``(loss, image)``,
    both summed across the ranks (every rank holds the full frame); the
    leaves' gradients are this rank's share, to be summed by the caller.
    Every rank must call it, in the same order."""
    n_pix = opts.num_pixels
    loss, rows, g = _interior_scan(integrator, sd, opts, sensor_id, seed,
                                   pixel_loss, pix_shard)
    g_img = _full_frame(g, pix_shard, n_pix, mesh.group)
    _edge_pullbacks(integrator, sd, opts, sensor_id, seed, g_img,
                    shard=(mesh.rank, mesh.size))
    loss = loss.clone()
    dist.all_reduce(loss, group=mesh.group)
    return loss, _full_frame(rows, pix_shard, n_pix, mesh.group)


_WARP_AUTO = object()  # "warp not passed": the integrator's own table


@profiling.spanned("step", entry=True)
def loss_and_grad(integrator, scene, params, apply_params, pixel_loss,
                  sensor_id: int = 0, seed: int = -1, warp=_WARP_AUTO,
                  mesh=None):
    """One training step: ``(loss, grads, image)``.

    ``params`` is a dict of float tensors; ``apply_params(params)`` sets
    them on the scene objects (vertex positions, transforms, reflectances,
    radiances); ``grads`` has the same keys. The scene compile runs on the
    CPU, so gradients come back on each parameter's own device. Afterwards
    the scene objects hold the parameters' values, detached.

    ``warp``: the secondary-edge guiding table
    (``HyperCubeDistribution``). Left unset, the step reads the
    integrator's table for ``sensor_id`` at the call, as built by its last
    ``preprocess_secondary_edges``; ``None`` samples unguided. (The JAX
    package raises when an outer ``jax.jit`` would bake an unset table into
    its trace; a PyTorch step is not traced, so it reads the table
    afresh each call.)

    ``mesh`` (``parallel.mesh.ProcessMesh``): the step sharded over its
    ranks' pixel blocks (:func:`fused_loss_grad_sharded`); every rank
    calls it with the same arguments, and every rank gets the summed
    loss, the summed gradients and the full image."""
    seed, _ = integrator._norm_args(scene, seed, None, None)
    has_warpper = hasattr(integrator, "warpper")
    if warp is _WARP_AUTO:
        warp = integrator.warpper.get(sensor_id) if has_warpper else None
    p = {k: torch.as_tensor(v).detach().requires_grad_()
         for k, v in params.items()}
    apply_params(p)
    prev = integrator.warpper if has_warpper else None
    if has_warpper:
        integrator.warpper = {**prev, sensor_id: warp}
    try:
        with profiling.span("compile"):
            sd = scene.configure_data(scene._active_sensors)
        sd_leaf, originals, leaves = _leaves(sd)
        if mesh is None:
            loss, image = fused_loss_grad(integrator, sd_leaf, scene.opts,
                                          sensor_id, seed, pixel_loss)
        else:
            pix = pixel_block(scene.opts.num_pixels, mesh, sd.tri.p0.device)
            loss, image = fused_loss_grad_sharded(
                integrator, sd_leaf, scene.opts, sensor_id, seed,
                pixel_loss, pix, mesh)
            # a leaf a rank left without a gradient counts zeros
            summed = sum_each_across_ranks(
                [l.grad if l.grad is not None else torch.zeros_like(l)
                 for l in leaves], mesh.group) if leaves else []
            for l, g in zip(leaves, summed):
                l.grad = g
        pairs = [(o, l.grad) for o, l in zip(originals, leaves)
                 if l.grad is not None]
        if pairs:
            with profiling.span("compile.pullback"):
                torch.autograd.backward([o for o, _ in pairs],
                                        [g for _, g in pairs])
    finally:
        if has_warpper:
            integrator.warpper = prev
        apply_params({k: v.detach() for k, v in p.items()})
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in p.items()}
    return loss, grads, image
