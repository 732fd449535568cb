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

Steps 1 and 4 are the JAX package's ``vjp(to_sd)`` / ``pull_cfg(sd_bar)``
(fused.py:288-305).
"""

from __future__ import annotations

import torch

from . import base as _base
from .base import interior_chunk, pad_pixel_chunks
from ..scene.scene import tree_map


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
            out.backward(g)
        loss = loss + loss_c.detach()
        images.append(out.detach())
        gs.append(g)
    return loss, torch.cat(images)[:n], torch.cat(gs)[:n]


def _edge_pullbacks(integrator, sd, opts, sensor_id: int, seed: int, g_img):
    """Pull the image cotangent through the derivative-only edge passes
    into ``sd``'s leaves (integrator.cpp:179-198, path.cpp:274-294); an
    integrator without the secondary-edge term has no
    ``secondary_edge_vals``, and the step leaves the term out."""
    if opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
        integrator._render_primary_edges(sd, opts, sensor_id, seed, ct=g_img)
    if opts.sppse > 0 and sd.sec_edge is not None:
        integrator.render_secondary_edges(sd, opts, sensor_id, seed, g_img)


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


_WARP_AUTO = object()  # "warp not passed": the integrator's own table


def loss_and_grad(integrator, scene, params, apply_params, pixel_loss,
                  sensor_id: int = 0, seed: int = -1, warp=_WARP_AUTO):
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
    afresh each call.)"""
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
        sd = scene.configure_data()
        sd_leaf, originals, leaves = _leaves(sd)
        loss, image = fused_loss_grad(integrator, sd_leaf, scene.opts,
                                      sensor_id, seed, pixel_loss)
        pairs = [(o, l.grad) for o, l in zip(originals, leaves)
                 if l.grad is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
    finally:
        if has_warpper:
            integrator.warpper = prev
        apply_params({k: v.detach() for k, v in p.items()})
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in p.items()}
    return loss, grads, image
