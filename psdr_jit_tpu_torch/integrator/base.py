"""Integrator base (counterpart of ``psdr_jit_tpu/integrator/base.py``):
the interior render loop of ``renderC`` and ``renderD``, the primary-edge
boundary term, the derivative-only edge images of ``renderD`` and the
``loss_and_grad`` entry of the training step (``integrator/fused.py``).
The secondary-edge term is ``integrator/edge.py``'s mixin.

``renderD`` is differentiated with torch's own two modes: reverse mode
(``torch.autograd``), in which each chunk of the interior and edge passes
runs under ``torch.utils.checkpoint`` so that one chunk's graph is held at
a time (the JAX package's ``_remat``), and forward mode
(``torch.autograd.forward_ad``), which holds no graph. Its derivative
seams are the JAX package's ``stop_gradient``s: ``.detach()`` on a tensor
and :func:`core.math.detached` around a block. ``REMAT_MODE`` picks how
reverse mode bounds its memory.

:meth:`Integrator.render_impl_sharded` is the per-rank body of the
pixel-sharded render (``parallel/``): the interior term over the rank's
pixels, each edge pass over its window of the global edge-sample lanes,
the edge image summed across ranks.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..core.object import Object
from ..core.sampler import Sampler
from ..core.math import detached, safe_div, scrub_nonfinite
from ..ops.image import interior_average, splat_add_derivative_only
from ..scene.scene import tree_map
from ..sensor.sensor import sample_primary_edge
from . import prb

# Sampler stream salts of the three estimators (reference scene.cpp:52).
STREAM_INTERIOR = 0
STREAM_PRIMARY = 1
STREAM_SECONDARY = 2

# Sample lanes per chunk of the pixel loop: one chunk holds a whole 512x512
# spp-32 frame. The PyTorch set-up around K2 (sampler hash, primary rays)
# costs a fixed ~0.7 ms of launches per chunk, so fewer chunks are faster:
# on an H100, renderC of that frame took 21-24 / 15-17 / 14.2 / 13.5 ms at
# 2^20 / 2^21 / 2^22 / 2^23 lanes per chunk, for a peak of 0.1 / 0.2 /
# 0.4 / 0.8 GB (PERF.md). Larger frames loop over 2^23-lane chunks.
CHUNK_LANES = 1 << 23
# Sample lanes per chunk of renderC on the general path (scenes outside
# K2's scope, ``PathTracer._li_general``), whose PyTorch shading holds
# every bounce's per-lane tensors of a chunk at once. On an H100 the
# 102,412-triangle gallery at 512x512 spp 8 took 511 / 314 / 245 / 216 ms
# at 2^18 / 2^19 / 2^20 / 2^21 lanes per chunk, for a peak of 0.14 / 0.26
# / 0.49 / 0.95 GB (PERF.md): each chunk costs ~2,000 small launches that
# the host issues slower than the card runs them.
GENERAL_CHUNK_LANES = 1 << 21
# Sample lanes per chunk of the training step's interior pass (one chunk's
# attached graph, K2-stash payload, rays and K4's cotangents, is held at a
# time) and of its primary-edge pass. On an H100 the 512x512 spp-32
# sppe-32 step took 140 / 119 / 99 / 94 ms at 2^20 / 2^21 / 2^22 / 2^23
# lanes per chunk of both, for a peak of 0.27 / 0.52 / 1.03 / 1.87 GB
# (PERF.md): 2^22 is within 5% of the fastest at half its memory.
TRAIN_CHUNK_LANES = 1 << 22
# Sample lanes per chunk of the training step's secondary-edge pass (one
# chunk's graph, the edge points and the two Moller-Trumbore
# re-intersections, is held at a time). On an H100 the 512x512 spp-32
# sppe-32 sppse-32 step took 145.3 / 145.7 / 144.3 ms, and in a later run
# 151.2 / 145.5 / 141.0 ms, at 2^21 / 2^22 / 2^23 lanes per chunk, for a
# peak of 2.26 / 4.51 / 8.83 GB (PERF.md): the step is host-bound,
# fewer chunks launch less, and 2^22 is within 3.2% of the fastest at
# half its memory.
SE_CHUNK_LANES = 1 << 22
# Sample lanes per chunk of renderD's interior pass, the attached general
# Li (PathTracer._li_general with diff), in both modes; under reverse mode
# each chunk is checkpointed, and its graph is held while the backward
# sweep recomputes it. On an NVIDIA H100 80GB HBM3 at 700.00 W (its
# nvidia-smi name and power limit) renderD of the 512x512 spp-32
# sppe-32 sppse-32 box took 1043 / 724 / 392 / 384 ms in forward mode and
# 1199 / 708 / 616 / 605 ms in reverse mode (render and backward) at 2^20
# / 2^21 / 2^22 / 2^23 lanes per chunk, for a reverse-mode peak of 4.3 /
# 4.4 / 8.8 / 17.6 GB (PERF.md; scripts/torch_profile_render.py
# --renderD; a later run read 899 / 697 / 457 / 394 and 1530 / 775 / 626
# / 600 ms): a chunk costs a fixed count of small launches that the host
# issues slower than the card runs them, and 2^22 is within 2-16% of 2^23
# in forward mode and 2-4% in reverse mode at half its memory.
DIFF_CHUNK_LANES = 1 << 22

# How reverse mode bounds its memory (the JAX package's PSDR_REMAT):
#   "chunk"  (default) each chunk of renderD's passes and of renderD's
#            interior under torch.utils.checkpoint, with the checkpoint
#            policy: its recompute in the backward sweep replays the
#            forward's hit payloads and edge radiances (prb.py), so it
#            launches no hit kernel;
#   "prb"    path replay of renderD's interior chunks for integrators that
#            support it (PathTracer): a torch.autograd.Function per chunk
#            that keeps the payloads and rebuilds the chunk from them in
#            its backward (prb.replay_chunk); reverse mode only;
#   "bounce" a checkpoint around each bounce of the attached general Li
#            instead of each interior chunk (PathTracer);
#   "none"   no checkpoint: every chunk's graph is held.
# Integrators without path replay or bounce checkpoints keep the chunk
# checkpoint under "prb" and "bounce". The training step (fused.py) holds
# one chunk's graph at a time by construction and reads none of this.
REMAT_MODES = ("chunk", "prb", "bounce", "none")
REMAT_MODE = os.environ.get("PSDR_REMAT", "chunk")
if REMAT_MODE not in REMAT_MODES:
    raise ValueError(f"PSDR_REMAT={REMAT_MODE!r}: one of {REMAT_MODES}")


def interior_chunk_lanes(sd) -> int:
    """Lanes per chunk of renderC: K2's scenes take ``CHUNK_LANES``, all
    others ``GENERAL_CHUNK_LANES`` (the JAX package routes its chunk size
    on the scene's intersection path the same way). Chunking is
    partition-exact, so the image does not depend on it."""
    from ..ops import megakernel as mega

    return CHUNK_LANES if mega.applicable(sd) else GENERAL_CHUNK_LANES


def interior_lane_setup(width: int, height: int, spp: int, seed: int,
                        pix_chunk):
    """Global-sample-index lanes, interior-stream sampler and jittered
    screen samples for one pixel chunk.

    ``lane = pixel * spp + s`` (reference integrator.cpp:23-30): any pixel
    partition reproduces the full frame's sample set exactly."""
    m = pix_chunk.shape[0]
    dev = pix_chunk.device
    sample_pix = pix_chunk.to(torch.int64).repeat_interleave(spp)
    lane = (sample_pix * spp
            + torch.arange(spp, dtype=torch.int64, device=dev).repeat(m))
    sampler = Sampler(seed + STREAM_INTERIOR, lane)
    base = torch.stack([(sample_pix % width).to(torch.float32),
                        (sample_pix // width).to(torch.float32)], dim=-1)
    # (width, height) filled on the device: a tensor copied from the host
    # would make the host wait for the card
    size = torch.empty(2, dtype=torch.float32, device=dev)
    size[0], size[1] = width, height
    samples = (base + sampler.next_2d()) / size
    return m, sampler, samples


def interior_chunk(integrator, sd, opts, sensor_id: int, seed: int,
                   spp: int, diff: bool, pix_chunk, vjp_ok: bool = False,
                   tape=None):
    """Render one pixel chunk of the interior estimator -> (m, 3); with
    ``diff`` the rows are attached to ``sd`` (the camera pose and every
    table the attached Li reads). ``vjp_ok``: the caller pulls the rows
    back in reverse mode only (the training step), so the attached Li may
    take K3 and K4 (``PathTracer.Li``). ``tape``: the path-replay tape the
    Li's hits are recorded on or replayed from (prb.py)."""
    m, sampler, samples = interior_lane_setup(opts.width, opts.height, spp,
                                              seed, pix_chunk)
    ray = sd.sensors[sensor_id].sample_primary_ray(samples, diff=diff)
    active = torch.ones(m * spp, dtype=torch.bool, device=pix_chunk.device)
    value = scrub_nonfinite(integrator.Li(sd, sampler, ray, active, diff,
                                          vjp_ok=vjp_ok, tape=tape))
    return interior_average(value, m, spp)


def pad_pixel_chunks(pix, spp: int, chunk_lanes: int):
    """Split ``pix`` into chunks of ``chunk_lanes // spp`` pixels (or one
    chunk of all of them), the last padded with pixel 0: ``(pix_chunks (k,
    max_pix), row_valid (k, max_pix))``. Pad rows must be masked out of
    the caller's loss."""
    n_pix = pix.shape[0]
    max_pix = max(min(chunk_lanes // max(spp, 1), n_pix), 1)
    k = -(-n_pix // max_pix)
    n_pad = k * max_pix
    pix_chunks = torch.cat([pix, pix.new_zeros(n_pad - n_pix)]).reshape(
        k, max_pix)
    row_valid = (torch.arange(n_pad, device=pix.device) < n_pix).reshape(
        k, max_pix)
    return pix_chunks, row_valid


def builds_graph(sd) -> bool:
    """Whether a render of ``sd`` records a reverse-mode graph: grad mode
    is on and some tensor of ``sd`` requires grad. Forward mode alone
    (``torch.autograd.forward_ad``) records none, and is never
    checkpointed."""
    if not torch.is_grad_enabled():
        return False
    flags = []

    def note(t):
        flags.append(t.requires_grad)
        return t

    tree_map(note, sd)
    return any(flags)


def _policy_tape():
    """The tape of one checkpointed chunk (the checkpoint policy); a test
    patches this to return None to run the checkpoints without it."""
    return prb.IntersectTape()


def _checkpoint(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its graph is dropped
    after the forward and rebuilt when the backward sweep reaches it. The
    rebuild replays the first run's hit payloads and edge radiances from
    the chunk's tape (the JAX package's ``CHECKPOINT_POLICY``): no hit
    kernel is launched again, and the rebuilt values are the first run's
    bit for bit."""
    tape = _policy_tape()
    if tape is None:
        run = fn
    else:
        def run(*a):
            with prb.recording(tape):
                return fn(*a)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run_chunk(fn, arg, graph: bool):
    """``fn(arg)``, checkpointed (:func:`_checkpoint`) where it records a
    graph, unless ``REMAT_MODE`` is "none"."""
    if not graph or REMAT_MODE == "none":
        return fn(arg)
    return _checkpoint(fn, arg)


def shard_lane_window(total: int, n_dev: int, idx: int):
    """``(lane_offset, lane_count)`` of rank ``idx`` of ``n_dev`` in a
    global lane space of ``total`` lanes (ceil-divided windows; the last
    may run past ``total``, and its lanes there are dropped): the one
    partition of the sharded render and of the sharded training step."""
    per = -(-total // n_dev)
    return idx * per, per


def edge_lane_chunks(n_samples: int, chunk_lanes: int, device,
                     window=None):
    """The lanes of an edge pass, ``chunk_lanes`` at a time: the one chunk
    geometry of its pullback (:func:`chunked_splat_pullback`, the training
    step) and of its image (:func:`chunked_splat_image`, ``renderD``).
    ``window = (offset, count)``: only the global lanes ``[offset, offset
    + count)`` below ``n_samples`` (a rank's share, ``shard_lane_window``);
    the sampler is keyed on the global lane, so the windows' union is the
    whole pass."""
    lo, hi = 0, n_samples
    if window is not None:
        lo, hi = window[0], min(window[0] + window[1], n_samples)
    for s in range(lo, hi, chunk_lanes):
        yield torch.arange(s, min(s + chunk_lanes, hi), dtype=torch.int64,
                           device=device)


def chunked_splat_pullback(chunk_vals, n_samples: int, n_pix: int,
                           chunk_lanes: int, device, ct, window=None):
    """Pull the image cotangent ``ct`` (n_pix, 3) back through the splat
    of edge-sample chunks into a derivative-only image, chunk by chunk as
    each is built, so one chunk's graph is held at a time.
    ``chunk_vals(lane)`` -> ``(values (chunk, 3), idx (chunk,))`` with
    ``idx = -1`` for dropped lanes; ``window`` as :func:`edge_lane_chunks`."""
    for lane in edge_lane_chunks(n_samples, chunk_lanes, device, window):
        values, idx = chunk_vals(lane)
        part = splat_add_derivative_only(values, idx, n_pix)
        if part.requires_grad:
            part.backward(ct)


def chunked_splat_image(chunk_vals, n_samples: int, n_pix: int,
                        chunk_lanes: int, device, graph: bool, window=None):
    """The derivative-only image (n_pix, 3) of the edge-sample chunks of
    ``chunk_vals`` (as :func:`chunked_splat_pullback`'s): zero in value,
    the sum of the chunks' splats in derivative. With ``graph`` each chunk
    is checkpointed (the JAX package's ``_chunked_splat_sum``)."""
    img = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)

    def part(lane):
        return splat_add_derivative_only(*chunk_vals(lane), n_pix)

    for lane in edge_lane_chunks(n_samples, chunk_lanes, device, window):
        img = img + _run_chunk(part, lane, graph)
    return img


class _SumAcrossRanks(torch.autograd.Function):
    """``all_reduce`` (sum) of a tensor over a process group, in both
    modes: its adjoint and its tangent are the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        t = t.clone()
        dist.all_reduce(t, group=ctx.group)
        return t


def sum_across_ranks(x, group):
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _SumAcrossRanks.apply(x, group)


def sum_each_across_ranks(tensors, group) -> list:
    """Each of ``tensors`` summed over the ranks of ``group``, in one
    ``all_reduce`` of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [p.reshape(t.shape) for p, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def pixel_block(n_pix: int, mesh, device):
    """Rank ``mesh.rank``'s contiguous block of ``n_pix`` pixels (the
    blocks in rank order are the frame); the rank count must divide the
    pixel count."""
    if n_pix % mesh.size:
        raise ValueError(f"{n_pix} pixels do not divide among {mesh.size} "
                         "ranks")
    per = n_pix // mesh.size
    return torch.arange(mesh.rank * per, (mesh.rank + 1) * per,
                        dtype=torch.int64, device=device)


class Integrator(Object):
    """Base class; subclasses implement ``Li``."""

    def Li(self, sd, sampler, ray, active, diff: bool = False,
           vjp_ok: bool = False, tape=None):
        raise NotImplementedError

    def Li_pair(self, sd, sampler, ray_n, ray_p, active):
        """Detached ``Li(ray_n) - Li(ray_p)`` for the primary-edge pass
        (reference integrator.cpp:185-186): two sequential detached Li
        calls, in the reference's draw order (JAX base.py:403-412); an
        integrator with a pair kernel overrides it."""
        li_n = self.Li(sd, sampler, ray_n, active)
        li_p = self.Li(sd, sampler, ray_p, active)
        return li_n - li_p

    @staticmethod
    def _norm_args(scene, seed, pix_id, batch_pix):
        """Reference conventions (psdr.cpp:420-421): ``seed < 0`` means
        the scene seed; ``batch_pix`` is the crop-id array, or -1."""
        if seed is not None:
            seed = int(seed)
        if seed is None or seed < 0:
            seed = scene.seed
        if pix_id is None and batch_pix is not None and not (
                isinstance(batch_pix, int) and batch_pix < 0):
            pix_id = batch_pix
        return seed & 0xFFFFFFFF, pix_id

    def renderC(self, scene, sensor_id: int = 0, seed: int = -1,
                pix_id=None, batch_pix=None):
        """Primal render (reference Integrator::renderC): ``(n_pix, 3)``
        float32 on the scene's device, pixel-major; ``pix_id`` renders
        only those pixels, bitwise equal to the full frame's rows. With
        ``scene.opts.log_level > 0`` it prints "Rendered in X seconds.",
        the device synchronised."""
        from ..utils.profiling import log_time

        seed, pix_id = self._norm_args(scene, seed, pix_id, batch_pix)
        with log_time("Rendered", scene.opts.log_level > 0,
                      device=scene.device):
            return self._render_interior(scene.data, scene.opts, sensor_id,
                                         seed, pix_id)

    def renderD(self, scene, sensor_id: int = 0, seed: int = -1,
                pix_id=None, batch_pix=None):
        """Differentiable render (reference Integrator::renderD):
        ``(n_pix, 3)`` float32 on the scene's device, with ``renderC``'s
        argument conventions. The scene compile runs again
        (``scene.configure_data``, with the primary-edge tables of the
        sensors of the last ``configure(active_sensors)``: an inactive
        sensor renders without its primary-edge term, as in the JAX
        package), so the image is attached to every
        parameter set on the scene objects as a tensor that requires grad
        or carries a forward-mode tangent.

        Its value is the interior term through the attached Li; to it are
        added the derivative-only primary-edge (``sppe > 0``) and
        secondary-edge (``sppse > 0``, guided by ``self.warpper``'s table
        of ``sensor_id`` where there is one) images, zero in value. The
        edge images are built over the full grid; ``pix_id`` takes their
        rows. Reverse mode: ``torch.autograd.grad`` of any scalar of the
        image. Forward mode: parameters set as dual tensors inside
        ``torch.autograd.forward_ad.dual_level()``; the image's tangent
        (``unpack_dual(img).tangent``) is the gradient image. It logs as
        ``renderC`` does."""
        from ..utils.profiling import log_time

        seed, pix_id = self._norm_args(scene, seed, pix_id, batch_pix)
        with log_time("Rendered", scene.opts.log_level > 0,
                      device=scene.device):
            sd = scene.configure_data(scene._active_sensors)
            opts = scene.opts
            img = self._render_interior(sd, opts, sensor_id, seed, pix_id,
                                        diff=True)
            edge_img = self._edge_image(sd, opts, sensor_id, seed)
            if edge_img is None:
                return img
            if pix_id is not None:
                edge_img = edge_img[_pixels(pix_id, sd.tri.p0.device)]
            return img + edge_img

    def _edge_image(self, sd, opts, sensor_id: int, seed: int,
                    shard=None):
        """The derivative-only edge images of renderD (primary edges where
        ``sppe > 0``, secondary edges where ``sppse > 0`` and the
        integrator has the term), summed over the full grid, or None.
        ``shard = (rank, n_ranks)``: each pass only over the rank's window
        of its lanes (:func:`shard_lane_window`)."""
        graph = builds_graph(sd)
        n_pix = opts.num_pixels
        edges = []
        if opts.sppe > 0 and sd.sensors[sensor_id].edge_info is not None:
            edges.append((self._primary_edge_vals(sd, opts, sensor_id, seed),
                          n_pix * opts.sppe, TRAIN_CHUNK_LANES))
        if opts.sppse > 0 and sd.sec_edge is not None:
            vals = self.secondary_edge_vals(sd, opts, sensor_id, seed)
            if vals is not None:
                edges.append((vals, n_pix * opts.sppse, SE_CHUNK_LANES))
        img = None
        for vals, n_samples, chunk_lanes in edges:
            window = (None if shard is None
                      else shard_lane_window(n_samples, shard[1], shard[0]))
            part = chunked_splat_image(vals, n_samples, n_pix, chunk_lanes,
                                       sd.tri.p0.device, graph, window)
            img = part if img is None else img + part
        return img

    def render_impl_sharded(self, sd, opts, sensor_id: int, seed: int,
                            pix_shard, mesh):
        """renderD's rows of ``pix_shard``, this rank's contiguous pixel
        block, on the ranks of ``mesh`` (``parallel.mesh.ProcessMesh``):
        the interior term over the block; each edge pass over the rank's
        window of its global lanes, the full-grid edge image summed across
        the ranks (differentiably, in both modes) and its block's rows
        taken. Every rank must call it, in the same order. The interior
        rows are the unsharded render's bit for bit; the edge images
        differ from it only in the order of their float sums."""
        rows = self._render_interior(sd, opts, sensor_id, seed, pix_shard,
                                     diff=True)
        edge_img = self._edge_image(sd, opts, sensor_id, seed,
                                    shard=(mesh.rank, mesh.size))
        if edge_img is None:
            edge_img = torch.zeros((opts.num_pixels, 3), dtype=torch.float32,
                                   device=rows.device)
        edge_img = sum_across_ranks(edge_img, mesh.group)
        return rows + edge_img[_pixels(pix_shard, rows.device)]

    def secondary_edge_vals(self, sd, opts, sensor_id: int, seed: int):
        """``chunk_vals(lane)`` of the secondary-edge term (as
        :func:`chunked_splat_pullback` takes it), or None: an integrator
        without the term (no :class:`edge.SecondaryEdgeMixin`) keeps this
        default, and its renders and training step leave the term out."""
        return None

    def render_secondary_edges(self, sd, opts, sensor_id: int, seed: int,
                               ct, window=None):
        """Pull the image cotangent ``ct`` (n_pix, 3) through the
        derivative-only secondary-edge image (path.cpp:274-294) into
        ``sd``'s attached tables, ``SE_CHUNK_LANES`` lanes at a time;
        ``window``: only those lanes (:func:`edge_lane_chunks`)."""
        vals = self.secondary_edge_vals(sd, opts, sensor_id, seed)
        if vals is not None:
            chunked_splat_pullback(vals, opts.num_pixels * opts.sppse,
                                   opts.num_pixels, SE_CHUNK_LANES,
                                   sd.tri.p0.device, ct, window)

    def loss_and_grad(self, scene, params, apply_params, pixel_loss,
                      sensor_id: int = 0, seed: int = -1, **kwargs):
        """One training step for a pixel-local loss: ``(loss, grads,
        image)`` with one forward and one adjoint (integrator/fused.py).
        ``params`` is a dict of tensors, ``apply_params(params)`` sets them
        on the scene objects, ``pixel_loss(rows (m, 3), pix (m,)) -> (m,)``;
        ``grads`` has the keys of ``params``. ``warp=`` is the
        secondary-edge guiding table (``fused.loss_and_grad``)."""
        from .fused import loss_and_grad as _fused

        return _fused(self, scene, params, apply_params, pixel_loss,
                      sensor_id, seed, **kwargs)

    def _render_interior(self, sd, opts, sensor_id, seed, pix_id,
                         diff: bool = False):
        """The interior term over ``pix_id`` (all pixels when None):
        detached in ``CHUNK_LANES``/``GENERAL_CHUNK_LANES``-lane chunks,
        or (``diff``) attached in ``DIFF_CHUNK_LANES``-lane chunks, each
        checkpointed where the render records a graph, replayed under
        ``REMAT_MODE`` "prb" where the integrator supports it, or left to
        the Li's own bounce checkpoints under "bounce"."""
        dev = sd.tri.p0.device
        pix = (torch.arange(opts.num_pixels, dtype=torch.int64, device=dev)
               if pix_id is None else _pixels(pix_id, dev))
        n_pix = pix.shape[0]
        spp = opts.spp
        if spp == 0 or n_pix == 0:
            return torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        lanes = DIFF_CHUNK_LANES if diff else interior_chunk_lanes(sd)
        step = max(lanes // spp, 1)
        pieces = [pix[s:s + step] for s in range(0, n_pix, step)]
        if diff and REMAT_MODE == "prb" and getattr(self, "supports_prb",
                                                    False):
            def render(sd_, pix_chunk, tape):
                return interior_chunk(self, sd_, opts, sensor_id, seed, spp,
                                      True, pix_chunk, tape=tape)

            return torch.cat([prb.replay_chunk(render, sd, p)
                              for p in pieces])
        graph = diff and builds_graph(sd) and not (
            REMAT_MODE == "bounce"
            and getattr(self, "supports_bounce_remat", False))

        def chunk(pix_chunk):
            return interior_chunk(self, sd, opts, sensor_id, seed, spp, diff,
                                  pix_chunk)

        return torch.cat([_run_chunk(chunk, p, graph) for p in pieces])

    # primary-edge boundary term (integrator.cpp:179-198)
    def _primary_edge_vals(self, sd, opts, sensor_id: int, seed: int):
        """``chunk_vals(lane)`` of the primary-edge term (as
        :func:`chunked_splat_pullback` takes it), attached to ``sd``'s
        edge endpoints. Stream ``seed + STREAM_PRIMARY``: one draw for the
        edge sample (two where the table takes an alias coin), then
        ``Li_pair`` from ``sampler.cnt``, whose detached value a
        checkpointed chunk tapes (``prb.taped_value``)."""
        sensor = sd.sensors[sensor_id]
        if sensor.edge_info is None:
            raise ValueError("no primary edges configured: set sppe > 0 "
                             "before the scene compile")

        def chunk_vals(lane):
            sampler = Sampler(seed + STREAM_PRIMARY, lane)
            u1 = sampler.next_1d()
            coin = sampler.next_1d() if sensor.edge_info.distrb.needs_coin \
                else None
            es = sample_primary_edge(sensor, u1, coin)
            valid = es.idx >= 0
            with detached():
                delta = prb.taped_value(lambda: self.Li_pair(
                    sd, sampler, es.ray_n, es.ray_p, valid), sampler)
            value = es.x_dot_n[..., None] * safe_div(delta, es.pdf[..., None])
            value = scrub_nonfinite(value)
            if opts.sppe > 1:
                value = value / float(opts.sppe)
            value = torch.where(valid[..., None], value, 0.0)
            return value, torch.where(valid, es.idx, -1)

        return chunk_vals

    def _render_primary_edges(self, sd, opts, sensor_id: int, seed: int, ct,
                              window=None):
        """Pull the image cotangent ``ct`` through the derivative-only
        primary-edge image into ``sd``'s attached tables (the edge
        endpoints), ``TRAIN_CHUNK_LANES`` lanes at a time; ``window``: only
        those lanes (:func:`edge_lane_chunks`)."""
        chunked_splat_pullback(
            self._primary_edge_vals(sd, opts, sensor_id, seed),
            opts.num_pixels * opts.sppe, opts.num_pixels, TRAIN_CHUNK_LANES,
            sd.tri.p0.device, ct, window)


def _pixels(pix_id, device):
    return torch.as_tensor(pix_id, device=device).to(torch.int64)
