"""Integrator base (counterpart of ``psdr_jit_tpu/integrator/base.py``):
the interior render loop of ``renderC``, the primary-edge boundary term
and the ``loss_and_grad`` entry of the training step
(``integrator/fused.py``). The secondary-edge term is
``integrator/edge.py``'s mixin."""

from __future__ import annotations

import torch

from ..core.sampler import Sampler
from ..core.math import safe_div, scrub_nonfinite
from ..ops.image import interior_average, splat_add_derivative_only
from ..sensor.sensor import sample_primary_edge

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

_NOT_PORTED = ("is not ported to psdr_jit_tpu_torch yet: it follows in a "
               "later slice of the port (ROADMAP.md, port queue)")


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
                   spp: int, diff: bool, pix_chunk):
    """Render one pixel chunk of the interior estimator -> (m, 3); with
    ``diff`` the rows are attached to ``sd`` (the camera pose and every
    table the attached Li reads)."""
    m, sampler, samples = interior_lane_setup(opts.width, opts.height, spp,
                                              seed, pix_chunk)
    ray = sd.sensors[sensor_id].sample_primary_ray(samples, diff=diff)
    active = torch.ones(m * spp, dtype=torch.bool, device=pix_chunk.device)
    value = scrub_nonfinite(integrator.Li(sd, sampler, ray, active, diff))
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


def _chunked_splat_sum(chunk_vals, n_samples: int, n_pix: int,
                       chunk_lanes: int, device, ct):
    """Pull the image cotangent ``ct`` (n_pix, 3) back through the splat
    of edge-sample chunks into a derivative-only image, chunk by chunk as
    each is built, so one chunk's graph is held at a time.
    ``chunk_vals(lane)`` -> ``(values (chunk, 3), idx (chunk,))`` with
    ``idx = -1`` for dropped lanes."""
    for s in range(0, n_samples, chunk_lanes):
        lane = torch.arange(s, min(s + chunk_lanes, n_samples),
                            dtype=torch.int64, device=device)
        values, idx = chunk_vals(lane)
        part = splat_add_derivative_only(values, idx, n_pix)
        if part.requires_grad:
            part.backward(ct)


class Integrator:
    """Base class; subclasses implement ``Li``."""

    def Li(self, sd, sampler, ray, active, diff: bool = False):
        raise NotImplementedError

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
        only those pixels, bitwise equal to the full frame's rows."""
        seed, pix_id = self._norm_args(scene, seed, pix_id, batch_pix)
        return self._render_interior(scene.data, scene.opts, sensor_id,
                                     seed, pix_id)

    def renderD(self, scene, *args, **kwargs):
        raise NotImplementedError("renderD (forward-mode interior, then the "
                                  "primary and secondary edge terms) "
                                  + _NOT_PORTED)

    def render_secondary_edges(self, sd, opts, sensor_id: int, seed: int,
                               ct):
        """The secondary-edge term's pullback of ``ct``; an integrator
        without the term (no :class:`edge.SecondaryEdgeMixin`) keeps this
        default, which the training step leaves out."""
        return None

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

    def _render_interior(self, sd, opts, sensor_id, seed, pix_id):
        dev = sd.tri.p0.device
        if pix_id is None:
            pix = torch.arange(opts.num_pixels, dtype=torch.int64, device=dev)
        else:
            pix = torch.as_tensor(pix_id, device=dev).to(torch.int64)
        n_pix = pix.shape[0]
        out = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        spp = opts.spp
        if spp == 0:
            return out
        step = max(interior_chunk_lanes(sd) // spp, 1)
        for s in range(0, n_pix, step):
            out[s:s + step] = interior_chunk(self, sd, opts, sensor_id, seed,
                                             spp, False, pix[s:s + step])
        return out

    # primary-edge boundary term (integrator.cpp:179-198)
    def _render_primary_edges(self, sd, opts, sensor_id: int, seed: int, ct):
        """Pull the image cotangent ``ct`` through the derivative-only
        primary-edge image into ``sd``'s attached tables (the edge
        endpoints). Stream ``seed + STREAM_PRIMARY``: one draw for the edge
        sample, then ``Li_pair`` from ``sampler.cnt``."""
        sensor = sd.sensors[sensor_id]
        if sensor.edge_info is None:
            raise ValueError("no primary edges configured: set sppe > 0 "
                             "before the scene compile")
        n_samples = opts.num_pixels * opts.sppe

        def chunk_vals(lane):
            sampler = Sampler(seed + STREAM_PRIMARY, lane)
            es = sample_primary_edge(sensor, sampler.next_1d())
            valid = es.idx >= 0
            with torch.no_grad():
                delta = self.Li_pair(sd, sampler, es.ray_n, es.ray_p, valid)
            value = es.x_dot_n[..., None] * safe_div(delta, es.pdf[..., None])
            value = scrub_nonfinite(value)
            if opts.sppe > 1:
                value = value / float(opts.sppe)
            value = torch.where(valid[..., None], value, 0.0)
            return value, torch.where(valid, es.idx, -1)

        _chunked_splat_sum(chunk_vals, n_samples, opts.num_pixels,
                           TRAIN_CHUNK_LANES, sd.tri.p0.device, ct)
