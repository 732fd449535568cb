"""Closest hit for scenes above 4096 triangles: a fixed two-level hierarchy
over the Morton-ordered triangles (counterpart of ``ray_intersect_bvh`` in
``psdr_jit_tpu/ops/bvh.py``).

The triangles arrive in the scene's Morton order, so consecutive ids are
spatially close. :func:`build_bvh` groups them, as they are, into
512-triangle blocks of eight 64-triangle clusters and gives each cluster
and each block an AABB, widened as every culling box of the port is
(``intersect.widen_boxes``). It runs on the rays' device, per call, from
``p0/e1/e2``, as the JAX package builds its block boxes.

Each ray tests the block boxes in order; inside a block that may hold a
closer hit it tests the cluster boxes, and inside a cluster that may, the
64 triangles (THE hit test, strict ``t < best``, ascending ids). Culling
is conservative, so the result is the unculled sweep's bit for bit.

* :func:`bvh_cuda` launches kernel K6 (``csrc/bvh.cu``): one thread per
  ray, the block boxes in shared memory, the clusters and triangles read
  from global memory (L2-resident: 102,412 triangles are 4.9 MB here).
* :func:`ray_intersect_bvh_plain` is its plain PyTorch version: for each
  block it gathers the rays whose slab test passes against their current
  best, masks the clusters that fail against it, and sweeps the rest.

The JAX package's ray sort, tile-versus-block interval test, fetch lists
and proxy pre-pass exist because TPU lanes cannot index memory per lane
(``psdr_jit_tpu/ops/bvh.py:1-31``); none of them is carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _cuda
from .intersect import (PLAIN_RAY_CHUNK, _sweep_block, box_visit,
                        finish_hits, merge_hits, miss_like, pack_triangles,
                        widen_boxes)

BLOCK = 512         # triangles per block
BVH_CLUSTER = 64    # triangles per cluster inside a block
CLUSTERS_PER_BLOCK = BLOCK // BVH_CLUSTER
# K6 stages 32 bytes of block box per block in shared memory; a block of
# threads can have 227 KiB of it (with opt-in), so 7264 blocks: 3.7M
# triangles.
MAX_BLOCKS = 232448 // 32


@dataclasses.dataclass
class BVH:
    """The hierarchy's tables, all float32 on one device.

    ``tri4`` (F_pad, 12): p0, e1, e2 of each triangle, padded to three
    float4; ``cbox`` (F_pad / 64, 8) and ``bbox`` (F_pad / 512, 8): widened
    cluster and block AABBs as ``lo.xyz, 0, hi.xyz, 0``. F_pad is F padded
    to whole blocks with degenerate triangles."""

    tri4: torch.Tensor
    cbox: torch.Tensor
    bbox: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.bbox.shape[0]

    @property
    def tri(self) -> torch.Tensor:
        """The ``(9, F_pad)`` component rows of the plain sweep (a view)."""
        return self.tri4[:, :9].T


def build_bvh(p0, e1, e2) -> BVH:
    """Block and cluster tables of (F, 3) triangles in their given order."""
    tri, _ = pack_triangles(p0, e1, e2, BLOCK)
    f_pad = tri.shape[1]
    v0 = tri[0:3].T
    v1 = v0 + tri[3:6].T
    v2 = v0 + tri[6:9].T
    nc = f_pad // BVH_CLUSTER

    def cl(x):
        return x.reshape(nc, BVH_CLUSTER, 3)

    lo = torch.minimum(torch.minimum(cl(v0).amin(1), cl(v1).amin(1)),
                       cl(v2).amin(1))
    hi = torch.maximum(torch.maximum(cl(v0).amax(1), cl(v1).amax(1)),
                       cl(v2).amax(1))
    lo, hi = widen_boxes(lo, hi)
    nb = f_pad // BLOCK
    blo = lo.reshape(nb, CLUSTERS_PER_BLOCK, 3).amin(1)
    bhi = hi.reshape(nb, CLUSTERS_PER_BLOCK, 3).amax(1)

    def boxes(a, b):
        z = a.new_zeros((a.shape[0], 1))
        return torch.cat([a, z, b, z], dim=1).contiguous()

    tri4 = torch.cat([tri.T, tri.new_zeros((f_pad, 3))], dim=1).contiguous()
    return BVH(tri4=tri4, cbox=boxes(lo, hi), bbox=boxes(blo, bhi))


def ray_intersect_bvh_plain(bvh: BVH, ray_o, ray_d, active=None,
                            stats=None):
    """Plain K6 on (N, 3) rays, in chunks of ``PLAIN_RAY_CHUNK`` rays;
    inactive rays report a miss untraced.

    Returns ``(tri_id, valid, uv (N, 2), t)``. ``stats``, a dict if given,
    receives the (ray, triangle) tests the culling left
    (``"tri_tests"``)."""
    n = ray_o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=ray_o.device)
    parts = [_bvh_chunk(bvh, ray_o[s:s + PLAIN_RAY_CHUNK],
                        ray_d[s:s + PLAIN_RAY_CHUNK],
                        active[s:s + PLAIN_RAY_CHUNK], stats)
             for s in range(0, max(n, 1), PLAIN_RAY_CHUNK)]
    t, ids, u, v = (torch.cat(p) for p in zip(*parts))
    return ids, ids >= 0, torch.stack([u, v], dim=-1), t


def _bvh_chunk(bvh: BVH, o, d, live, stats):
    """For each block: the rays whose slab test passes against their
    current best; of those, the clusters whose slab test passes against
    it; sweep what is left of the block and keep the closer hits."""
    inv = 1.0 / d
    best = miss_like(o[:, 0])
    tests = 0
    for b in range(bvh.n_blocks):
        bb = bvh.bbox[b]
        rows = torch.nonzero(live & box_visit(bb[0:3], bb[4:7], o, inv,
                                              best[0])).squeeze(1)
        if rows.numel() == 0:
            continue
        ro, rd, ri = o[rows], d[rows], inv[rows]
        cur = tuple(x[rows] for x in best)
        cb = bvh.cbox[b * CLUSTERS_PER_BLOCK:(b + 1) * CLUSTERS_PER_BLOCK]
        visit = box_visit(cb[None, :, 0:3], cb[None, :, 4:7], ro[:, None],
                          ri[:, None], cur[0][:, None])
        tests += int(visit.sum()) * BVH_CLUSTER
        cand = _sweep_block(bvh.tri[:, b * BLOCK:(b + 1) * BLOCK],
                            *ro.unbind(-1), *rd.unbind(-1),
                            mask=visit.repeat_interleave(BVH_CLUSTER, dim=1))
        new = merge_hits(cur, cand, b * BLOCK)
        best = tuple(x.index_put((rows,), y) for x, y in zip(best, new))
    if stats is not None:
        stats["tri_tests"] = stats.get("tri_tests", 0) + tests
    return finish_hits(*best)


def bvh_cuda(bvh: BVH, ray_o, ray_d, active):
    """Launch K6: ``(t (N,), id (N,) int32, uv (N, 2))``; lanes with
    ``active`` False report a miss untraced. Equals the plain version bit
    for bit."""
    dev = ray_o.device
    nb = bvh.n_blocks
    if not 0 < nb <= MAX_BLOCKS:
        raise ValueError(f"K6 takes 1..{MAX_BLOCKS} blocks of {BLOCK} "
                         f"triangles (its block boxes live in shared "
                         f"memory), got {nb}")
    f_pad = nb * BLOCK
    _cuda.require(bvh.tri4, "tri4", torch.float32, (f_pad, 12), dev)
    _cuda.require(bvh.cbox, "cbox", torch.float32,
                  (f_pad // BVH_CLUSTER, 8), dev)
    _cuda.require(bvh.bbox, "bbox", torch.float32, (nb, 8), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return t, ids, uv
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_bvh(
            bvh.tri4.data_ptr(), bvh.cbox.data_ptr(), bvh.bbox.data_ptr(), nb,
            ray_o.data_ptr(), ray_d.data_ptr(), active.data_ptr(), n,
            t.data_ptr(), ids.data_ptr(), uv.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K6 launch")
    _cuda.LAUNCHES["K6"] += 1
    return t, ids, uv
