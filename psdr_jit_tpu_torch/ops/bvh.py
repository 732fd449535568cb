"""Closest hit for scenes above 4096 triangles: a per-ray traversal of a
binary tree over the Morton-ordered triangles (counterpart of
``ray_intersect_bvh`` in ``psdr_jit_tpu/ops/bvh.py``).

The triangles arrive in the scene's Morton order, so consecutive ids are
spatially close. :func:`build_bvh` cuts them, as they are, into leaves of
``LEAF`` consecutive ids and builds a binary tree over the leaves by
splitting each range of leaves at its midpoint. The topology depends on
the triangle count and the leaf size alone (:func:`tree_topology`, cached);
the boxes are a bottom-up reduction of the triangles' widened boxes
(``intersect.widen_boxes``, the margin of every culling box of the port),
one level at a time, on the triangles' device. ``SceneData.bvh`` builds
the tree once per scene compile.

The node table holds no padding: every node is reached by its parent's
link, so no box is ever tested for a node that does not exist (an inverted
``+inf``/``-inf`` box would pass the slab test, whose min and max swap).

Culling is conservative and a hit replaces the best one when its ``(t,
id)`` is lexicographically smaller, which is the ascending sweep's choice
(the lowest id of equal distances) in any visit order; a box is entered
while ``tnear <= best``, so an equal-distance hit with a lower id is still
reached. So every version equals the unculled sweep bit for bit.

* :func:`bvh_cuda` launches kernel K6 (``csrc/bvh.cu``): one thread per
  ray walks the tree with a short stack, nearer child first.
* :func:`ray_intersect_bvh_plain` is its plain PyTorch version: a frontier
  of (ray, node) pairs expanded level by level, children culled against
  each ray's best so far, leaves swept with the hit test of
  ``intersect.hit_test``.

The JAX package's ray sort, tile-versus-block interval test, fetch lists
and proxy pre-pass exist because TPU lanes cannot index memory per lane
(``psdr_jit_tpu/ops/bvh.py:1-31``); none of them is carried over.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _cuda
from .intersect import (INF, PLAIN_RAY_CHUNK, box_visit, finish_hits,
                        hit_test, miss_like, widen_boxes)

# Triangles per leaf (the last leaf may hold fewer). Chosen on the card
# among 4, 6 and 8 (PERF.md); the kernel reads each leaf's count from the
# table, so any size runs without a rebuild.
LEAF = 4
# K6's traversal stack: a tree of depth <= 32 (up to 2^32 leaves) never
# pushes more entries than that.
STACK = 32
_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class BVH:
    """K6's tree, all on one device.

    ``tri4`` (F, 12) float32: p0, e1, e2 of each triangle, padded to three
    float4. ``node`` (n_internal, 16) float32: for each internal node the
    widened boxes of its two children, each as ``lo.xyz, a, hi.xyz, b``,
    where ``a``, ``b`` are the child's link bit-cast to int32: ``(internal
    node index, 0)`` or, for a leaf, ``(first triangle, -count)``.
    ``root`` (8,) float32: the root's box and link in the same form.
    ``depth``: internal nodes on the longest root-to-leaf path."""

    tri4: torch.Tensor
    node: torch.Tensor
    root: torch.Tensor
    depth: int

    @property
    def tri(self) -> torch.Tensor:
        """The ``(9, F)`` component rows of the triangles (a view)."""
        return self.tri4[:, :9].T


@functools.lru_cache(maxsize=8)
def tree_topology(f: int, leaf: int = LEAF):
    """The tree over ``f`` triangles in leaves of ``leaf`` consecutive ids:
    ``(child (n_int, 2), heights (n_int,), depth)``, numpy int64.

    Nodes are numbered internal nodes first, in depth-first preorder (the
    root is 0, and a left child follows its parent), then the leaves in id
    order: leaf ``k`` is node ``n_int + k`` and holds triangles ``[k *
    leaf, min((k + 1) * leaf, f))``; with one leaf, node 0 is that leaf. A
    range of ``m`` leaves splits into its first ``ceil(m / 2)`` and the
    rest. ``heights`` is each internal node's distance to its farthest
    leaf, ``depth`` the root's."""
    if f <= 0:
        raise ValueError("a tree needs at least one triangle")
    n_leaves = -(-f // leaf)
    n_int = n_leaves - 1
    child = np.zeros((n_int, 2), np.int64)
    heights = np.zeros(n_int, np.int64)
    count = 0

    def split(lo, hi):
        """Leaves [lo, hi) -> (node id, height); recursion depth ~log2."""
        nonlocal count
        if hi - lo == 1:
            return n_int + lo, 0
        me = count
        count += 1
        mid = lo + (hi - lo + 1) // 2
        (a, ha), (b, hb) = split(lo, mid), split(mid, hi)
        child[me] = a, b
        heights[me] = 1 + max(ha, hb)
        return me, heights[me]

    depth = int(split(0, n_leaves)[1])
    return child, heights, depth


def build_bvh(p0, e1, e2, leaf: int = LEAF) -> BVH:
    """K6's tree over (F, 3) triangles in their given order, on their
    device."""
    f = p0.shape[0]
    dev = p0.device
    child_np, heights_np, depth = tree_topology(f, leaf)
    n_int = child_np.shape[0]
    n_leaves = n_int + 1
    v1, v2 = p0 + e1, p0 + e2
    lo, hi = widen_boxes(torch.minimum(torch.minimum(p0, v1), v2),
                         torch.maximum(torch.maximum(p0, v1), v2))
    pad = n_leaves * leaf - f

    def leaves(x, fill, reduce):
        x = torch.cat([x, x.new_full((pad, 3), fill)])
        return reduce(x.reshape(n_leaves, leaf, 3), 1)

    # boxes of every node: internal first, then the leaves
    blo = torch.cat([lo.new_zeros((n_int, 3)),
                     leaves(lo, float("inf"), torch.amin)])
    bhi = torch.cat([hi.new_zeros((n_int, 3)),
                     leaves(hi, float("-inf"), torch.amax)])
    child = torch.tensor(child_np, device=dev)  # copies of the cached arrays
    heights = torch.tensor(heights_np, device=dev)
    for h in range(1, depth + 1):
        ids = torch.nonzero(heights == h).squeeze(1)
        c = child[ids]
        blo[ids] = torch.minimum(blo[c[:, 0]], blo[c[:, 1]])
        bhi[ids] = torch.maximum(bhi[c[:, 0]], bhi[c[:, 1]])

    first = torch.arange(n_leaves, device=dev) * leaf
    link = torch.cat([
        torch.stack([torch.arange(n_int, device=dev),
                     torch.zeros(n_int, dtype=torch.long, device=dev)], 1),
        torch.stack([first, -torch.clamp(f - first, max=leaf)], 1),
    ]).to(torch.int32).view(torch.float32)

    def ref(nodes):
        """``lo.xyz, a, hi.xyz, b`` of the given nodes."""
        return torch.cat([blo[nodes], link[nodes, :1], bhi[nodes],
                          link[nodes, 1:]], dim=1)

    node = torch.cat([ref(child[:, 0]), ref(child[:, 1])], dim=1)
    tri4 = torch.cat([p0, e1, e2, p0.new_zeros((f, 3))], dim=1)
    return BVH(tri4=tri4.contiguous(), node=node.contiguous(),
               root=ref(child.new_zeros(1))[0].contiguous(), depth=depth)


def ray_intersect_bvh_plain(bvh: BVH, ray_o, ray_d, active=None,
                            stats=None):
    """Plain K6 on (N, 3) rays, in chunks of ``PLAIN_RAY_CHUNK`` rays;
    inactive rays report a miss untraced.

    Returns ``(tri_id, valid, uv (N, 2), t)``. ``stats``, a dict if given,
    receives the (ray, triangle) tests (``"tri_tests"``) and the (ray,
    internal node) visits (``"node_visits"``) of this traversal."""
    n = ray_o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=ray_o.device)
    parts = [_traverse(bvh, ray_o[s:s + PLAIN_RAY_CHUNK],
                       ray_d[s:s + PLAIN_RAY_CHUNK],
                       active[s:s + PLAIN_RAY_CHUNK], stats)
             for s in range(0, max(n, 1), PLAIN_RAY_CHUNK)]
    t, ids, u, v = (torch.cat(p) for p in zip(*parts))
    return ids, ids >= 0, torch.stack([u, v], dim=-1), t


def _links(rows):
    """The ``(a, b)`` int32 links of ``lo.xyz, a, hi.xyz, b`` rows."""
    bits = rows.view(torch.int32)
    return bits[..., 3], bits[..., 7]


def _traverse(bvh: BVH, o, d, live, stats):
    """The frontier of (ray, node) pairs, one tree level a step: leaves
    are swept and merged into each ray's best ``(t, id)``; internal nodes
    give the children whose boxes pass against that best."""
    inv = 1.0 / d
    best = list(miss_like(o[:, 0]))
    root = bvh.root[None]
    enter = box_visit(root[:, 0:3], root[:, 4:7], o, inv, best[0],
                      inclusive=True)
    ray = torch.nonzero(live & enter).squeeze(1)
    a, b = (x.expand(ray.shape[0]) for x in _links(root))
    tests = visits = 0
    while ray.numel():
        leaf = b < 0
        at = torch.nonzero(leaf).squeeze(1)
        if at.numel():
            tests += _sweep_leaves(bvh, o, d, ray[at], a[at], -b[at], best)
            at = torch.nonzero(~leaf).squeeze(1)
            ray, a = ray[at], a[at]
        visits += ray.numel()
        # both children of each pair's node: (pairs, 2, 8)
        kids = bvh.node.index_select(0, a.long()).view(-1, 2, 8)
        keep = box_visit(kids[..., 0:3], kids[..., 4:7],
                         o.index_select(0, ray)[:, None],
                         inv.index_select(0, ray)[:, None],
                         best[0].index_select(0, ray)[:, None],
                         inclusive=True)
        at = torch.nonzero(keep.view(-1)).squeeze(1)
        kids = kids.view(-1, 8).index_select(0, at)
        ray = ray.index_select(0, at // 2)
        a, b = _links(kids)
    if stats is not None:
        stats["tri_tests"] = stats.get("tri_tests", 0) + tests
        stats["node_visits"] = stats.get("node_visits", 0) + visits
    return finish_hits(*best)


def _sweep_leaves(bvh: BVH, o, d, ray, first, count, best) -> int:
    """Test each (ray, leaf) pair's triangles and fold the hits into
    ``best`` (a list ``[t, id, u, v]`` over all rays, updated in place)
    by the ``(t, id)`` rule; a ray may reach several leaves at once.
    Returns the (ray, triangle) tests made."""
    k = torch.arange(int(count.max()), device=o.device)
    ok = k[None] < count[:, None]
    j = torch.where(ok, first[:, None] + k[None], first[:, None])
    tri = bvh.tri[:, j]  # (9, pairs, slots)
    t, u, v = hit_test(*tri, *(c[:, None] for c in (
        *o.index_select(0, ray).T, *d.index_select(0, ray).T)))
    t = torch.where(ok, t, INF)
    # each leaf's least t, at its lowest id
    s = torch.argmin(t, dim=1, keepdim=True)
    t, j, u, v = (x.gather(1, s)[:, 0] for x in (t, j, u, v))
    # per ray, the least t, then the least id at that t
    t_min = best[0].scatter_reduce(0, ray, t, "amin")
    at_min = t == t_min[ray]
    id_min = torch.where(best[0] == t_min, best[1], _I32_MAX).scatter_reduce(
        0, ray, torch.where(at_min, j.to(torch.int32), _I32_MAX), "amin")
    win = at_min & (j == id_min[ray]) & (t < INF)
    r = ray[win]
    best[0][r] = t[win]
    best[1][r] = j[win].to(torch.int32)
    best[2][r] = u[win]
    best[3][r] = v[win]
    return int(ok.sum())


def bvh_cuda(bvh: BVH, ray_o, ray_d, active, counts=None):
    """Launch K6: ``(t (N,), id (N,) int32, uv (N, 2))``; lanes with
    ``active`` False report a miss untraced. Equals the plain version bit
    for bit. ``counts``, an (N, 2) int32 tensor if given, receives each
    ray's triangle tests and internal-node visits (a counting build of the
    same traversal)."""
    dev = ray_o.device
    if bvh.depth > STACK:
        raise ValueError(f"K6's stack holds {STACK} entries; the tree is "
                         f"{bvh.depth} deep")
    f = bvh.tri4.shape[0]
    _cuda.require(bvh.tri4, "tri4", torch.float32, (f, 12), dev)
    _cuda.require(bvh.node, "node", torch.float32, (None, 16), dev)
    _cuda.require(bvh.root, "root", torch.float32, (8,), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    if counts is not None:
        _cuda.require(counts, "counts", torch.int32, (n, 2), dev)
    if any(x.data_ptr() % 16 for x in (bvh.tri4, bvh.node, bvh.root)):
        raise ValueError("K6 reads its tables as float4: they must be "
                         "16-byte aligned")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return t, ids, uv
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_bvh(
            bvh.tri4.data_ptr(), bvh.node.data_ptr(), bvh.root.data_ptr(),
            ray_o.data_ptr(), ray_d.data_ptr(), active.data_ptr(), n,
            t.data_ptr(), ids.data_ptr(), uv.data_ptr(),
            None if counts is None else counts.data_ptr(),
            _cuda.stream_of(dev))
    _cuda.check(err, "K6 launch")
    _cuda.LAUNCHES["K6"] += 1
    return t, ids, uv
