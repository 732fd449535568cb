"""Closest hit through a per-ray walk of a binary tree over the
triangles: K1 (192 < F <= 512), K5 (F <= 4096) and K6 (counterpart of
``ray_intersect_bvh`` in ``psdr_jit_tpu/ops/bvh.py`` and of the dense and
super-block sweeps of ``intersect_pallas.py``).

Both trees cut the triangles, in their given order (the scene's Morton
order above 256 faces), into leaves of consecutive ids and build a binary
tree over the leaves: K6's (:func:`build_bvh`), leaves of ``LEAF`` ids and
each range of leaves split at its midpoint, a topology that depends on the
triangle count and the leaf size alone (:func:`tree_topology`, cached);
K1's and K5's (:func:`build_sah_bvh`), leaves of at most
``intersect.SAH_LEAF`` ids, each range split where the surface-area cost
is least (:func:`sah_topology`), which halved K5's node visits (PERF.md).
On the card the area-split tree is built on the host by the kernel
library's ``psdr_sah_build`` (the same tables bit for bit, in
microseconds); elsewhere by numpy. The boxes are a bottom-up reduction of
the triangles' widened boxes (``intersect.widen_boxes``, the margin of
every culling box of the port). ``SceneData.bvh`` builds the tree once
per scene compile.

The node table holds no padding: every node is reached by its parent's
link, so no box is ever tested for a node that does not exist (an inverted
``+inf``/``-inf`` box would pass the slab test, whose min and max swap).

Culling is conservative and a hit replaces the best one when its ``(t,
id)`` is lexicographically smaller, which is the ascending sweep's choice
(the lowest id of equal distances) in any visit order; a box is entered
while ``tnear <= best``, so an equal-distance hit with a lower id is still
reached. So every version equals the unculled sweep bit for bit.

* :func:`walk_cuda` launches the walk of ``csrc/bvh.cu``: one thread per
  active ray walks the tree with a short stack, nearer child first. It is
  K1 (above
  ``intersect.SWEEP_MAX_TRIS`` triangles) or K5 on the area-split tree and
  K6 on the midpoint tree (``intersect.routing_tree``), and counts its
  launches under the name it is given.
* :func:`ray_intersect_bvh_plain` is its plain PyTorch version: a frontier
  of (ray, node) pairs expanded level by level, children culled against
  each ray's best so far, leaves swept with the hit test of
  ``intersect.hit_test``.

The JAX package's ray sort, tile-versus-block interval test, fetch lists
and proxy pre-pass exist because TPU lanes cannot index memory per lane
(``psdr_jit_tpu/ops/bvh.py:1-31``); none of them is carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import _cuda
from .intersect import (INF, K1_MAX_TRIS, K5_MAX_TRIS, PLAIN_RAY_CHUNK,
                        SAH_LEAF, box_visit, finish_hits, hit_outputs,
                        hit_test, miss_like, widen_boxes)

# Triangles per leaf (the last leaf may hold fewer). Chosen on the card
# among 4, 6 and 8 (PERF.md); the kernel reads each leaf's count from the
# table, so any size runs without a rebuild.
LEAF = 4
# The walk's stack: a tree of depth <= 32 (up to 2^32 leaves) never
# pushes more entries than that; sah_topology builds no deeper tree.
STACK = 32
# The cost of an internal node's visit (two box tests) in triangle tests,
# for sah_topology's choice between a leaf and a split.
SAH_NODE_COST = 1.0
_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class BVH:
    """The tree K1, K5 and K6 walk, all on one device.

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


def sah_topology(lo, hi, max_leaf: int):
    """A tree over triangles with boxes ``(lo, hi)`` ((F, 3) numpy) in
    their given order, split by surface area: ``(child (n_int, 2), heights
    (n_int,), depth, runs (n_leaves, 2))``, child and heights as in
    :func:`tree_topology`, leaf ``k`` (node ``n_int + k``) holding the
    ``runs[k, 1]`` triangles from ``runs[k, 0]``.

    Each range of triangles splits where ``area(left) * |left| +
    area(right) * |right|`` is least; a range of at most ``max_leaf``
    triangles stays a leaf where testing its triangles costs no more than
    a node visit (``SAH_NODE_COST`` triangle tests) and the tests its
    children would cost, area-weighted. No path holds more than ``STACK``
    internal nodes, the walk's stack: a split leaves each side at most
    ``max_leaf * 2 ** (budget - 1)`` triangles."""
    f = lo.shape[0]
    if f > max_leaf << STACK:
        raise ValueError(f"{f} triangles do not fit a tree {STACK} deep")
    child, heights, runs = [], [], []

    def area(a, b):
        e = b - a
        return (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2]
                + e[..., 2] * e[..., 0])

    def split(first, end, budget):
        """Triangles [first, end) -> (node, height); a leaf is -1 - its
        index until every internal node is numbered."""
        m = end - first
        if m == 1 or budget == 0:
            runs.append((first, m))
            return -len(runs), 0
        a, b = lo[first:end], hi[first:end]
        left = area(np.minimum.accumulate(a)[:-1],
                    np.maximum.accumulate(b)[:-1])
        right = area(np.minimum.accumulate(a[::-1])[::-1][1:],
                     np.maximum.accumulate(b[::-1])[::-1][1:])
        k = np.arange(1, m)
        cap = max_leaf << (budget - 1)
        cost = np.where((k <= cap) & (m - k <= cap),
                        left * k + right * (m - k), np.inf)
        at = int(np.argmin(cost))
        whole = area(a.min(0), b.max(0))
        split_cost = SAH_NODE_COST + cost[at] / max(whole, 1e-30)
        if m <= max_leaf and m <= split_cost:
            runs.append((first, m))
            return -len(runs), 0
        me = len(child)
        child.append(None)
        heights.append(0)
        (c0, h0), (c1, h1) = (split(first, first + 1 + at, budget - 1),
                              split(first + 1 + at, end, budget - 1))
        child[me] = (c0, c1)
        heights[me] = 1 + max(h0, h1)
        return me, heights[me]

    depth = split(0, f, STACK)[1]
    child = np.array(child, np.int64).reshape(-1, 2)
    child = np.where(child < 0, len(child) - 1 - child, child)
    return (child, np.array(heights, np.int64), int(depth),
            np.array(runs, np.int64).reshape(-1, 2))


def _triangle_boxes(p0, e1, e2):
    """The widened boxes ``(lo, hi)`` of (F, 3) triangles."""
    v1, v2 = p0 + e1, p0 + e2
    return widen_boxes(torch.minimum(torch.minimum(p0, v1), v2),
                       torch.maximum(torch.maximum(p0, v1), v2))


def build_bvh(p0, e1, e2, leaf: int = LEAF) -> BVH:
    """K6's tree over (F, 3) triangles in their given order, on their
    device: leaves of ``leaf`` consecutive triangles, each range of leaves
    split at its middle (:func:`tree_topology`)."""
    f = p0.shape[0]
    lo, hi = _triangle_boxes(p0, e1, e2)
    child, heights, depth = tree_topology(f, leaf)
    n_leaves = child.shape[0] + 1
    pad = n_leaves * leaf - f

    def leaves(x, fill, reduce):
        x = torch.cat([x, x.new_full((pad, 3), fill)])
        return reduce(x.reshape(n_leaves, leaf, 3), 1)

    first = torch.arange(n_leaves, device=p0.device) * leaf
    return _assemble(p0, e1, e2, leaves(lo, float("inf"), torch.amin),
                     leaves(hi, float("-inf"), torch.amax), first,
                     torch.clamp(f - first, max=leaf), child, heights, depth)


def build_sah_bvh(p0, e1, e2, leaf: int = SAH_LEAF) -> BVH:
    """K1's and K5's tree over (F, 3) triangles in their given order, on
    their device: leaves of at most ``leaf`` consecutive triangles, each
    range split by surface area (:func:`sah_topology`, at most ``STACK``
    deep). For CUDA tensors the kernel library builds it on the host
    (``psdr_sah_build``, the same tables bit for bit)."""
    dev = p0.device
    if dev.type == "cuda":
        return _sah_bvh_native(p0, e1, e2, leaf)
    lo, hi = (x.cpu().numpy() for x in _triangle_boxes(p0, e1, e2))
    child, heights, depth, runs = sah_topology(
        lo.astype(np.float64), hi.astype(np.float64), leaf)
    first, count = torch.from_numpy(runs).to(dev).unbind(1)
    llo, lhi = (torch.from_numpy(r.reduceat(x, runs[:, 0])).to(dev)
                for r, x in ((np.minimum, lo), (np.maximum, hi)))
    return _assemble(p0, e1, e2, llo, lhi, first, count, child, heights,
                     depth)


def _tri4(p0, e1, e2):
    """The ``(F, 12)`` rows p0, e1, e2, 0 of the triangles."""
    return torch.cat([p0, e1, e2, p0.new_zeros((p0.shape[0], 3))],
                     dim=1).contiguous()


def _sah_bvh_native(p0, e1, e2, leaf: int) -> BVH:
    """:func:`build_sah_bvh` through the kernel library's host builder:
    the triangles are copied to the host once, the tables back once."""
    f = p0.shape[0]
    tri = torch.cat([p0, e1, e2], dim=1).to(torch.float32).cpu().numpy()
    node = np.empty((max(f - 1, 1), 16), np.float32)
    root = np.empty(8, np.float32)
    n_int, depth = ctypes.c_int(), ctypes.c_int()
    lib = _cuda.library()
    if lib.psdr_sah_build(tri.ctypes.data, f, leaf, STACK, SAH_NODE_COST,
                          node.ctypes.data, root.ctypes.data,
                          ctypes.byref(n_int), ctypes.byref(depth)) != 0:
        raise ValueError(f"{f} triangles do not fit a tree {STACK} deep")
    dev = p0.device
    return BVH(tri4=_tri4(p0, e1, e2),
               node=torch.from_numpy(node[:n_int.value]).to(dev),
               root=torch.from_numpy(root).to(dev), depth=depth.value)


def _assemble(p0, e1, e2, llo, lhi, first, count, child_np, heights_np,
              depth) -> BVH:
    """The tree's tables from its leaves (boxes ``llo``, ``lhi``, the
    ``count`` triangles from ``first`` of each) and its topology
    (``child``, ``heights``, ``depth`` as :func:`tree_topology` gives
    them)."""
    f = p0.shape[0]
    dev = p0.device
    n_int = child_np.shape[0]
    # boxes of every node: internal first, then the leaves
    blo = torch.cat([llo.new_zeros((n_int, 3)), llo])
    bhi = torch.cat([lhi.new_zeros((n_int, 3)), lhi])
    child = torch.tensor(child_np, device=dev)  # copies of the cached arrays
    heights = torch.tensor(heights_np, device=dev)
    for h in range(1, depth + 1):
        ids = torch.nonzero(heights == h).squeeze(1)
        c = child[ids]
        blo[ids] = torch.minimum(blo[c[:, 0]], blo[c[:, 1]])
        bhi[ids] = torch.maximum(bhi[c[:, 0]], bhi[c[:, 1]])

    link = torch.cat([
        torch.stack([torch.arange(n_int, device=dev),
                     torch.zeros(n_int, dtype=torch.long, device=dev)], 1),
        torch.stack([first, -count], 1),
    ]).to(torch.int32).view(torch.float32)

    def ref(nodes):
        """``lo.xyz, a, hi.xyz, b`` of the given nodes."""
        return torch.cat([blo[nodes], link[nodes, :1], bhi[nodes],
                          link[nodes, 1:]], dim=1)

    node = torch.cat([ref(child[:, 0]), ref(child[:, 1])], dim=1)
    return BVH(tri4=_tri4(p0, e1, e2), node=node.contiguous(),
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


def walk_cuda(bvh: BVH, ray_o, ray_d, active, counts=None, kernel="K6"):
    """Launch the tree walk of ``csrc/bvh.cu`` on ``bvh`` as ``kernel``,
    adding one to ``_cuda.LAUNCHES[kernel]``: ``"K1"`` or ``"K5"`` on the
    area-split tree over at most ``K1_MAX_TRIS`` triangles or ``K1_MAX_TRIS
    < F <= K5_MAX_TRIS``, ``"K6"`` on any tree (the routing gives it K6's,
    above ``K5_MAX_TRIS``). Returns ``(t (N,), id (N,) int32, uv (N, 2))``;
    lanes with ``active`` False report a miss and are not walked. Equals
    the plain versions bit for bit. ``counts``, an (N, 2) int32 tensor if
    given, receives each ray's triangle tests and internal-node visits (a
    counting build of the same walk)."""
    dev = ray_o.device
    f = bvh.tri4.shape[0]
    ranges = {"K1": (1, K1_MAX_TRIS), "K5": (K1_MAX_TRIS + 1, K5_MAX_TRIS),
              "K6": (1, None)}
    if kernel not in ranges:
        raise ValueError(f"the tree walk is K1, K5 or K6, not {kernel!r}")
    lo, hi = ranges[kernel]
    if f < lo or (hi is not None and f > hi):
        raise ValueError(f"{kernel} takes {lo}..{hi} triangles, got {f}")
    if bvh.depth > STACK:
        raise ValueError(f"the walk's stack holds {STACK} entries; the tree "
                         f"is {bvh.depth} deep")
    _cuda.require(bvh.tri4, "tri4", torch.float32, (f, 12), dev)
    _cuda.require(bvh.node, "node", torch.float32, (None, 16), dev)
    _cuda.require(bvh.root, "root", torch.float32, (8,), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    if counts is not None:
        _cuda.require(counts, "counts", torch.int32, (n, 2), dev)
    t, ids, uv, c = walk_op(bvh.tri4, bvh.node, bvh.root, ray_o, ray_d,
                            active, kernel, counts is not None)
    if counts is not None:
        counts.copy_(c)
    return t, ids, uv


def _walk_outputs(ray_o, count: bool):
    n = ray_o.shape[0]
    return (*hit_outputs(ray_o),
            ray_o.new_empty((n if count else 0, 2), dtype=torch.int32))


@_cuda.kernel_op("walk", "(Tensor tri4, Tensor node, Tensor root, "
                 "Tensor ray_o, Tensor ray_d, Tensor active, str kernel, "
                 "bool count) -> (Tensor, Tensor, Tensor, Tensor)")
def walk_op(tri4, node, root, ray_o, ray_d, active, kernel, count):
    """The walk's launch as ``kernel``, the operator behind
    :func:`walk_cuda` (which checks its inputs): ``(t, id, uv, counts)``,
    ``counts`` (N, 2) with ``count`` and (0, 2) without."""
    if any(x.data_ptr() % 16 for x in (tri4, node, root)):
        raise ValueError("the walk reads its tables as float4: they must be "
                         "16-byte aligned")
    dev = ray_o.device
    t, ids, uv, counts = _walk_outputs(ray_o, count)
    n = ray_o.shape[0]
    if n == 0:
        return t, ids, uv, counts
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_bvh(
            tri4.data_ptr(), node.data_ptr(), root.data_ptr(),
            ray_o.data_ptr(), ray_d.data_ptr(), active.data_ptr(), n,
            t.data_ptr(), ids.data_ptr(), uv.data_ptr(),
            counts.data_ptr() if count else None, _cuda.stream_of(dev))
    _cuda.check(err, f"{kernel} launch")
    _cuda.LAUNCHES[kernel] += 1
    return t, ids, uv, counts


@walk_op.register_fake
def _(tri4, node, root, ray_o, ray_d, active, kernel, count):
    return _walk_outputs(ray_o, count)
