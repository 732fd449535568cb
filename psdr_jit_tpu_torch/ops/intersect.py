"""Detached closest-hit ray/triangle intersection (counterpart of
``psdr_jit_tpu/ops/intersect.py``, of the two dense Pallas kernels in
``psdr_jit_tpu/ops/intersect_pallas.py`` and, through ``ops/bvh.py``, of
the block-culled one in ``psdr_jit_tpu/ops/bvh.py``).

The payload is the JAX package's ``(tri_id, valid, uv, t)``: global
triangle ids (-1 = miss), barycentrics and hit distance, all detached.

:func:`ray_intersect_detached` is the entry. It routes on the triangle
count F, with the JAX package's thresholds naming the kernels:

* F <= 512: kernel K1. Up to ``SWEEP_MAX_TRIS`` triangles it sweeps K2's
  staged table with K2's queued culling (``csrc/intersect.cu``,
  :func:`sweep_cuda`); above, it walks a binary tree over the triangles
  split by surface area (leaves of at most ``SAH_LEAF``,
  ``bvh.build_sah_bvh``) with the walk of ``csrc/bvh.cu``
  (``bvh.walk_cuda``);
* 512 < F <= 4096: kernel K5, the same walk on the same kind of tree;
* F > 4096: kernel K6, the same walk on a tree split at the middle
  (leaves of ``bvh.LEAF``, ``bvh.build_bvh``).

The tree comes from :func:`routing_tree`, once per scene compile
(``SceneData.bvh``) or, for bare triangles, per call. On CPU tensors each
route runs its plain PyTorch version: the unculled sweep
:func:`sweep_plain` (through :func:`ray_intersect_brute`) for K1 and K5,
``bvh.ray_intersect_bvh_plain`` for K6. On CUDA tensors the kernels run
or raise. Non-finite and inactive rays report a miss; on the card they are
not swept or walked.

:func:`sweep_grouped_plain` is the plain version of K2's culled sweeps,
and so of K1's sweep (``compact``).

Every version runs THE hit test of ``csrc/sweep.cuh`` (Moller-Trumbore
with ``|a| > 1e-12, u >= 0, v >= 0, u + v <= 1, RAY_EPSILON < t < best``)
and keeps the lowest id of equal distances (the sweeps visit triangles in
ascending id with a strict ``t < best`` or keep the least ``(t, id)``, the
walk compares ``(t, id)``), and every culling box is widened
(:func:`widen_boxes`) so that culling changes no hit: the kernels equal
their plain versions, and the plain versions equal one another, bit for
bit.
"""

from __future__ import annotations

import torch

from ..core.types import RAY_EPSILON
from . import _cuda

INF = 1e30
# Triangles per culling cluster of K2: the table layout of the JAX
# package's build_tables (16-triangle clusters, one AABB each), kept so the
# tables of the two packages compare one to one.
CLUSTER = 16
# The JAX package's routing thresholds: its dense kernel up to K1_MAX_TRIS
# triangles, its super-block kernel up to K5_MAX_TRIS (its BVH_MIN_TRIS),
# its BVH above. Here they name the walk's launches K1, K5 and K6.
K1_MAX_TRIS = 512
K5_MAX_TRIS = 4096
# K1 sweeps up to SWEEP_MAX_TRIS triangles and walks a tree above: the walk
# overtakes the sweep near 130 triangles on camera rays and near 300 on the
# secondary-edge stand-ins on the card (PERF.md); 192, between them,
# is the most K2 stages.
SWEEP_MAX_TRIS = 192
# K1 and K5 walk a tree split by surface area with leaves of at most
# SAH_LEAF triangles: one, 3.5-4% faster a frame than two at 492, 1,292 and
# 3,852 triangles on the card (PERF.md).
SAH_LEAF = 1
# Rays and triangles per block of the plain sweep: its (rays, triangles)
# temporaries stay at 2^24 entries whatever the scene's size.
PLAIN_RAY_CHUNK = 1 << 15
PLAIN_TRI_BLOCK = 512


def pack_triangles(p0, e1, e2):
    """(F, 3) triangle SoA -> ``(tri (9, F_pad), box (6, F_pad // 16))``.

    ``tri`` rows are p0, e1, e2 by component; F is padded to a multiple of
    16 with degenerate (never hit) triangles at the origin. ``box`` rows
    are each 16-triangle cluster's AABB lower then upper corner."""
    f = p0.shape[0]
    f_pad = -(-f // CLUSTER) * CLUSTER

    def pad(x):
        return torch.cat([x, x.new_zeros((f_pad - f, 3))]) if f_pad != f else x

    p0, e1, e2 = pad(p0), pad(e1), pad(e2)
    tri = torch.cat([p0.T, e1.T, e2.T], dim=0).contiguous()
    nc = f_pad // CLUSTER
    v0 = p0.reshape(nc, CLUSTER, 3)
    v1 = (p0 + e1).reshape(nc, CLUSTER, 3)
    v2 = (p0 + e2).reshape(nc, CLUSTER, 3)
    lo = torch.minimum(torch.minimum(v0.amin(1), v1.amin(1)), v2.amin(1))
    hi = torch.maximum(torch.maximum(v0.amax(1), v1.amax(1)), v2.amax(1))
    box = torch.cat([lo.T, hi.T], dim=0).contiguous()
    return tri, box


def _fma(a, b, c):
    """a * b + c rounded once (the product of two f32 is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def widen_boxes(lo, hi):
    """Widen AABB corners by ``1e-3 * (1 + max(|lo|, |hi|))`` on each side,
    per coordinate: the margin that keeps f32 rounding of the slab test and
    of the barycentrics from culling a reported hit (``csrc/sweep.cuh``
    ``box_margin``)."""
    m = 1e-3 * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    return lo - m, hi + m


def box_visit(lo, hi, o, inv, best, inclusive: bool = False):
    """THE slab test of ``csrc/sweep.cuh`` ``box_visit``, broadcast: may a
    hit closer than ``best`` lie in the box ``[lo, hi]`` (..., 3)? A NaN
    (origin on a slab plane of an axis-aligned ray) means "visit".
    ``inclusive`` takes ``tnear <= best`` instead of ``<``, as K6's
    ``box_enter`` does: a hit at exactly ``best`` with a lower id must
    still be reached."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    undecided = torch.isnan(t0).any(-1) | torch.isnan(t1).any(-1)
    tnear = torch.minimum(t0, t1).amax(-1)
    tfar = torch.maximum(t0, t1).amin(-1)
    near = (tnear <= best) if inclusive else (tnear < best)
    return undecided | ((tnear <= tfar) & (tfar > 0.0) & near)


def hit_test(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx,
             dy, dz):
    """THE hit test of ``csrc/sweep.cuh``, elementwise under broadcasting:
    ``(t, u, v)`` with ``t = INF`` where the ray misses the triangle."""
    hx = _fma(dy, e2z, -(dz * e2y))
    hy = _fma(dz, e2x, -(dx * e2z))
    hz = _fma(dx, e2y, -(dy * e2x))
    a = _fma(e1z, hz, _fma(e1x, hx, e1y * hy))
    f = 1.0 / a
    sx = ox - p0x
    sy = oy - p0y
    sz = oz - p0z
    u = f * _fma(sz, hz, _fma(sy, hy, sx * hx))
    qx = _fma(sy, e1z, -(sz * e1y))
    qy = _fma(sz, e1x, -(sx * e1z))
    qz = _fma(sx, e1y, -(sy * e1x))
    v = f * _fma(dz, qz, _fma(dx, qx, dy * qy))
    t = f * _fma(e2z, qz, _fma(e2x, qx, e2y * qy))
    hit = ((a.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > RAY_EPSILON) & (t < INF))
    return torch.where(hit, t, INF), u, v


def _sweep_block(tri, ox, oy, oz, dx, dy, dz):
    """Closest hit of rays (component vectors) against the triangles of a
    ``(9, k)`` table: ``(t, local id, u, v)``, the lowest id of equal
    distances."""
    t, u, v = hit_test(*(tri[k][None, :] for k in range(9)),
                       *(c[:, None] for c in (ox, oy, oz, dx, dy, dz)))
    j = torch.argmin(t, dim=1, keepdim=True)  # first (lowest-id) minimum
    bt = t.gather(1, j)[:, 0]
    return bt, j[:, 0].to(torch.int32), u.gather(1, j)[:, 0], v.gather(1, j)[:, 0]


def merge_hits(best, cand, base: int = 0):
    """Running closest hit: ``cand = (t, local id, u, v)`` replaces ``best
    = (t, id, u, v)`` where strictly closer; its ids are offset by
    ``base``. Visiting blocks in ascending id keeps the lowest id of equal
    distances, as the kernels' strict ``t < best`` does."""
    closer = cand[0] < best[0]
    return (torch.where(closer, cand[0], best[0]),
            torch.where(closer, cand[1] + base, best[1]),
            torch.where(closer, cand[2], best[2]),
            torch.where(closer, cand[3], best[3]))


def miss_like(x):
    """The payload of a miss for rays shaped like ``x`` (n,):
    ``(t = 1e30, id = -1, u = 0, v = 0)``."""
    return (torch.full_like(x, INF), torch.full_like(x, -1, dtype=torch.int32),
            torch.zeros_like(x), torch.zeros_like(x))


def finish_hits(t, ids, u, v):
    """Misses report ``id = -1`` and ``u = v = 0``."""
    miss = ~(t < INF)
    return (t, torch.where(miss, -1, ids), torch.where(miss, 0.0, u),
            torch.where(miss, 0.0, v))


def sweep_plain(tri, o, d):
    """Plain closest-hit sweep over a packed ``(9, F)`` table for rays
    given as component tuples ``o = (ox, oy, oz)``, ``d`` (each ``(n,)``),
    unculled: rays in chunks of ``PLAIN_RAY_CHUNK``, each scanning the
    triangles in blocks of ``PLAIN_TRI_BLOCK`` with a running hit, so its
    memory stays bounded at 10^5 triangles. The plain version of K1 and of
    K5.

    Returns ``(t, id, u, v)``: ``t = 1e30``, ``id = -1``, ``u = v = 0``
    for a miss."""
    n = o[0].shape[0]
    f = tri.shape[1]
    parts = []
    for s in range(0, max(n, 1), PLAIN_RAY_CHUNK):
        comps = [c[s:s + PLAIN_RAY_CHUNK] for c in (*o, *d)]
        best = miss_like(comps[0])
        for b in range(0, f, PLAIN_TRI_BLOCK):
            best = merge_hits(best, _sweep_block(
                tri[:, b:b + PLAIN_TRI_BLOCK], *comps), b)
        parts.append(finish_hits(*best))
    return tuple(torch.cat(p) for p in zip(*parts))


def group_boxes(tri, group: int):
    """Widened boxes ``(lo, hi)``, each ``(F_pad // group, 3)``, of the runs
    of ``group`` consecutive triangles of a packed ``(9, F_pad)`` table,
    computed as K2 computes them when it stages the table
    (``csrc/megakernel.cu``): the vertices ``p0``, ``p0 + e1``, ``p0 + e2``
    in f32, their least and greatest coordinate over the run, widened by
    :func:`widen_boxes`. At ``group = CLUSTER`` they are the cluster boxes
    of :func:`pack_triangles`, widened."""
    p0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    v1, v2 = p0 + e1, p0 + e2
    lo = torch.minimum(torch.minimum(p0, v1), v2).reshape(-1, group, 3)
    hi = torch.maximum(torch.maximum(p0, v1), v2).reshape(-1, group, 3)
    return widen_boxes(lo.amin(1), hi.amax(1))


def sweep_grouped_plain(tri, o, d, group: int, stats=None, live=None,
                        compact: bool = False):
    """K2's culled sweeps in plain PyTorch. Each 16-triangle cluster's
    widened box is tested, then inside a visited cluster each
    ``group``-triangle run's widened box (:func:`group_boxes`; none at
    ``group = CLUSTER``), then the run's triangles. By default against the
    running hit, in ascending id with its strict ``t < best``, as
    ``csrc/sweep.cuh`` ``sweep_grouped`` and ``sweep`` visit them;
    ``compact``: with no hit to cull against, the closest of the tested
    hits kept by ``(t, id)``, as ``sweep_queued``. Rays as in
    :func:`sweep_plain`, whose hits both return bit for bit: culling with
    widened boxes changes no hit.

    ``stats``, a dict, gets the visits added up over the rays that
    ``live`` (n,) bool selects (all by default): ``rays``, ``box_tests``
    (cluster and run boxes) and ``tri_tests`` of each ray, and
    ``warp_tri_tests``, the tests each lane of a warp runs, the warp being
    rays ``32 w .. 32 w + 31`` in the given order: by default ``group``
    times the runs any of its live rays visits (the warp-decided culling),
    ``compact``: ``group`` times the rounds of 32 (ray, run) pairs its live
    rays queue."""
    n = o[0].shape[0]
    f = tri.shape[1]
    clo, chi = group_boxes(tri, CLUSTER)
    glo, ghi = group_boxes(tri, group)
    per = CLUSTER // group
    two_level = group != CLUSTER
    parts = []
    for s in range(0, max(n, 1), PLAIN_RAY_CHUNK):
        comps = [c[s:s + PLAIN_RAY_CHUNK] for c in (*o, *d)]
        ro = torch.stack(comps[:3], -1)
        inv = 1.0 / torch.stack(comps[3:], -1)
        m = ro.shape[0]
        on = (torch.ones(m, dtype=torch.bool, device=ro.device)
              if live is None else live[s:s + PLAIN_RAY_CHUNK])
        pad = -m % 32
        best = miss_like(comps[0])
        nowhere = torch.full_like(comps[0], INF)
        pairs = torch.zeros((m + pad) // 32, dtype=torch.int64,
                            device=ro.device)
        boxes = tests = warp_tests = 0
        for c in range(f // CLUSTER):
            vis_c = box_visit(clo[c], chi[c], ro, inv,
                              nowhere if compact else best[0])
            boxes += int(on.sum()) + (per * int((vis_c & on).sum())
                                      if two_level else 0)
            for j in range(c * per, (c + 1) * per):
                vis = (vis_c & box_visit(glo[j], ghi[j], ro, inv,
                                         nowhere if compact else best[0])
                       if two_level else vis_c)
                cand = _sweep_block(tri[:, j * group:(j + 1) * group], *comps)
                cand = tuple(torch.where(vis, x, y)
                             for x, y in zip(cand, miss_like(comps[0])))
                best = merge_hits(best, cand, j * group)
                counted = torch.nn.functional.pad(vis & on, (0, pad)).reshape(
                    -1, 32)
                tests += group * int(counted.sum())
                if compact:
                    pairs += counted.sum(1)
                else:
                    warp_tests += group * int(counted.any(1).sum())
        if compact:
            warp_tests = group * int(((pairs + 31) // 32).sum())
        if stats is not None:
            for k, v in (("rays", int(on.sum())), ("box_tests", boxes),
                         ("tri_tests", tests), ("warp_tri_tests",
                                                warp_tests)):
                stats[k] = stats.get(k, 0) + v
        parts.append(finish_hits(*best))
    return tuple(torch.cat(p) for p in zip(*parts))


def ray_intersect_brute(p0, e1, e2, ray_o, ray_d, active=None):
    """Plain closest hit of (N, 3) rays against (F, 3) triangles, unculled;
    inactive rays (``active`` (N,) bool) report a miss.

    Returns ``(tri_id (N,) int32, valid (N,) bool, uv (N, 2), t (N,))``."""
    tri, _ = pack_triangles(p0, e1, e2)
    t, tri_id, u, v = sweep_plain(tri, ray_o.unbind(-1), ray_d.unbind(-1))
    if active is not None:
        t, tri_id, u, v = (torch.where(active, x, m) for x, m in
                           zip((t, tri_id, u, v), miss_like(t)))
    return tri_id, tri_id >= 0, torch.stack([u, v], dim=-1), t


def sweep_cuda(tri, box, ray_o, ray_d, active):
    """Launch K1's sweep (``csrc/intersect.cu``) on a packed table
    (:func:`pack_triangles`): ``(t (N,), id (N,) int32, uv (N, 2))``, lanes
    with ``active`` False reporting a miss unswept. Equals the plain sweep
    bit for bit. The routing takes it up to ``SWEEP_MAX_TRIS`` triangles;
    it runs up to ``K1_MAX_TRIS``."""
    dev = ray_o.device
    f_pad = tri.shape[1]
    if f_pad % CLUSTER or not 0 < f_pad <= K1_MAX_TRIS:
        raise ValueError(f"K1 sweeps 1..{K1_MAX_TRIS} triangles padded to a "
                         f"multiple of {CLUSTER}, got {f_pad}")
    _cuda.require(tri, "tri", torch.float32, (9, f_pad), dev)
    _cuda.require(box, "box", torch.float32, (6, f_pad // CLUSTER), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    if n >= 1 << 31:
        raise ValueError(f"K1 queues active rays as int32: {n} rays")
    return k1_sweep_op(tri, box, ray_o, ray_d, active)


def hit_outputs(ray_o):
    """Empty ``(t (N,), id (N,) int32, uv (N, 2))`` beside ``ray_o``."""
    n = ray_o.shape[0]
    return (ray_o.new_empty(n), ray_o.new_empty(n, dtype=torch.int32),
            ray_o.new_empty((n, 2)))


@_cuda.kernel_op("k1_sweep", "(Tensor tri, Tensor box, Tensor ray_o, "
                 "Tensor ray_d, Tensor active) -> (Tensor, Tensor, Tensor)")
def k1_sweep_op(tri, box, ray_o, ray_d, active):
    """K1's launch, the operator behind :func:`sweep_cuda` (which checks
    its inputs)."""
    dev = ray_o.device
    t, ids, uv = hit_outputs(ray_o)
    n = ray_o.shape[0]
    if n == 0:
        return t, ids, uv
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_sweep(
            tri.data_ptr(), box.data_ptr(), tri.shape[1], ray_o.data_ptr(),
            ray_d.data_ptr(), active.data_ptr(), n, t.data_ptr(),
            ids.data_ptr(), uv.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K1 launch")
    _cuda.LAUNCHES["K1"] += 1
    return t, ids, uv


@k1_sweep_op.register_fake
def _(tri, box, ray_o, ray_d, active):
    return hit_outputs(ray_o)


def needs_tree(f: int, device) -> bool:
    """Whether :func:`ray_intersect_detached` walks a tree for ``f``
    triangles on ``device``: on the card above ``SWEEP_MAX_TRIS`` (K1's
    walk, K5, K6), on the CPU only for K6's plain version, above
    ``K5_MAX_TRIS`` (K1's and K5's plain version is the unculled sweep)."""
    cpu = torch.device(device).type == "cpu"
    return f > (K5_MAX_TRIS if cpu else SWEEP_MAX_TRIS)


def routing_tree(p0, e1, e2):
    """The tree :func:`ray_intersect_detached` walks for these (F, 3)
    triangles: ``bvh.build_sah_bvh`` (leaves of at most ``SAH_LEAF`` split
    by surface area) for K1 and K5, F <= ``K5_MAX_TRIS``;
    ``bvh.build_bvh`` (leaves of ``bvh.LEAF`` split at the middle) for
    K6."""
    from . import bvh

    if p0.shape[0] <= K5_MAX_TRIS:
        return bvh.build_sah_bvh(p0, e1, e2, SAH_LEAF)
    return bvh.build_bvh(p0, e1, e2)


def walk_name(f: int) -> str:
    """The kernel name of the closest hit over ``f`` triangles: K1, K5 or
    K6."""
    return ("K1" if f <= K1_MAX_TRIS else "K5" if f <= K5_MAX_TRIS
            else "K6")


def ray_intersect_detached(p0, e1, e2, ray, active=None, tree=None):
    """Closest hit of ``ray`` (``(..., 3)`` o/d) against (F, 3) triangles,
    routed on F (module docstring): the kernels for CUDA tensors, the plain
    versions for CPU tensors. Non-finite and inactive rays report a miss
    (``tri_id = -1``, ``valid = False``); the kernels skip them, the plain
    versions sweep a ray from the origin along +z in their place. ``tree``,
    the :func:`routing_tree` of these triangles, is built here where the
    route walks one (:func:`needs_tree`) and none is given.
    Returns ``(tri_id, valid, uv (..., 2), t)``."""
    from . import bvh

    o, d = ray.o.detach(), ray.d.detach()
    shape = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    live = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    if active is not None:
        live = live & active.reshape(-1)
    p0, e1, e2 = p0.detach(), e1.detach(), e2.detach()
    f = p0.shape[0]
    if tree is None and needs_tree(f, o.device):
        tree = routing_tree(p0, e1, e2)
    if o.device.type == "cpu":
        unit_z = d.new_zeros(3)
        unit_z[2] = 1.0
        o = torch.where(live[:, None], o, 0.0)
        d = torch.where(live[:, None], d, unit_z)
        if f <= K5_MAX_TRIS:
            tri_id, _, uv, t = ray_intersect_brute(p0, e1, e2, o, d, live)
        else:
            tri_id, _, uv, t = bvh.ray_intersect_bvh_plain(tree, o, d, live)
    elif f <= SWEEP_MAX_TRIS:
        tri, box = pack_triangles(p0, e1, e2)
        t, tri_id, uv = sweep_cuda(tri, box, o.contiguous(), d.contiguous(),
                                   live.contiguous())
    else:
        t, tri_id, uv = bvh.walk_cuda(tree, o.contiguous(), d.contiguous(),
                                      live.contiguous(), kernel=walk_name(f))
    valid = tri_id >= 0
    return (tri_id.reshape(shape), valid.reshape(shape),
            uv.reshape(shape + (2,)), t.reshape(shape))
