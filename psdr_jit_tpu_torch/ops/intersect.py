"""Detached closest-hit ray/triangle intersection (counterpart of
``psdr_jit_tpu/ops/intersect.py``, of the two dense Pallas kernels in
``psdr_jit_tpu/ops/intersect_pallas.py`` and, through ``ops/bvh.py``, of
the block-culled one in ``psdr_jit_tpu/ops/bvh.py``).

The payload is the JAX package's ``(tri_id, valid, uv, t)``: global
triangle ids (-1 = miss), barycentrics and hit distance, all detached.

:func:`ray_intersect_detached` is the entry. It routes on the triangle
count F, with the JAX package's thresholds:

* F <= 512: kernel K1 (``csrc/intersect.cu``), the whole table staged in
  shared memory;
* 512 < F <= 4096: kernel K5 (``csrc/intersect_super.cu``), the table
  streamed through shared memory in 512-triangle super-blocks;
* F > 4096: kernel K6 (``csrc/bvh.cu``, ``ops/bvh.py``), a per-ray
  traversal of a binary tree over the triangles, built once per scene
  compile (``SceneData.bvh``) or, for bare triangles, per call.

On CPU tensors each route runs its plain PyTorch version: the unculled
sweep :func:`sweep_plain` (through :func:`ray_intersect_brute`) for K1 and
K5, ``bvh.ray_intersect_bvh_plain`` for K6. On CUDA tensors each launches
its kernel or raises. Non-finite and inactive rays report a miss.

Every version runs THE hit test of ``csrc/sweep.cuh`` (Moller-Trumbore
with ``|a| > 1e-12, u >= 0, v >= 0, u + v <= 1, RAY_EPSILON < t < best``)
and keeps the lowest id of equal distances (the sweeps visit triangles in
ascending id with a strict ``t < best``, K6 compares ``(t, id)``), and
every culling box is widened (:func:`widen_boxes`) so that culling changes
no hit: the kernels equal their plain versions, and the plain versions
equal one another, bit for bit.
"""

from __future__ import annotations

import torch

from ..core.types import RAY_EPSILON
from . import _cuda

INF = 1e30
# Triangles per culling cluster of K1 and K5: the table layout of the JAX
# package's build_tables (16-triangle clusters, one AABB each), kept so the
# tables of the two packages compare one to one. The CUDA sweeps cull per
# ray.
CLUSTER = 16
# K1 stages the whole (9, F) triangle table in shared memory: 512
# triangles are 18 KiB, under the 48 KiB a block gets without opting in.
K1_MAX_TRIS = 512
# K5 streams 512-triangle super-blocks (18 KiB each) through shared memory;
# above K5_MAX_TRIS triangles K6's hierarchy takes over (the JAX package's
# BVH_MIN_TRIS).
SUPER = 512
K5_MAX_TRIS = 4096
# Rays and triangles per block of the plain sweep: its (rays, triangles)
# temporaries stay at 2^24 entries whatever the scene's size.
PLAIN_RAY_CHUNK = 1 << 15
PLAIN_TRI_BLOCK = 512


def pack_triangles(p0, e1, e2, multiple: int = CLUSTER):
    """(F, 3) triangle SoA -> ``(tri (9, F_pad), box (6, F_pad // 16))``.

    ``tri`` rows are p0, e1, e2 by component; F is padded to a multiple of
    ``multiple`` (of 16) with degenerate (never hit) triangles at the
    origin. ``box`` rows are each 16-triangle cluster's AABB lower then
    upper corner."""
    f = p0.shape[0]
    f_pad = -(-f // multiple) * multiple

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


def intersect_cuda(tri, box, ray_o, ray_d):
    """Launch K1 on a packed table: ``(t (N,), id (N,) int32, uv (N, 2))``.
    Same payload as the plain sweep, which it equals bit for bit."""
    dev = ray_o.device
    f_pad = tri.shape[1]
    if f_pad % CLUSTER or not 0 < f_pad <= K1_MAX_TRIS:
        raise ValueError(f"K1 takes 1..{K1_MAX_TRIS} triangles padded to "
                         f"a multiple of {CLUSTER}, got {f_pad}")
    _cuda.require(tri, "tri", torch.float32, (9, f_pad), dev)
    _cuda.require(box, "box", torch.float32, (6, f_pad // CLUSTER), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (None, 3), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    ids = torch.empty(n, dtype=torch.int32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if n == 0:
        return t, ids, uv
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_intersect(
            tri.data_ptr(), box.data_ptr(), f_pad, ray_o.data_ptr(),
            ray_d.data_ptr(), n, t.data_ptr(), ids.data_ptr(),
            uv.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K1 launch")
    _cuda.LAUNCHES["K1"] += 1
    return t, ids, uv


def intersect_super_cuda(tri, box, ray_o, ray_d, active):
    """Launch K5 on a ``(9, F_pad)`` table padded to whole 512-triangle
    super-blocks and its ``(6, F_pad // 16)`` cluster boxes: ``(t (N,), id
    (N,) int32, uv (N, 2))``. Lanes with
    ``active`` False report a miss untraced. Equals the plain sweep bit for
    bit."""
    dev = ray_o.device
    f_pad = tri.shape[1]
    if f_pad % SUPER or f_pad == 0:
        raise ValueError(f"K5 takes triangles padded to a positive multiple "
                         f"of {SUPER}, got {f_pad}")
    _cuda.require(tri, "tri", torch.float32, (9, f_pad), dev)
    _cuda.require(box, "box", torch.float32, (6, f_pad // CLUSTER), dev)
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
        err = lib.psdr_intersect_super(
            tri.data_ptr(), box.data_ptr(), f_pad, ray_o.data_ptr(), ray_d.data_ptr(),
            active.data_ptr(), n, t.data_ptr(), ids.data_ptr(),
            uv.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K5 launch")
    _cuda.LAUNCHES["K5"] += 1
    return t, ids, uv


def ray_intersect_detached(p0, e1, e2, ray, active=None, tree=None):
    """Closest hit of ``ray`` (``(..., 3)`` o/d) against (F, 3) triangles,
    routed on F (module docstring): the kernels for CUDA tensors, their
    plain versions for CPU tensors. Non-finite and inactive rays report a
    miss (``tri_id = -1``, ``valid = False``). ``tree``, K6's
    ``bvh.build_bvh`` of these triangles, is built here when F > 4096 and
    none is given.
    Returns ``(tri_id, valid, uv (..., 2), t)``."""
    from . import bvh

    o, d = ray.o.detach(), ray.d.detach()
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    if active is not None:
        finite = finite & active
    shape = o.shape[:-1]
    finite = finite.reshape(-1)
    unit_z = d.new_zeros(3)
    unit_z[2] = 1.0
    o = torch.where(finite[:, None], o.reshape(-1, 3), 0.0)
    d = torch.where(finite[:, None], d.reshape(-1, 3), unit_z)
    p0, e1, e2 = p0.detach(), e1.detach(), e2.detach()
    f = p0.shape[0]
    if f > K5_MAX_TRIS and tree is None:
        tree = bvh.build_bvh(p0, e1, e2)
    if o.device.type == "cpu":
        if f <= K5_MAX_TRIS:
            tri_id, valid, uv, t = ray_intersect_brute(p0, e1, e2, o, d,
                                                       finite)
        else:
            tri_id, valid, uv, t = bvh.ray_intersect_bvh_plain(tree, o, d,
                                                               finite)
    else:
        o, d = o.contiguous(), d.contiguous()
        if f <= K1_MAX_TRIS:
            tri, box = pack_triangles(p0, e1, e2)
            t, tri_id, uv = intersect_cuda(tri, box, o, d)
        elif f <= K5_MAX_TRIS:
            tri, box = pack_triangles(p0, e1, e2, SUPER)
            t, tri_id, uv = intersect_super_cuda(tri, box, o, d, finite)
        else:
            t, tri_id, uv = bvh.bvh_cuda(tree, o, d, finite)
        valid = tri_id >= 0
    valid = valid & finite
    tri_id = torch.where(valid, tri_id, -1)
    return (tri_id.reshape(shape), valid.reshape(shape),
            uv.reshape(shape + (2,)), t.reshape(shape))
