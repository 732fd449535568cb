"""Plain closest hit (copied from ``psdr_jit_tpu_torch/ops/intersect.py``):
the unculled sweep of every ray against every triangle, with the kernels'
hit test (``csrc/sweep.cuh hit_test``, its fused multiply-adds rounded
once through float64), the lowest id winning equal distances. It runs on
any device; ``PLAIN_RAY_CHUNK`` is larger than the port's (the sweep is
exact under any chunking), so that a frame on the card takes fewer
launches."""

from __future__ import annotations

import torch

from ..core.types import RAY_EPSILON

INF = 1e30


# Triangles per culling cluster of K2: the table layout of the JAX
# package's build_tables (16-triangle clusters, one AABB each), kept so the
# tables of the two packages compare one to one.
CLUSTER = 16


# Rays and triangles per block of the plain sweep: its (rays, triangles)
# temporaries stay at 2^24 entries whatever the scene's size.
PLAIN_RAY_CHUNK = 1 << 19


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


def ray_intersect_detached(p0, e1, e2, ray, active=None, tree=None):
    """Closest hit of ``ray`` (``(..., 3)`` o/d) against (F, 3)
    triangles by the plain sweep; non-finite and inactive rays report a
    miss (``tri_id = -1``, ``valid = False``), swept from the origin along
    +z in their place. ``tree`` is accepted and unused. Returns
    ``(tri_id, valid, uv (..., 2), t)``."""
    o, d = ray.o.detach(), ray.d.detach()
    shape = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    live = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    if active is not None:
        live = live & active.reshape(-1)
    unit_z = d.new_zeros(3)
    unit_z[2] = 1.0
    o = torch.where(live[:, None], o, 0.0)
    d = torch.where(live[:, None], d, unit_z)
    tri_id, _, uv, t = ray_intersect_brute(p0.detach(), e1.detach(),
                                           e2.detach(), o, d, live)
    valid = tri_id >= 0
    return (tri_id.reshape(shape), valid.reshape(shape),
            uv.reshape(shape + (2,)), t.reshape(shape))

