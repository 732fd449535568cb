"""Detached closest-hit ray/triangle intersection (counterpart of
``psdr_jit_tpu/ops/intersect.py`` and of the small-scene Pallas kernel in
``psdr_jit_tpu/ops/intersect_pallas.py``).

The payload is the JAX package's ``(tri_id, valid, uv, t)``: global
triangle ids (-1 = miss), barycentrics and hit distance, all detached.

* :func:`ray_intersect_brute` is the plain PyTorch version: every ray
  against every triangle, no culling. It is the CPU path and the oracle of
  the kernel.
* :func:`intersect_cuda` launches kernel K1 (``csrc/intersect.cu``).
* :func:`ray_intersect_detached` is the entry: it masks non-finite and
  inactive rays, then runs the plain version on CPU tensors and K1 on CUDA
  tensors.

Both versions run THE hit test of ``csrc/sweep.cuh`` (Möller-Trumbore with
``|a| > 1e-12, u >= 0, v >= 0, u + v <= 1, RAY_EPSILON < t < best``) and
visit triangles in ascending id with a strict ``t < best``, so their ids
can differ only where two hits tie within f32 rounding.
"""

from __future__ import annotations

import torch

from ..core.types import RAY_EPSILON
from . import _cuda

INF = 1e30
# Triangles per culling cluster: the table layout of the JAX package's
# build_tables (16-triangle clusters, one AABB each), kept so the tables
# of the two packages compare one to one. The CUDA sweep culls per ray.
CLUSTER = 16
# K1 stages the whole (9, F) triangle table in shared memory: 512
# triangles are 18 KiB, under the 48 KiB a block gets without opting in.
K1_MAX_TRIS = 512
# Rays per block of the plain sweep: bounds its (rays, F) temporaries.
PLAIN_RAY_CHUNK = 1 << 18


def pack_triangles(p0, e1, e2):
    """(F, 3) triangle SoA -> ``(tri (9, F_pad), box (6, F_pad // 16))``.

    ``tri`` rows are p0, e1, e2 by component; F is padded to a whole
    cluster with degenerate (never hit) triangles. ``box`` rows are each
    cluster's AABB lower then upper corner."""
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


def _sweep_block(tri, ox, oy, oz, dx, dy, dz):
    rows = [tri[k][None, :] for k in range(9)]
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in (ox, oy, oz, dx, dy, dz))
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
    t = torch.where(hit, t, INF)
    j = torch.argmin(t, dim=1, keepdim=True)  # first (lowest-id) minimum
    bt = t.gather(1, j)[:, 0]
    miss = ~(bt < INF)
    bi = torch.where(miss, -1, j[:, 0].to(torch.int32))
    bu = torch.where(miss, 0.0, u.gather(1, j)[:, 0])
    bv = torch.where(miss, 0.0, v.gather(1, j)[:, 0])
    return bt, bi, bu, bv


def sweep_plain(tri, o, d):
    """Plain closest-hit sweep over a packed ``(9, F)`` table for rays
    given as component tuples ``o = (ox, oy, oz)``, ``d`` (each ``(n,)``).

    Returns ``(t, id, u, v)``: ``t = 1e30``, ``id = -1``, ``u = v = 0``
    for a miss."""
    n = o[0].shape[0]
    parts = [_sweep_block(tri, *(c[s:s + PLAIN_RAY_CHUNK] for c in (*o, *d)))
             for s in range(0, n, PLAIN_RAY_CHUNK)] or [
        _sweep_block(tri, *o, *d)]
    return tuple(torch.cat(p) for p in zip(*parts))


def ray_intersect_brute(p0, e1, e2, ray_o, ray_d):
    """Plain closest hit of (N, 3) rays against (F, 3) triangles.

    Returns ``(tri_id (N,) int32, valid (N,) bool, uv (N, 2), t (N,))``."""
    tri, _ = pack_triangles(p0, e1, e2)
    t, tri_id, u, v = sweep_plain(tri, ray_o.unbind(-1), ray_d.unbind(-1))
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


def ray_intersect_detached(p0, e1, e2, ray, active=None):
    """Closest hit of ``ray`` (``(..., 3)`` o/d) against (F, 3) triangles:
    K1 for CUDA tensors, the plain version for CPU tensors. Non-finite and
    inactive rays report a miss (``tri_id = -1``, ``valid = False``).
    Returns ``(tri_id, valid, uv (..., 2), t)``."""
    o, d = ray.o.detach(), ray.d.detach()
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    if active is not None:
        finite = finite & active
    shape = o.shape[:-1]
    o = torch.where(finite[..., None], o, 0.0).reshape(-1, 3)
    d = torch.where(finite[..., None], d,
                    d.new_tensor([0.0, 0.0, 1.0])).reshape(-1, 3)
    p0, e1, e2 = p0.detach(), e1.detach(), e2.detach()
    if o.device.type == "cpu":
        tri_id, valid, uv, t = ray_intersect_brute(p0, e1, e2, o, d)
    elif p0.shape[0] > K1_MAX_TRIS:
        raise NotImplementedError(
            f"{p0.shape[0]} triangles: the large-scene intersection kernels "
            "(the JAX package's _kernel_super and BVH kernel) are not "
            "ported yet (ROADMAP.md, port queue)")
    else:
        tri, box = pack_triangles(p0, e1, e2)
        t, tri_id, uv = intersect_cuda(tri, box, o.contiguous(),
                                       d.contiguous())
        valid = tri_id >= 0
    valid = valid.reshape(shape) & finite
    tri_id = torch.where(valid, tri_id.reshape(shape), -1)
    return tri_id, valid, uv.reshape(shape + (2,)), t.reshape(shape)
