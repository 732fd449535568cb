"""Detached PathTracer Li in one launch (counterpart of
``psdr_jit_tpu/ops/megakernel.py``: ``li_mega``, ``li_mega_pair`` and
``li_mega_stash``).

Kernel K2 (``csrc/megakernel.cu``) evaluates, per lane: the closest-hit
sweep, the hit attributes, area-light next-event estimation with MIS, the
cosine-weighted bounce in a Duff frame, and the depth loop. Its draws are
the sampler's: ``pcg4d(lane, cnt, seed, 0x9E3779B9)`` with one draw for each
NEE and one for each bounce, starting at ``cnt0``, so a render through it
is sample for sample the JAX package's estimator.

K2 has three modes, one kernel (a runtime argument picks the mode):

* single (:func:`li_mega`): Li of one ray per lane;
* pair (:func:`li_mega_pair`): ``Li(ray_n) - Li(ray_p)`` for the
  primary-edge pass, ray_n with draws ``cnt0 .. cnt0 + 2 depth - 1`` and
  ray_p with the next ``2 depth``, so it equals two sequential calls;
* stash (:func:`li_mega_stash`): Li plus the ``(tri_id, u, v)`` payload of
  all ``1 + 2 depth`` hits (camera, then NEE and bounce of each depth) for
  the attached shade (``ops/shade_mega.py``). Its bounce origins are the
  bilinear points ``p0 + e1 u + e2 v`` of the path-space formulation, not
  ``o + d t``; the camera hit keeps ``o + d t``.

Scope (:func:`applicable`): every BSDF a one-sided constant
``DiffuseBSDF``, exactly one emitter (an ``AreaLight``) and at most
``MEGA_MAX_TRIS`` triangles. Each entry launches K2 on CUDA tensors and
runs its plain PyTorch version (``*_plain``, one transcription of the
same per-lane program) on CPU tensors.
"""

from __future__ import annotations

import torch

from ..core.types import (EPSILON, SHADOW_EPSILON, INV_PI, PI,
                          coordinate_system)
from ..core.sampler import pcg4d, u32_to_unit_float, SALT
from ..core.math import mis_weight, normalize, safe_div, safe_sqrt
from ..bsdf.diffuse import DiffuseBSDF
from ..emitter.area import AreaLightData
from . import _cuda
from .intersect import CLUSTER, _fma, pack_triangles, sweep_plain

_TINY = 1e-20
# K2 stages all tables in shared memory: at 192 triangles (and at most as
# many light triangles) they take 31 KiB, under the 48 KiB a block gets
# without opting in.
MEGA_MAX_TRIS = 192
ATTR_ROWS = 17   # n0(3) n1(3) n2(3) fnmask albedo(3) emission(3) is_emitter
LIGHT_ROWS = 14  # cdf pmf p0(3) e1(3) e2(3) face normal(3)


def applicable(sd) -> bool:
    """Can K2 evaluate this scene's detached Li?"""
    if sd.tri.p0.shape[0] > MEGA_MAX_TRIS:
        return False
    if len(sd.emitters) != 1 or not isinstance(sd.emitters[0], AreaLightData):
        return False
    return all(isinstance(b, DiffuseBSDF) and not b.twoSide
               for b in sd.bsdfs)


def build_tables(sd):
    """Pack SceneData into K2's tables:
    ``tri (9, F_pad)``, ``box (6, F_pad // 16)``, ``attr (17, F_pad)``,
    ``light (14, L)`` and ``misc (2,) = (light cdf total,
    sampling weight / light area)``."""
    tri = sd.tri
    dev = tri.p0.device
    f = tri.p0.shape[0]
    tri_tab, box_tab = pack_triangles(tri.p0, tri.e1, tri.e2)
    f_pad = tri_tab.shape[1]

    def pad_t(x):  # (F, k) -> (k, F_pad)
        return torch.cat([x, x.new_zeros((f_pad - f, x.shape[1]))]).T

    face_mesh = sd.face_mesh_id.long()
    bslot = sd.mesh_bsdf_slot[face_mesh]
    alb_table = torch.stack([b.reflectance for b in sd.bsdfs]).to(dev)
    alb = torch.where((bslot >= 0)[:, None],
                      alb_table[torch.clamp(bslot, min=0).long()], 0.0)
    eslot = sd.mesh_emitter_slot[face_mesh]
    em = sd.emitters[0]
    emit = torch.where((eslot >= 0)[:, None], em.radiance.reshape(1, 3), 0.0)
    attr = torch.cat([
        pad_t(tri.n0), pad_t(tri.n1), pad_t(tri.n2),
        pad_t(sd.face_normal_mask.to(torch.float32)[:, None]),
        pad_t(alb), pad_t(emit), pad_t((eslot >= 0).to(torch.float32)[:, None]),
    ], dim=0).contiguous()

    md = em.mesh_data
    light = torch.cat([
        md.face_distrb.cdf[None], md.face_distrb.pmf[None],
        md.tri.p0.T, md.tri.e1.T, md.tri.e2.T, md.tri.face_normal.T,
    ], dim=0).contiguous()
    misc = torch.stack([
        md.face_distrb.total,
        em.sampling_weight * safe_div(torch.ones_like(md.total_area),
                                      md.total_area),
    ]).contiguous()
    return tri_tab, box_tab, attr, light, misc


# ---- the plain version ------------------------------------------------------

def _normalize3(x, y, z):
    return normalize(torch.stack([x, y, z], dim=-1)).unbind(-1)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sincos_pio4(phi):
    """sin and cos for |phi| <= pi/4: Cephes' single-precision minimax
    polynomials (about 1 ulp), written out so every device and batch size
    runs the same arithmetic; K2 uses the same two polynomials."""
    z = phi * phi
    s = ((-1.9515295891e-4 * z + 8.3321608736e-3) * z
         - 1.6666654611e-1) * z * phi + phi
    c = ((2.443315711809948e-5 * z - 1.388731625493765e-3) * z
         + 4.166664568298827e-2) * z * z - 0.5 * z + 1.0
    return s, c


def _cosine_hemisphere(u0, u1):
    """Concentric-disk cosine-weighted hemisphere sample (warp.py:30-51)."""
    x = 2.0 * u0 - 1.0
    y = 2.0 * u1 - 1.0
    q13 = torch.abs(x) < torch.abs(y)
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    s, c = sincos_pio4(0.25 * PI * safe_div(rp, r))
    px = r * torch.where(q13, s, c)
    py = r * torch.where(q13, c, s)
    return px, py, safe_sqrt(1.0 - px * px - py * py)


def _bilinear_point(tri, bi, bu, bv):
    """``p0 + e1 u + e2 v`` of hit ``bi`` with two fused multiply-adds,
    rounded as the JAX package's CPU backend contracts the expression."""
    j = torch.clamp(bi, min=0).long()
    return tuple(torch.where(bi >= 0, _fma(tri[6 + k, j], bv,
                                           _fma(tri[3 + k, j], bu,
                                                tri[k, j])), 0.0)
                 for k in range(3))


def _li_plain(tri, attr, light, misc, ray_o, ray_d, active, lane,
              seed: int, depth: int, cnt0: int, hide_emitters: bool,
              stash: bool):
    """The per-lane program of K2: ``(radiance (N, 3), hits)``, where
    ``hits`` is ``(ids, u, v)``, each ``(1 + 2 depth, N)``, in stash mode
    and ``None`` otherwise."""
    n_light = light.shape[1]
    total_mass, inv_area = misc[0], misc[1]
    lane = lane.to(torch.int64) & 0xFFFFFFFF
    seed = int(seed) & 0xFFFFFFFF
    hits = []

    def draw(cnt):
        return [u32_to_unit_float(x) for x in pcg4d(lane, cnt, seed, SALT)]

    def closest_hit(o, d):
        t, bi, bu, bv = sweep_plain(tri, o, d)
        if stash:
            hits.append((bi, bu, bv))
        return t, bi, bu, bv

    def resolve(bi, bu, bv):
        """Hit attributes: shading normal, face normal, albedo, emission
        (3-tuples) and is-emitter; zeros for misses."""
        hit = bi >= 0
        j = torch.clamp(bi, min=0).long()
        a = attr[:, j]
        e1 = tri[3:6, j]
        e2 = tri[6:9, j]
        fx = e1[1] * e2[2] - e1[2] * e2[1]
        fy = e1[2] * e2[0] - e1[0] * e2[2]
        fz = e1[0] * e2[1] - e1[1] * e2[0]
        fn = _normalize3(fx, fy, fz)
        smooth = ~(a[9] > 0.5)
        ns = [torch.where(smooth, a[k] + (a[3 + k] - a[k]) * bu
                          + (a[6 + k] - a[k]) * bv, fn[k]) for k in range(3)]

        def m(x):
            return torch.where(hit, x, 0.0)

        ns = _normalize3(*(m(x) for x in ns))
        return (ns, tuple(m(x) for x in fn),
                tuple(m(a[10 + k]) for k in range(3)),
                tuple(m(a[13 + k]) for k in range(3)), hit & (a[16] > 0.5))

    def sample_light(u0, u1):
        scaled = u0 * total_mass
        cdf = light[0]
        idx = torch.clamp((cdf[None, :] < scaled[:, None]).sum(1),
                          max=n_light - 1)
        lower = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
        rows = light[:, idx]
        u0r = torch.clamp(safe_div(scaled - lower, rows[1]), 0.0, 1.0)
        tq = safe_sqrt(1.0 - u0r)
        b0 = 1.0 - tq
        b1 = tq * u1
        return tuple(rows[2 + k] + rows[5 + k] * b0 + rows[8 + k] * b1
                     for k in range(3))

    o = tuple(ray_o[:, k] for k in range(3))
    d = tuple(ray_d[:, k] for k in range(3))
    cnt = cnt0
    t, bi, bu, bv = closest_hit(o, d)
    active = active & (bi >= 0)
    ns, fn, alb, emit, is_em = resolve(bi, bu, bv)
    zero = torch.zeros_like(t)
    res = [zero, zero, zero]
    if not hide_emitters:
        ok = active & is_em & (-_dot3(ns, d) > 0.0)
        res = [torch.where(ok, emit[k], res[k]) for k in range(3)]
    thr = [torch.ones_like(t)] * 3
    # the hit point with one rounding, as K2's fmaf and the JAX package's
    # CPU backend compute it: rounding twice moves secondary-ray origins by
    # an ulp, which flips grazing self-intersection tests (RAY_EPSILON) on
    # about 1% of cbox lanes
    p = tuple(_fma(d[k], t, o[k]) for k in range(3))
    for _ in range(depth):
        wiz_cam = -_dot3(ns, d)
        # next-event estimation (path.cpp:47-83)
        u_nee = draw(cnt)
        cnt += 1
        pl = sample_light(u_nee[0], u_nee[1])
        active_direct = active & ~is_em
        wod = tuple(pl[k] - p[k] for k in range(3))
        dist_sqr = _dot3(wod, wod)
        dist = safe_sqrt(dist_sqr)
        inv_dist = safe_div(torch.ones_like(dist), dist)
        wod = tuple(w * inv_dist for w in wod)
        t1, bi1, bu1, bv1 = closest_hit(p, wod)
        ns1, fn1, _, emit1, is_em1 = resolve(bi1, bu1, bv1)
        hit_light = (active_direct & (bi1 >= 0)
                     & (t1 > dist - SHADOW_EPSILON) & is_em1)
        g_val = safe_div(torch.abs(-_dot3(fn1, wod)), dist_sqr)
        le_ok = (bi1 >= 0) & is_em1 & (-_dot3(ns1, wod) > 0.0)
        cos_o = _dot3(ns, wod)
        f_ok = (wiz_cam > 0.0) & (cos_o > 0.0)
        f_scale = torch.where(f_ok, INV_PI * cos_o, 0.0)
        w_nee = g_val * safe_div(torch.ones_like(inv_area), inv_area)
        pdf1 = torch.where(f_ok, INV_PI * cos_o, 0.0) * g_val
        weight1 = mis_weight(inv_area, pdf1)
        scale = torch.where(hit_light & (pdf1 != 0.0),
                            f_scale * w_nee * weight1, 0.0)
        res = [res[k] + thr[k] * alb[k] * torch.where(le_ok, emit1[k], 0.0)
               * scale for k in range(3)]
        # BSDF bounce (path.cpp:85-123)
        u_b = draw(cnt)
        cnt += 1
        lx, ly, lz = _cosine_hemisphere(u_b[1], u_b[2])
        bs_pdf = INV_PI * lz
        s_f, t_f = (x.unbind(-1)
                    for x in coordinate_system(torch.stack(ns, dim=-1)))
        wo = tuple(s_f[k] * lx + t_f[k] * ly + ns[k] * lz for k in range(3))
        bs_valid = active & (wiz_cam > 0.0)
        t2, bi2, bu2, bv2 = closest_hit(p, wo)
        valid2 = bi2 >= 0
        active = bs_valid & valid2
        ns2, fn2, alb2, emit2, is_em2 = resolve(bi2, bu2, bv2)
        g2 = safe_div(torch.abs(-_dot3(fn2, wo)),
                      torch.clamp(t2 * t2, min=_TINY))
        pdf0 = bs_pdf * torch.where(valid2, g2, 1.0)
        f2_ok = (wiz_cam > 0.0) & (lz > 0.0) & (t2 >= EPSILON)
        bw = torch.where(f2_ok & active, 1.0, 0.0)
        thr = [thr[k] * alb[k] * bw for k in range(3)]
        e_pdf = torch.where(valid2 & is_em2, inv_area, 0.0)
        weight2 = mis_weight(pdf0, e_pdf)
        lscale = torch.where(active & is_em2 & (-_dot3(ns2, wo) > 0.0),
                             weight2, 0.0)
        res = [res[k] + thr[k] * emit2[k] * lscale for k in range(3)]
        if stash:
            p = _bilinear_point(tri, bi2, bu2, bv2)
        else:
            p = tuple(_fma(wo[k], t2, p[k]) for k in range(3))
        d = wo
        ns, fn, alb, emit, is_em = ns2, fn2, alb2, emit2, is_em2
    out = torch.stack(res, dim=-1)
    if not stash:
        return out, None
    return out, tuple(torch.stack(x) for x in zip(*hits))


def li_mega_plain(tri, box, attr, light, misc, ray_o, ray_d, active, lane,
                  seed: int, depth: int, cnt0: int,
                  hide_emitters: bool = False):
    """Plain PyTorch K2, single mode: the same per-lane program with index
    gathers in place of shared-memory table reads and the unculled sweep
    (``box`` is unused). Returns ``(N, 3)`` radiance, 0 for inactive
    lanes."""
    del box
    return _li_plain(tri, attr, light, misc, ray_o, ray_d, active, lane,
                     seed, depth, cnt0, hide_emitters, False)[0]


def li_mega_pair_plain(tri, box, attr, light, misc, ray_o_n, ray_d_n,
                       ray_o_p, ray_d_p, active, lane, seed: int,
                       depth: int, cnt0: int, hide_emitters: bool = False):
    """Plain K2, pair mode: ``Li(ray_n) - Li(ray_p)``, ray_p drawing from
    ``cnt0 + 2 depth``."""
    del box
    li_n = _li_plain(tri, attr, light, misc, ray_o_n, ray_d_n, active, lane,
                     seed, depth, cnt0, hide_emitters, False)[0]
    li_p = _li_plain(tri, attr, light, misc, ray_o_p, ray_d_p, active, lane,
                     seed, depth, cnt0 + 2 * depth, hide_emitters, False)[0]
    return li_n - li_p


def li_mega_stash_plain(tri, box, attr, light, misc, ray_o, ray_d, active,
                        lane, seed: int, depth: int, cnt0: int,
                        hide_emitters: bool = False):
    """Plain K2, stash mode: ``(radiance (N, 3), (ids, u, v))`` with
    ``(1 + 2 depth, N)`` int32 ids (-1 = miss) and float32
    barycentrics."""
    del box
    return _li_plain(tri, attr, light, misc, ray_o, ray_d, active, lane,
                     seed, depth, cnt0, hide_emitters, True)


# ---- the kernel -------------------------------------------------------------

def _lane_i32(lane):
    """The u32 bit pattern of ``lane`` as int32."""
    lane = lane.to(torch.int64) & 0xFFFFFFFF
    return torch.where(lane >= 1 << 31, lane - (1 << 32), lane).to(
        torch.int32).contiguous()


def _launch_k2(mode: str, tri, box, attr, light, misc, ray_o, ray_d, ray2,
               active, lane, seed: int, depth: int, cnt0: int,
               hide_emitters: bool):
    dev = ray_o.device
    f_pad = tri.shape[1]
    n_light = light.shape[1]
    if f_pad % CLUSTER or not 0 < f_pad <= MEGA_MAX_TRIS:
        raise ValueError(f"K2 takes 1..{MEGA_MAX_TRIS} triangles padded to "
                         f"a multiple of {CLUSTER}, got {f_pad}")
    if not 0 < n_light <= MEGA_MAX_TRIS:
        raise ValueError(f"K2 takes 1..{MEGA_MAX_TRIS} light triangles, "
                         f"got {n_light}")
    if depth < 0 or cnt0 < 0:
        raise ValueError("depth and cnt0 must be non-negative")
    _cuda.require(tri, "tri", torch.float32, (9, f_pad), dev)
    _cuda.require(box, "box", torch.float32, (6, f_pad // CLUSTER), dev)
    _cuda.require(attr, "attr", torch.float32, (ATTR_ROWS, f_pad), dev)
    _cuda.require(light, "light", torch.float32, (LIGHT_ROWS, n_light), dev)
    _cuda.require(misc, "misc", torch.float32, (2,), dev)
    n = ray_o.shape[0]
    _cuda.require(ray_o, "ray_o", torch.float32, (n, 3), dev)
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    o2, d2 = ray2 if ray2 is not None else (ray_o, ray_d)
    _cuda.require(o2, "ray_o_p", torch.float32, (n, 3), dev)
    _cuda.require(d2, "ray_d_p", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    if lane.shape != (n,) or lane.device != dev or lane.is_floating_point():
        raise ValueError("lane: expected (N,) integer tensor on the rays' "
                         "device")
    lane32 = _lane_i32(lane)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    n_hits = 1 + 2 * depth
    stash = mode == "K2-stash"
    ids = torch.empty((n_hits, n) if stash else (0,), dtype=torch.int32,
                      device=dev)
    su = torch.empty((n_hits, n) if stash else (0,), dtype=torch.float32,
                     device=dev)
    sv = torch.empty_like(su)
    if n > 0:
        lib = _cuda.library()
        with torch.cuda.device(dev):
            err = lib.psdr_li_mega(
                tri.data_ptr(), box.data_ptr(), attr.data_ptr(),
                light.data_ptr(), misc.data_ptr(), f_pad, n_light,
                ray_o.data_ptr(), ray_d.data_ptr(), o2.data_ptr(),
                d2.data_ptr(), active.data_ptr(), lane32.data_ptr(),
                int(seed) & 0xFFFFFFFF, n, depth, cnt0, int(hide_emitters),
                _K2_MODES[mode], out.data_ptr(), ids.data_ptr(),
                su.data_ptr(), sv.data_ptr(), _cuda.stream_of(dev))
        _cuda.check(err, f"{mode} launch")
        _cuda.LAUNCHES[mode] += 1
    return out, ((ids, su, sv) if stash else None)


_K2_MODES = {"K2": 0, "K2-pair": 1, "K2-stash": 2}


def li_mega_cuda(tri, box, attr, light, misc, ray_o, ray_d, active, lane,
                 seed: int, depth: int, cnt0: int,
                 hide_emitters: bool = False):
    """Launch K2 in single mode. ``lane`` holds u32 values in any integer
    dtype."""
    return _launch_k2("K2", tri, box, attr, light, misc, ray_o, ray_d, None,
                      active, lane, seed, depth, cnt0, hide_emitters)[0]


def li_mega_pair_cuda(tri, box, attr, light, misc, ray_o_n, ray_d_n,
                      ray_o_p, ray_d_p, active, lane, seed: int, depth: int,
                      cnt0: int, hide_emitters: bool = False):
    """Launch K2 in pair mode: ``Li(ray_n) - Li(ray_p)``."""
    return _launch_k2("K2-pair", tri, box, attr, light, misc, ray_o_n,
                      ray_d_n, (ray_o_p, ray_d_p), active, lane, seed, depth,
                      cnt0, hide_emitters)[0]


def li_mega_stash_cuda(tri, box, attr, light, misc, ray_o, ray_d, active,
                       lane, seed: int, depth: int, cnt0: int,
                       hide_emitters: bool = False):
    """Launch K2 in stash mode: ``(radiance, (ids, u, v))``."""
    return _launch_k2("K2-stash", tri, box, attr, light, misc, ray_o, ray_d,
                      None, active, lane, seed, depth, cnt0, hide_emitters)


def li_mega(tri, box, attr, light, misc, ray_o, ray_d, active, lane,
            seed: int, depth: int, cnt0: int, hide_emitters: bool = False):
    """Detached PathTracer Li for (N, 3) rays: K2 on CUDA tensors, the
    plain version on CPU tensors. ``lane``/``seed``/``cnt0`` give the
    sampler schedule; returns ``(N, 3)`` radiance, 0 for inactive lanes."""
    fn = li_mega_plain if ray_o.device.type == "cpu" else li_mega_cuda
    return fn(tri, box, attr, light, misc, ray_o, ray_d, active, lane, seed,
              depth, cnt0, hide_emitters)


def li_mega_pair(tri, box, attr, light, misc, ray_o_n, ray_d_n, ray_o_p,
                 ray_d_p, active, lane, seed: int, depth: int, cnt0: int,
                 hide_emitters: bool = False):
    """``Li(ray_n) - Li(ray_p)`` for (N, 3) ray pairs, both sides drawing
    as two sequential :func:`li_mega` calls would: K2 pair mode on CUDA
    tensors, the plain version on CPU tensors."""
    fn = (li_mega_pair_plain if ray_o_n.device.type == "cpu"
          else li_mega_pair_cuda)
    return fn(tri, box, attr, light, misc, ray_o_n, ray_d_n, ray_o_p,
              ray_d_p, active, lane, seed, depth, cnt0, hide_emitters)


def li_mega_stash(tri, box, attr, light, misc, ray_o, ray_d, active, lane,
                  seed: int, depth: int, cnt0: int,
                  hide_emitters: bool = False):
    """Detached Li and the hit payloads ``(ids, u, v)``, each
    ``(1 + 2 depth, N)``: K2 stash mode on CUDA tensors, the plain version
    on CPU tensors."""
    fn = (li_mega_stash_plain if ray_o.device.type == "cpu"
          else li_mega_stash_cuda)
    return fn(tri, box, attr, light, misc, ray_o, ray_d, active, lane, seed,
              depth, cnt0, hide_emitters)
