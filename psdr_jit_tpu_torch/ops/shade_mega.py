"""Attached interior shading (counterpart of ``psdr_jit_tpu/ops/shade_mega.py``).

The training step's interior term is an ATTACHED Li: gradients flow through
the closed-form hit reconstruction, shading normals, light sampling and the
material and emitter parameters (reference path.cpp:30-124 under AD). It
runs in two parts:

1. K2 in stash mode (``ops/megakernel.li_mega_stash``) traces the detached
   paths and records every hit's ``(tri_id, u, v)``: sampling is detached,
   the integrand is attached.
2. :func:`li_attached` recomputes the radiance of those paths from the
   attached tables (:func:`attached_tables`): a (F, 30) face table, a
   (12, L) light table and 8 scalars. On CUDA tensors it is the operator
   :func:`k3_op`, which launches K3 (``csrc/shade.cu``) and whose
   backward launches K4 (:func:`k4_op`), K3's adjoint written by hand; on
   CPU tensors it runs :func:`li_attached_plain` and autograd
   differentiates that.

The TPU packed 30 gathered rows per hit per lane into ``(30, rows, 128)``
blocks for its layout; here the kernels read the face table by hit id.

Scope (:func:`applicable`): K2's scene class, with at most
``MAX_LIGHT_TRIS`` light triangles.
"""

from __future__ import annotations

import torch

from ..core.types import EPSILON, SHADOW_EPSILON, INV_PI
from ..core.sampler import pcg4d, u32_to_unit_float, SALT
from ..core.math import mis_weight, safe_div, safe_rsqrt, safe_sqrt
from . import _cuda
from . import megakernel as mk

# (F, 30) face-table columns (the JAX package's ROW_* layout)
ROW_P0, ROW_E1, ROW_E2 = 0, 3, 6
ROW_N0, ROW_N1, ROW_N2 = 9, 12, 15
ROW_FN, ROW_AREA, ROW_FNMASK = 18, 21, 22
ROW_ALB, ROW_EMIT, ROW_ISEM = 23, 26, 29
TABLE_ROWS = 30
LIGHT_ROWS = 12  # cdf, pmf, p0(3), e1(3), e2(3), face_area
MISC_COLS = 8    # total_mass, total_area, sampling_weight, ps_pdf, 4 pad
MAX_LIGHT_TRIS = 64


def applicable(sd) -> bool:
    """Can K2-stash, K3 and K4 evaluate this scene's attached Li?"""
    if not mk.applicable(sd):
        return False
    return sd.emitters[0].mesh_data.tri.p0.shape[0] <= MAX_LIGHT_TRIS


def attached_tables(sd):
    """``(table (F, 30), light (12, L), misc (8,))`` built without
    detaching: the differentiable mirror of ``megakernel.build_tables``
    (JAX ``shade_mega._attached_tables``)."""
    tri = sd.tri
    dev = tri.p0.device
    face_mesh = sd.face_mesh_id.long()
    bslot = sd.mesh_bsdf_slot.long()[face_mesh]
    alb_table = torch.stack([b.reflectance.data.reshape(3)
                             for b in sd.bsdfs]).to(dev)
    alb = torch.where((bslot >= 0)[:, None],
                      alb_table[torch.clamp(bslot, min=0)], 0.0)
    eslot = sd.mesh_emitter_slot.long()[face_mesh]
    em = sd.emitters[0]
    emit = torch.where((eslot >= 0)[:, None], em.radiance.reshape(1, 3), 0.0)
    table = torch.cat([
        tri.p0, tri.e1, tri.e2, tri.n0, tri.n1, tri.n2, tri.face_normal,
        tri.face_area[:, None],
        sd.face_normal_mask.to(torch.float32)[:, None],
        alb, emit, (eslot >= 0).to(torch.float32)[:, None],
    ], dim=1)
    md = em.mesh_data
    ltri = md.tri
    light = torch.cat([
        md.face_distrb.cdf[None], md.face_distrb.pmf[None],
        ltri.p0.T, ltri.e1.T, ltri.e2.T, ltri.face_area[None],
    ], dim=0)
    misc = torch.cat([
        torch.stack([md.face_distrb.total, md.total_area, em.sampling_weight,
                     safe_div(torch.ones_like(md.total_area),
                           md.total_area).detach()]),
        md.total_area.new_zeros(MISC_COLS - 4),
    ])
    return table, light, misc


# ---- the plain version ------------------------------------------------------
# core.math's safe_div, safe_sqrt and safe_rsqrt carry the double-where
# guards of the JAX package (shade_mega.py:123-133): a masked-out branch
# never sees inf or NaN, so its zero cotangent stays zero in the backward.

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _normalize3(v):
    return _scale3(v, safe_rsqrt(_dot3(v, v)))


def _fields(table, ids, u, v):
    """Named per-lane fields of hit ``ids`` (row 0 for a miss, as the JAX
    package gathers it; the masks keep it out of every result). The
    payload and the flag columns are detached."""
    rows = table[torch.clamp(ids, min=0).long()]

    def r3(c):
        return (rows[:, c], rows[:, c + 1], rows[:, c + 2])

    return dict(
        p0=r3(ROW_P0), e1=r3(ROW_E1), e2=r3(ROW_E2),
        n0=r3(ROW_N0), n1=r3(ROW_N1), n2=r3(ROW_N2),
        fn=r3(ROW_FN), area=rows[:, ROW_AREA],
        fnmask=rows[:, ROW_FNMASK].detach() > 0.5,
        alb=r3(ROW_ALB), emit=r3(ROW_EMIT),
        isem=rows[:, ROW_ISEM].detach() > 0.5,
        valid=ids >= 0, u=u.detach(), v=v.detach())


def _shading_normal(f, u, v):
    n = tuple(f["n0"][k] + (f["n1"][k] - f["n0"][k]) * u
              + (f["n2"][k] - f["n0"][k]) * v for k in range(3))
    n = _normalize3(n)
    return tuple(torch.where(f["fnmask"], f["fn"][k], n[k]) for k in range(3))


def _hit_point(f):
    return tuple(f["p0"][k] + f["e1"][k] * f["u"] + f["e2"][k] * f["v"]
                 for k in range(3))


def li_attached_plain(table, light, misc, ids, us, vs, ray_o, ray_d, active,
                      lane, seed: int, depth: int, cnt0: int,
                      hide_emitters: bool = False):
    """The attached interior Li of each lane from its stashed hits
    (``ids``/``us``/``vs``: ``(1 + 2 depth, N)``): a transcription of the
    JAX package's ``_li_attached`` (shade_mega.py:208-387) on tensors, with
    every ``stop_gradient`` of it a ``detach`` here. Differentiable with
    respect to ``table``, ``light``, ``misc``, ``ray_o`` and ``ray_d``;
    returns ``(N, 3)``."""
    total_mass, total_area, sampling_weight = misc[0], misc[1], misc[2]
    ps_pdf = misc[3].detach()
    n_light = light.shape[1]
    lane = lane.to(torch.int64) & 0xFFFFFFFF
    seed = int(seed) & 0xFFFFFFFF

    def draw(c):
        return [u32_to_unit_float(x) for x in pcg4d(lane, cnt0 + c, seed, SALT)]

    o = ray_o.unbind(-1)
    d = ray_d.unbind(-1)
    # camera hit: solid-angle formulation (scene.py:178-184)
    f0 = _fields(table, ids[0], us[0], vs[0])
    h = _cross3(d, f0["e2"])
    a = _dot3(f0["e1"], h)
    f = safe_div(torch.ones_like(a), a)
    s = _sub3(o, f0["p0"])
    uu = f * _dot3(s, h)
    q = _cross3(s, f0["e1"])
    vv = f * _dot3(d, q)
    t0 = f * _dot3(f0["e2"], q)
    p = tuple(o[k] + t0 * d[k] for k in range(3))
    sh_n = _shading_normal(f0, uu, vv)
    wi_z = -_dot3(sh_n, d)

    valid = f0["valid"]
    active = active & valid
    isem = f0["isem"]
    alb = f0["alb"]
    zero = torch.zeros_like(t0)
    res = [zero, zero, zero]
    if not hide_emitters:
        ok = active & isem & (wi_z > 0.0)
        res = [torch.where(ok, f0["emit"][k], 0.0) for k in range(3)]
    thr = [torch.ones_like(t0)] * 3

    for i in range(depth):
        un = draw(2 * i)
        ub = draw(2 * i + 1)
        # ---- NEE (path.py nee_contribution) ----
        scaled = un[0] * total_mass
        idxl = torch.clamp((light[0][None, :] < scaled[:, None]).sum(1),
                           max=n_light - 1)
        lower = torch.where(idxl > 0, light[0][torch.clamp(idxl - 1, min=0)],
                            0.0)
        col = light[:, idxl]
        pmf, area_l = col[1], col[11]
        u0r = torch.clamp(safe_div(scaled - lower, pmf), 0.0, 1.0)
        tq = safe_sqrt(1.0 - u0r)
        b0 = 1.0 - tq
        b1 = tq * un[1]
        pl = tuple(col[2 + k] + col[5 + k] * b0 + col[8 + k] * b1
                   for k in range(3))
        ps_j = safe_div(area_l, area_l.detach())
        active_direct = active & ~(valid & isem)
        wod = _sub3(pl, p)
        dist_sqr = _dot3(wod, wod)
        dist = safe_sqrt(dist_sqr)
        wod = _scale3(wod, safe_div(torch.ones_like(dist), dist))

        f1 = _fields(table, ids[1 + 2 * i], us[1 + 2 * i], vs[1 + 2 * i])
        dv1 = _sub3(_hit_point(f1), p)
        t1 = safe_sqrt(_dot3(dv1, dv1))
        dirv1 = _scale3(dv1, safe_div(torch.ones_like(t1), t1))
        wi1_z = -_dot3(_shading_normal(f1, f1["u"], f1["v"]), dirv1)
        active_direct = (active_direct & f1["valid"]
                         & (t1 > dist - SHADOW_EPSILON) & f1["isem"])
        g_val = safe_div(torch.abs(-_dot3(f1["fn"], wod)), dist_sqr)
        le1_ok = active & f1["valid"] & f1["isem"] & (wi1_z > 0.0)
        cos_o = _dot3(sh_n, wod)
        ev_ok = active_direct & (wi_z > 0.0) & (cos_o > 0.0)
        bsdf_scale = torch.where(ev_ok, INV_PI * cos_o, 0.0) * (
            g_val * ps_j * safe_div(torch.ones_like(ps_pdf), ps_pdf))
        pdf1 = torch.where(
            active_direct & (wi_z.detach() > 0.0) & (cos_o.detach() > 0.0),
            INV_PI * cos_o.detach(), 0.0) * g_val.detach()
        ok_nee = active_direct & (pdf1 != 0.0)
        weight1 = mis_weight(ps_pdf, pdf1)
        for k in range(3):
            contrib = thr[k] * torch.where(le1_ok, f1["emit"][k], 0.0)
            contrib = contrib * alb[k] * bsdf_scale * weight1
            res[k] = res[k] + torch.where(ok_nee, contrib, 0.0)

        # ---- BSDF bounce (path.py bsdf_bounce) ----
        lz = mk._cosine_hemisphere(ub[1], ub[2])[2]
        bs_pdf = INV_PI * lz
        f2 = _fields(table, ids[2 + 2 * i], us[2 + 2 * i], vs[2 + 2 * i])
        p2 = _hit_point(f2)
        dv2 = _sub3(p2, p)
        t2 = safe_sqrt(_dot3(dv2, dv2))
        wo = _scale3(dv2, safe_div(torch.ones_like(t2), t2))
        t_det = t2.detach()
        g2 = safe_div(torch.abs(-_dot3(f2["fn"], wo)), t2 * t2)
        j2 = torch.where(f2["valid"], safe_div(f2["area"], f2["area"].detach()),
                         1.0)
        g2 = torch.where(f2["valid"], g2, 1.0)
        pdf0 = bs_pdf * g2.detach()
        active = active & (wi_z.detach() > 0.0) & f2["valid"]
        cos_o2 = _dot3(sh_n, wo)
        ev_ok2 = active & (wi_z > 0.0) & (cos_o2 > 0.0)
        ev_scale = torch.where(ev_ok2, INV_PI * cos_o2, 0.0)
        bval_scale = ev_scale * (g2 * j2 * safe_div(torch.ones_like(pdf0), pdf0))
        bval_scale = torch.where(t_det < EPSILON, 0.0, bval_scale)
        e_pdf = torch.where(
            active & f2["isem"],
            sampling_weight * safe_div(torch.ones_like(total_area), total_area),
            0.0)
        weight2 = mis_weight(pdf0, e_pdf)
        thr = [thr[k] * alb[k] * bval_scale for k in range(3)]
        sh_n2 = _shading_normal(f2, f2["u"], f2["v"])
        wi2_z = -_dot3(sh_n2, wo)
        le2_ok = active & f2["isem"] & (wi2_z > 0.0)
        for k in range(3):
            le2 = torch.where(le2_ok, f2["emit"][k], 0.0)
            res[k] = res[k] + torch.where(active, le2 * thr[k] * weight2, 0.0)

        p, sh_n, wi_z = p2, sh_n2, wi2_z
        alb, isem, valid = f2["alb"], f2["isem"], f2["valid"]
    return torch.stack(res, dim=-1)


# ---- the kernels --------------------------------------------------------------

def _check_k3(table, light, misc, ids, us, vs, ray_o, ray_d, active, lane,
              depth, cnt0):
    dev = ray_o.device
    f = table.shape[0]
    n_light = light.shape[1]
    if not 0 < f <= mk.MEGA_MAX_TRIS:
        raise ValueError(f"K3/K4 take 1..{mk.MEGA_MAX_TRIS} triangles, got {f}")
    if not 0 < n_light <= MAX_LIGHT_TRIS:
        raise ValueError(f"K3/K4 take 1..{MAX_LIGHT_TRIS} light triangles, "
                         f"got {n_light}")
    if not 0 <= depth <= 3 or cnt0 < 0:
        raise ValueError(f"K3/K4 take depth 0..3 and cnt0 >= 0, got depth "
                         f"{depth}, cnt0 {cnt0}")
    n = ray_o.shape[0]
    n_hits = 1 + 2 * depth
    _cuda.require(table, "table", torch.float32, (f, TABLE_ROWS), dev)
    _cuda.require(light, "light", torch.float32, (LIGHT_ROWS, n_light), dev)
    _cuda.require(misc, "misc", torch.float32, (MISC_COLS,), dev)
    _cuda.require(ids, "ids", torch.int32, (n_hits, n), dev)
    _cuda.require(us, "u", torch.float32, (n_hits, n), dev)
    _cuda.require(vs, "v", torch.float32, (n_hits, n), dev)
    _cuda.require(ray_o, "ray_o", torch.float32, (n, 3), dev)
    _cuda.require(ray_d, "ray_d", torch.float32, (n, 3), dev)
    _cuda.require(active, "active", torch.bool, (n,), dev)
    _cuda.require(lane, "lane", torch.int32, (n,), dev)


def shade_cuda(table, light, misc, ids, us, vs, ray_o, ray_d, active, lane,
               seed: int, depth: int, cnt0: int, hide_emitters: bool = False):
    """Launch K3: the attached Li's value, ``(N, 3)``. ``lane`` is the
    int32 bit pattern of the u32 lanes."""
    _check_k3(table, light, misc, ids, us, vs, ray_o, ray_d, active, lane,
              depth, cnt0)
    return k3_op(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane,
                 int(seed) & 0xFFFFFFFF, depth, cnt0, bool(hide_emitters))


def shade_adjoint_cuda(table, light, misc, ids, us, vs, ray_o, ray_d, active,
                       lane, seed: int, depth: int, cnt0: int,
                       hide_emitters: bool, ct):
    """Launch K4, the adjoint of K3 for the output cotangent ``ct``
    (N, 3): ``(d_table (F, 30), d_light (12, L), d_misc (8,),
    d_o (N, 3), d_d (N, 3))``. The table cotangents are summed over
    lanes with float atomics, so their last bits vary from run to run."""
    _check_k3(table, light, misc, ids, us, vs, ray_o, ray_d, active, lane,
              depth, cnt0)
    _cuda.require(ct, "ct", torch.float32, (ray_o.shape[0], 3), ray_o.device)
    return k4_op(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane,
                 int(seed) & 0xFFFFFFFF, depth, cnt0, bool(hide_emitters), ct)


_K3_ARGS = ("Tensor table, Tensor light, Tensor misc, Tensor ray_o, "
            "Tensor ray_d, Tensor ids, Tensor us, Tensor vs, Tensor active, "
            "Tensor lane, int seed, int depth, int cnt0, bool hide_emitters")


@_cuda.kernel_op("k3", f"({_K3_ARGS}) -> Tensor", data_outputs=False)
def k3_op(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane, seed,
          depth, cnt0, hide_emitters):
    """K3's launch, the operator behind :func:`shade_cuda` (which checks
    its inputs); differentiable in the table, light and misc tables and
    the camera rays, with K4 (:func:`k4_op`) as its backward. The hits,
    lanes and flags are data."""
    dev = ray_o.device
    out = ray_o.new_empty((ray_o.shape[0], 3))
    n = ray_o.shape[0]
    if n == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_shade_fwd(
            table.data_ptr(), light.data_ptr(), misc.data_ptr(),
            table.shape[0], light.shape[1], ids.data_ptr(), us.data_ptr(),
            vs.data_ptr(), ray_o.data_ptr(), ray_d.data_ptr(),
            active.data_ptr(), lane.data_ptr(), seed, n, depth, cnt0,
            int(hide_emitters), out.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K3 launch")
    _cuda.LAUNCHES["K3"] += 1
    return out


@k3_op.register_fake
def _(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane, seed,
      depth, cnt0, hide_emitters):
    return ray_o.new_empty((ray_o.shape[0], 3))


def _k4_outputs(table, light, misc, ray_o, ray_d):
    return (torch.zeros_like(table), torch.zeros_like(light),
            torch.zeros_like(misc), torch.empty_like(ray_o),
            torch.empty_like(ray_d))


@_cuda.kernel_op("k4", f"({_K3_ARGS}, Tensor ct) -> "
                 "(Tensor, Tensor, Tensor, Tensor, Tensor)")
def k4_op(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane, seed,
          depth, cnt0, hide_emitters, ct):
    """K4's launch, the operator behind :func:`shade_adjoint_cuda` (which
    checks its inputs) and K3's backward."""
    dev = ray_o.device
    d_table, d_light, d_misc, d_o, d_d = _k4_outputs(table, light, misc,
                                                     ray_o, ray_d)
    n = ray_o.shape[0]
    if n == 0:
        return d_table, d_light, d_misc, d_o, d_d
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.psdr_shade_bwd(
            table.data_ptr(), light.data_ptr(), misc.data_ptr(),
            table.shape[0], light.shape[1], ids.data_ptr(), us.data_ptr(),
            vs.data_ptr(), ray_o.data_ptr(), ray_d.data_ptr(),
            active.data_ptr(), lane.data_ptr(), seed, n, depth, cnt0,
            int(hide_emitters), ct.data_ptr(), d_table.data_ptr(),
            d_light.data_ptr(), d_misc.data_ptr(), d_o.data_ptr(),
            d_d.data_ptr(), _cuda.stream_of(dev))
    _cuda.check(err, "K4 launch")
    _cuda.LAUNCHES["K4"] += 1
    return d_table, d_light, d_misc, d_o, d_d


@k4_op.register_fake
def _(table, light, misc, ray_o, ray_d, ids, us, vs, active, lane, seed,
      depth, cnt0, hide_emitters, ct):
    return _k4_outputs(table, light, misc, ray_o, ray_d)


def _k3_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:10])
    ctx.args = inputs[10:]


def _k3_backward(ctx, ct):
    table, light, misc, ray_o, ray_d, ids, us, vs, active, lane = (
        ctx.saved_tensors)
    grads = shade_adjoint_cuda(table, light, misc, ids, us, vs, ray_o, ray_d,
                               active, lane, *ctx.args, ct.contiguous())
    return (*grads,) + (None,) * 9


k3_op.register_autograd(_k3_backward, setup_context=_k3_setup)


def li_attached(table, light, misc, ids, us, vs, ray_o, ray_d, active, lane,
                seed: int, depth: int, cnt0: int,
                hide_emitters: bool = False):
    """The attached Li of stashed paths, ``(N, 3)``: K3 with K4 as its
    backward on CUDA tensors, :func:`li_attached_plain` (differentiated
    by autograd) on CPU tensors."""
    if ray_o.device.type == "cpu":
        return li_attached_plain(table, light, misc, ids, us, vs, ray_o,
                                 ray_d, active, lane, seed, depth, cnt0,
                                 hide_emitters)
    return shade_cuda(
        table.contiguous(), light.contiguous(), misc.contiguous(), ids, us,
        vs, ray_o.contiguous(), ray_d.contiguous(), active,
        mk._lane_i32(lane), seed, depth, cnt0, hide_emitters)


def li_interior(sd, ray, active, lane, seed: int, depth: int, cnt0: int,
                hide_emitters: bool = False):
    """Attached interior Li (JAX ``shade_mega.li_interior``): K2 stash
    traces the detached paths, then :func:`li_attached` shades them from
    the attached tables. Same sampler schedule as the detached Li (two
    draws per depth from ``cnt0``); differentiable with respect to every
    float table of ``sd`` it reads and to the camera ray."""
    ro = ray.o.reshape(-1, 3)
    rd = ray.d.reshape(-1, 3)
    act = active.reshape(-1)
    lane = lane.reshape(-1)
    with torch.no_grad():
        tables = mk.build_tables(sd)
        _, (ids, us, vs) = mk.li_mega_stash(
            *(t.detach() for t in tables), ro.detach().contiguous(),
            rd.detach().contiguous(), act, lane, seed, depth, cnt0,
            hide_emitters)
    table, light, misc = attached_tables(sd)
    out = li_attached(table, light, misc, ids, us, vs, ro, rd, act, lane,
                      seed, depth, cnt0, hide_emitters)
    return out.reshape(active.shape + (3,))
