"""Secondary-edge (visibility) boundary term (counterpart of
``psdr_jit_tpu/integrator/edge.py``; reference path.cpp:130-294).

The estimator samples a point ``p0`` on a silhouette-candidate edge and a
point ``p2`` on a light, traces ``p0 -> p2`` (the light must be visible)
and ``p0 -> -dir`` to the receiver ``p1``, projects ``p1`` to the sensor
and accumulates

    f(p1) * Le(p2) * base_v * W_e / pdf  *  dot(n, u2)

where only ``dot(n, u2)``, the normal velocity of the edge point found by
re-intersecting the shadow ray with the light's triangle differentiably,
carries derivatives (path.cpp:171-270). The three rays a lane traces go
through the closest hit (K1 on the Cornell box), one launch each: the
visibility rays, then the receiver rays of the lanes that see their light,
then the camera ray toward ``p1``, re-intersected in the solid-angle formulation so that its hit point
carries the receiver's and the camera's gradients.
"""

from __future__ import annotations

import torch

from ..core.distribution import HyperCubeDistribution
from ..core.math import (bilinear, cross, detached, dot, norm, normalize,
                         ray_intersect_triangle, safe_div, scrub_nonfinite)
from ..core.sampler import Sampler
from ..core.types import EPSILON, SHADOW_EPSILON, Ray
from ..ops.gather import gather_rows
from .base import STREAM_SECONDARY

def eval_secondary_edge(sd, sensor, sample3, diff: bool, u_coin=None,
                        u_coin_emitter=None):
    """``(pixel_idx, value)`` of the boundary samples ``sample3`` (N, 3).

    ``diff=True``: ``value`` is derivative-only (``result -
    result.detach()``), attached to the edge vertices, the light's
    triangles, the receiver's triangle and the camera pose.
    ``diff=False``: ``value`` is the detached guiding integrand (no normal
    velocity factor) and every pixel index is -1.
    ``u_coin``, ``u_coin_emitter``: the edge table's and the emitters'
    alias coins, where they need one."""
    bss = sd.sample_boundary_segment_direct(sample3, u_coin=u_coin,
                                            u_coin_emitter=u_coin_emitter)
    with detached():
        valid = bss.is_valid
        p0, p2 = bss.p0.detach(), bss.p2
        dir_ = normalize(p2 - p0)
        its2 = sd.ray_intersect(Ray(p0, dir_), valid)
        # the light point must be visible from the edge (path.cpp:186-191)
        valid = (valid & sd.is_emitter(its2, valid) & its2.valid
                 & (norm(its2.p - p2) < SHADOW_EPSILON))
        # the opposite ray finds the receiver p1 (path.cpp:194-196)
        its1 = sd.ray_intersect(Ray(p0, -dir_), valid)
        valid = valid & its1.valid
        p1 = its1.p
        # project p1 to the image plane (path.cpp:199)
        sds = sensor.sample_direct(p1)
        valid = valid & sds.is_valid

    # the camera ray toward that pixel must see p1 (path.cpp:203-215)
    camera_ray = sensor.sample_primary_ray(sds.q, diff=diff)
    if diff:
        its_c = sd.ray_intersect(camera_ray, valid, mode="solid")
    with detached():
        if not diff:
            its_c = sd.ray_intersect(camera_ray, valid)
        valid = (valid & its_c.valid
                 & (norm(its_c.p.detach() - p1) < SHADOW_EPSILON)
                 & (sd.bsdf_slot(its_c) >= 0))

        # change of variables from edge point to image sample
        # (path.cpp:219-227)
        dist = norm(p2 - p1)
        cos2 = torch.abs(dot(bss.n, -dir_))
        e = cross(bss.edge, dir_)
        sinphi = norm(e)
        proj = normalize(cross(e, bss.n))
        sinphi2 = norm(cross(dir_, proj))
        base_v = safe_div(its1.t, dist) * safe_div(sinphi, sinphi2) * cos2
        valid = valid & (sinphi > EPSILON) & (sinphi2 > EPSILON)

        # the receiver's BSDF with the shading-normal correction
        # (path.cpp:229-250)
        d0 = -camera_ray.d.detach()
        d0_local = its1.sh_frame.to_local(d0)
        bsdf_val = sd.eval_bsdf(its1, d0_local, valid)
        correction = torch.abs(safe_div(
            its1.wi[..., 2] * dot(d0, its1.n),
            d0_local[..., 2] * dot(dir_, its1.n)))
        bsdf_val = bsdf_val * correction[..., None]
        le = sd.Le(its2, valid)
        value0 = bsdf_val * le * (base_v * sds.sensor_val
                                  * safe_div(1.0, bss.pdf))[..., None]
        value0 = torch.where(valid[..., None], value0, 0.0)
        if not diff:
            return torch.full(valid.shape, -1, dtype=torch.int64,
                              device=valid.device), value0

        # orientation sign (path.cpp:253-258): +-1, never 0, at an exact
        # zero dot product (torch.sign would drop the lane)
        nrm = normalize(cross(bss.n, proj))
        sgn = (torch.where(dot(e, bss.edge2) >= 0.0, 1.0, -1.0)
               * torch.where(dot(e, nrm) >= 0.0, 1.0, -1.0))
        value0 = value0 * sgn[..., None]

    # the differentiable normal velocity (path.cpp:260-265): the shadow ray
    # from the camera's hit to the edge point, against the light's triangle
    # (its2's id indexes the scene's, possibly Morton-ordered, triangles)
    tri_idx = torch.clamp(its2.tri_id, min=0).long()
    v0 = gather_rows(sd.tri.p0, tri_idx)
    e1 = gather_rows(sd.tri.e1, tri_idx)
    e2 = gather_rows(sd.tri.e2, tri_idx)
    shadow_ray = Ray(its_c.p, normalize(bss.p0 - its_c.p))
    uv, _ = ray_intersect_triangle(v0, e1, e2, shadow_ray)
    u2 = bilinear(v0.detach(), e1.detach(), e2.detach(), uv)
    result = value0 * dot(nrm, u2)[..., None]
    result = torch.where(valid[..., None], result, 0.0)
    result = result - result.detach()
    return torch.where(valid, sds.pixel_idx, -1), result


def _guiding_round(sd, sensor_id: int, seed: int, base, unit, cell_idx,
                   num_cells: int, spp_cell: int):
    """One detached sweep of the guiding grid (path.cpp:130-168): each of
    ``spp_cell`` samples a cell adds the largest channel of its integrand
    into the cell's mass. The sums run through ``index_add_``, whose float
    atomics on the card vary in their last bits from run to run."""
    n = cell_idx.shape[0]
    sampler = Sampler(seed, torch.arange(n, dtype=torch.int64,
                                         device=cell_idx.device))
    sample3 = (base + sampler.next_nd(3)) * unit
    se_coin = sampler.next_1d() if sd.sec_edge_distrb.needs_coin else None
    em_coin = sampler.next_1d() if sd.emitter_coin_needed else None
    _, value0 = eval_secondary_edge(sd, sd.sensors[sensor_id], sample3,
                                    diff=False, u_coin=se_coin,
                                    u_coin_emitter=em_coin)
    value0 = scrub_nonfinite(value0)
    if spp_cell > 1:
        value0 = value0 / float(spp_cell)
    mass = value0.amax(-1)
    return torch.zeros(num_cells, dtype=torch.float32,
                       device=mass.device).index_add_(0, cell_idx, mass)


class SecondaryEdgeMixin:
    """Guided secondary-edge rendering for an integrator: the guiding table
    ``warpper`` (the reference's name) maps a sensor to its
    :class:`HyperCubeDistribution`."""

    def __init__(self):
        self.warpper = {}

    def preprocess_secondary_edges(self, scene, sensor_id: int, reso,
                                   nrounds: int = 1, seed: int = 0):
        """Build the guiding table of ``sensor_id`` (path.cpp:130-168):
        ``reso = (n0, n1, n2, spp)``, a grid over the boundary samples'
        unit cube with ``spp`` detached samples a cell, averaged over
        ``nrounds`` rounds of seeds ``seed + 7919 j``. The masses are read
        back to the host, which builds the alias rows of a grid above
        ``SEARCHSORTED_DENSE_MAX`` cells; the table lives on the scene's
        device."""
        if nrounds <= 0:
            raise ValueError("nrounds must be positive")
        sd = scene.data
        reso = tuple(int(r) for r in reso)
        grid, spp_cell = reso[:3], reso[3]
        num_cells = grid[0] * grid[1] * grid[2]
        dev = sd.tri.p0.device
        with detached():
            cell_idx = torch.arange(num_cells * spp_cell, dtype=torch.int64,
                                    device=dev) // spp_cell
            shape = HyperCubeDistribution(res=grid)
            base = shape.cell_coords(cell_idx).to(torch.float32)
            unit = 1.0 / shape._res_f32(base)
            result = torch.zeros(num_cells, dtype=torch.float32, device=dev)
            for j in range(nrounds):
                result = result + _guiding_round(
                    sd, sensor_id, (seed + j * 7919) & 0xFFFFFFFF, base,
                    unit, cell_idx, num_cells, spp_cell)
            if nrounds > 1:
                result = result / float(nrounds)
        self.warpper[sensor_id] = HyperCubeDistribution.init(
            grid, result).with_alias()

    def secondary_edge_vals(self, sd, opts, sensor_id: int, seed: int):
        """``chunk_vals(lane)`` of the derivative-only secondary-edge term
        (path.cpp:274-294), attached to ``sd``'s tables: the training
        step pulls it back (``render_secondary_edges``), ``renderD``
        splats it into an image. Each lane draws ``next_nd(3)``, then the
        guiding table's coin where it needs one, the edge table's, and
        the emitter table's."""
        warp = self.warpper.get(sensor_id)
        sensor = sd.sensors[sensor_id]

        def chunk_vals(lane):
            sampler = Sampler(seed + STREAM_SECONDARY, lane)
            sample3 = sampler.next_nd(3)
            pdf0 = None
            if warp is not None:
                w_coin = sampler.next_1d() if warp.needs_coin else None
                sample3, pdf0 = warp.sample_reuse(sample3, w_coin)
            se_coin = (sampler.next_1d() if sd.sec_edge_distrb.needs_coin
                       else None)
            em_coin = sampler.next_1d() if sd.emitter_coin_needed else None
            idx, value = eval_secondary_edge(sd, sensor, sample3, diff=True,
                                             u_coin=se_coin,
                                             u_coin_emitter=em_coin)
            if pdf0 is not None:
                value = torch.where((pdf0 > EPSILON)[..., None],
                                    safe_div(value, pdf0[..., None]), value)
            if opts.sppse > 1:
                value = value / float(opts.sppse)
            return value, idx

        return chunk_vals
