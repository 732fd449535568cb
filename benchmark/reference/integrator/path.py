"""Unidirectional path tracer (copied from
``psdr_jit_tpu_torch/integrator/path.py``) with every Li on the general
path, :meth:`PathTracer._li_general`: next-event estimation and the BSDF
bounce (:func:`nee_contribution`, :func:`bsdf_bounce`), each intersection
the plain sweep. It draws as the port's megakernels do, so it is their
estimator lane for lane. The secondary-edge term comes from
:class:`edge.SecondaryEdgeMixin`."""

from __future__ import annotations

import torch

from ..core.math import dot, mis_weight, safe_div, safe_sqrt
from ..core.types import EPSILON, SHADOW_EPSILON, Ray
from . import base
from .base import Integrator, builds_graph
from .edge import SecondaryEdgeMixin


def nee_contribution(sd, its, sampler, active, throughput,
                     diff: bool = False, tape=None):
    """Next-event estimation (path.cpp:47-83): the light sample draws one
    counter (``next_2d``), then, where ``sd.emitter_coin_needed`` (an
    environment map's table with alias rows), the alias coin. With
    ``diff`` the contribution is attached (the light point, the shadow
    ray's hit and the materials carry gradients; the MIS pdfs do not)."""
    u2 = sampler.next_2d()
    coin = sampler.next_1d() if sd.emitter_coin_needed else None
    ps = sd.sample_emitter_position(its.p, u2, active, coin)
    active_direct = active & ps.is_valid & ~sd.is_emitter(its, active)
    wod = ps.p - its.p
    dist_sqr = dot(wod, wod)
    dist = safe_sqrt(dist_sqr)
    wod = wod * safe_div(torch.ones_like(dist), dist)[..., None]
    its1 = sd.ray_intersect(Ray(its.p, wod), active_direct, tape=tape)
    active_direct = (active_direct & its1.valid
                     & (its1.t > dist - SHADOW_EPSILON)
                     & sd.is_emitter(its1, active_direct))
    g_val = safe_div(torch.abs(dot(its1.n, -wod)), dist_sqr)
    emitter_val = sd.Le(its1, active)
    wo_local = its.sh_frame.to_local(wod)
    bsdf_val = sd.eval_bsdf(its, wo_local, active_direct) * (
        g_val * ps.J * safe_div(torch.ones_like(ps.pdf), ps.pdf))[..., None]
    pdf1 = sd.pdf_bsdf(its, wo_local, active_direct) * (
        g_val.detach() if diff else g_val)
    active_direct = active_direct & (pdf1 != 0.0)
    weight1 = mis_weight(ps.pdf, pdf1)
    contrib = throughput * emitter_val * bsdf_val * weight1[..., None]
    return torch.where(active_direct[..., None], contrib, 0.0)


def bsdf_bounce(sd, its, sampler, active, diff: bool = False, tape=None):
    """BSDF-sampled bounce (path.cpp:85-123): one counter
    (``next_nd(3)``). Returns ``(its1, active, bsdf weight (..., 3), MIS
    weight)``. With ``diff`` the weight is the path-space form, attached:
    the direction from the attached hit points, the geometry term and
    the material-form Jacobian over the detached solid-angle pdf."""
    bs = sd.sample_bsdf(its, sampler.next_nd(3), active)
    ray = Ray(its.p, its.sh_frame.to_world(bs.wo))
    its1 = sd.ray_intersect(ray, active, tape=tape)
    active = active & bs.is_valid & its1.valid
    if diff:
        wo = (its1.p - its.p) * safe_div(torch.ones_like(its1.t),
                                         its1.t)[..., None]
        g_val = safe_div(torch.abs(dot(its1.n, -wo)), its1.t * its1.t)
        jac = torch.where(its1.valid, its1.J, 1.0)
        g_val = torch.where(its1.valid, g_val, 1.0)
        pdf0 = bs.pdf * g_val.detach()
        bsdf_val = sd.eval_bsdf(its, its.sh_frame.to_local(wo), active) * (
            g_val * jac * safe_div(torch.ones_like(pdf0), pdf0))[..., None]
    else:
        g_val = safe_div(torch.abs(dot(its1.n, -ray.d)), its1.t * its1.t)
        pdf0 = bs.pdf * g_val
        bsdf_val = sd.eval_bsdf(its, bs.wo, active) * safe_div(
            torch.ones_like(bs.pdf), bs.pdf)[..., None]
    bsdf_val = torch.where((its1.t.detach() < EPSILON)[..., None], 0.0,
                           bsdf_val)
    weight2 = mis_weight(pdf0, sd.emitter_position_pdf(its.p, its1, active))
    return its1, active, bsdf_val, weight2


class PathTracer(SecondaryEdgeMixin, Integrator):
    """PathTracer(max_depth) with next-event estimation and MIS, and the
    guided secondary-edge term (``preprocess_secondary_edges``)."""

    supports_prb = True  # path replay under REMAT_MODE "prb" (prb.py)
    supports_bounce_remat = True  # its Li checkpoints bounces ("bounce")

    def __init__(self, max_depth: int = 1, hide_emitters: bool = False):
        if max_depth < 0:
            raise ValueError("max_depth must be >= 0")
        SecondaryEdgeMixin.__init__(self)
        self.max_depth = int(max_depth)
        self.hide_emitters = bool(hide_emitters)

    def Li(self, sd, sampler, ray, active, diff: bool = False,
           vjp_ok: bool = False, tape=None):
        """Radiance along ``ray`` by :meth:`_li_general` (detached, or
        attached with ``diff``); advances ``sampler.cnt`` by ``2 *
        max_depth`` (``3 * max_depth`` where the emitters take an alias
        coin). ``vjp_ok`` is accepted and unused."""
        return self._li_general(sd, sampler, ray, active, diff, tape)

    def _li_general(self, sd, sampler, ray, active, diff: bool = False,
                    tape=None):
        """The Li of any scene the port holds (``_li_xla`` of the JAX
        package); draws as K2 does, so it is lane for lane the
        megakernel's estimator. Detached: the ray is detached and every
        intersection is rebuilt in the path formulation. Attached
        (``diff``): the camera ray's hit in the solid-angle formulation,
        every later one in the path formulation; under ``REMAT_MODE``
        "bounce" each bounce is checkpointed where the render records a
        graph."""
        if not diff:
            ray = Ray(ray.o.detach(), ray.d.detach())
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path",
                               tape=tape)
        active = active & its.valid
        throughput = torch.ones(its.t.shape + (3,), dtype=torch.float32,
                                device=its.t.device)
        result = (torch.zeros_like(throughput) if self.hide_emitters
                  else sd.Le(its, active))

        def bounce(its, active, throughput, cnt):
            sampler.cnt = cnt  # a recompute draws the same counters
            r = nee_contribution(sd, its, sampler, active, throughput, diff,
                                 tape)
            its, active, bsdf_val, weight2 = bsdf_bounce(sd, its, sampler,
                                                         active, diff, tape)
            throughput = throughput * bsdf_val
            contrib = sd.Le(its, active) * throughput * weight2[..., None]
            r = r + torch.where(active[..., None], contrib, 0.0)
            return r, its, active, throughput

        per_bounce = (diff and tape is None and base.REMAT_MODE == "bounce"
                      and builds_graph(sd))
        for _ in range(self.max_depth):
            cnt = sampler.cnt
            if per_bounce:
                r, its, active, throughput = base._checkpoint(
                    bounce, its, active, throughput, cnt)
            else:
                r, its, active, throughput = bounce(its, active, throughput,
                                                    cnt)
            result = result + r
        return result
