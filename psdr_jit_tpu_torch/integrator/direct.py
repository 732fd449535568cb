"""Single-bounce direct illumination (counterpart of
``psdr_jit_tpu/integrator/direct.py``; reference src/integrator/direct.cpp).

``mis``: 0 is next-event estimation alone, its MIS weight forced to 1; 1
is BSDF sampling alone, its weight 1; 2 is both under MIS. A technique
that ``mis`` leaves out draws nothing, so the draws are the JAX package's
lane for lane. Every intersection goes through ``SceneData.ray_intersect``
(K1, K5 or K6), never the megakernels.
"""

from __future__ import annotations

import torch

from ..core.math import dot, safe_div, safe_sqrt
from ..core.types import SHADOW_EPSILON, Ray
from .base import Integrator
from .edge import SecondaryEdgeMixin
from .path import bsdf_bounce, nee_contribution


class Direct(SecondaryEdgeMixin, Integrator):
    """Direct(mis=2, hide_emitters=False), with the guided secondary-edge
    term (``preprocess_secondary_edges``) as ``PathTracer`` has it."""

    def __init__(self, mis: int = 2, hide_emitters: bool = False):
        if mis not in (0, 1, 2):
            raise ValueError("mis must be 0 (NEE), 1 (BSDF sampling) or 2 "
                             "(MIS)")
        SecondaryEdgeMixin.__init__(self)
        self.mis = int(mis)
        self.hide_emitters = bool(hide_emitters)

    def Li(self, sd, sampler, ray, active, diff: bool = False,
           vjp_ok: bool = False, tape=None):
        """Radiance along ``ray``: emission at the camera hit, plus the
        light sample (``mis`` 0 or 2: one counter, and the alias coin where
        ``sd.emitter_coin_needed``) and the BSDF sample (``mis`` 1 or 2: one
        counter). Attached (``diff``): the camera hit in the solid-angle
        formulation, the others in the path formulation."""
        if not diff:
            ray = Ray(ray.o.detach(), ray.d.detach())
        its = sd.ray_intersect(ray, active, mode="solid" if diff else "path",
                               tape=tape)
        active = active & its.valid
        throughput = torch.ones(its.t.shape + (3,), dtype=torch.float32,
                                device=its.t.device)
        result = (torch.zeros_like(throughput) if self.hide_emitters
                  else sd.Le(its, active))
        if self.mis == 0:
            result = result + _nee_no_mis(sd, its, sampler, active,
                                          throughput, tape)
        elif self.mis == 2:
            result = result + nee_contribution(sd, its, sampler, active,
                                               throughput, diff, tape)
        if self.mis != 0:
            its1, active, bsdf_val, weight2 = bsdf_bounce(sd, its, sampler,
                                                          active, diff, tape)
            if self.mis == 1:
                weight2 = torch.ones_like(weight2)
            contrib = sd.Le(its1, active) * (throughput * bsdf_val) * (
                weight2[..., None])
            result = result + torch.where(active[..., None], contrib, 0.0)
        return result


def _nee_no_mis(sd, its, sampler, active, throughput, tape=None):
    """Next-event estimation with its MIS weight 1 (direct.cpp:80-82):
    ``nee_contribution``'s draws and shadow ray, without the BSDF pdf."""
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
    bsdf_val = sd.eval_bsdf(its, its.sh_frame.to_local(wod), active_direct) * (
        g_val * ps.J * safe_div(torch.ones_like(ps.pdf), ps.pdf))[..., None]
    contrib = throughput * emitter_val * bsdf_val
    return torch.where(active_direct[..., None], contrib, 0.0)
