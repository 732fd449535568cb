"""Unidirectional path tracer (counterpart of
``psdr_jit_tpu/integrator/path.py``).

The detached Li runs through K2 (``ops/megakernel.py``) for the
megakernel's scene class and through :meth:`PathTracer._li_general`, the
JAX package's ``_li_xla`` in PyTorch, for every other scene: next-event
estimation and the BSDF bounce (:func:`nee_contribution`,
:func:`bsdf_bounce`), each intersection routed by ``SceneData.ray_intersect``
to K1, K5 or K6. The attached interior Li of the training step runs through
K2 stash, K3 and K4 for the megakernel's scene class only.
"""

from __future__ import annotations

import torch

from ..core.math import dot, mis_weight, safe_div, safe_sqrt
from ..core.types import EPSILON, SHADOW_EPSILON, Ray
from ..ops import megakernel as mega
from ..ops import shade_mega
from .base import Integrator, _NOT_PORTED


def _out_of_scope(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} of a scene outside the megakernels' scope (one-sided "
        "constant DiffuseBSDFs, one AreaLight, at most "
        f"{mega.MEGA_MAX_TRIS} triangles, at most "
        f"{shade_mega.MAX_LIGHT_TRIS} light triangles): the attached "
        "general Li, for training on such scenes, " + _NOT_PORTED)


def nee_contribution(sd, its, sampler, active, throughput):
    """Next-event estimation (path.cpp:47-83), detached: the light sample
    draws one counter (``next_2d``); an area light draws no alias coin."""
    u2 = sampler.next_2d()
    ps = sd.sample_emitter_position(its.p, u2, active)
    active_direct = active & ps.is_valid & ~sd.is_emitter(its, active)
    wod = ps.p - its.p
    dist_sqr = dot(wod, wod)
    dist = safe_sqrt(dist_sqr)
    wod = wod * safe_div(torch.ones_like(dist), dist)[..., None]
    its1 = sd.ray_intersect(Ray(its.p, wod), active_direct)
    active_direct = (active_direct & its1.valid
                     & (its1.t > dist - SHADOW_EPSILON)
                     & sd.is_emitter(its1, active_direct))
    g_val = safe_div(torch.abs(dot(its1.n, -wod)), dist_sqr)
    emitter_val = sd.Le(its1, active)
    wo_local = its.sh_frame.to_local(wod)
    bsdf_val = sd.eval_bsdf(its, wo_local, active_direct) * (
        g_val * ps.J * safe_div(torch.ones_like(ps.pdf), ps.pdf))[..., None]
    pdf1 = sd.pdf_bsdf(its, wo_local, active_direct) * g_val
    active_direct = active_direct & (pdf1 != 0.0)
    weight1 = mis_weight(ps.pdf, pdf1)
    contrib = throughput * emitter_val * bsdf_val * weight1[..., None]
    return torch.where(active_direct[..., None], contrib, 0.0)


def bsdf_bounce(sd, its, sampler, active):
    """BSDF-sampled bounce (path.cpp:85-123), detached: one counter
    (``next_nd(3)``). Returns ``(its1, active, bsdf weight (..., 3), MIS
    weight)``."""
    bs = sd.sample_bsdf(its, sampler.next_nd(3), active)
    ray = Ray(its.p, its.sh_frame.to_world(bs.wo))
    its1 = sd.ray_intersect(ray, active)
    active = active & bs.is_valid & its1.valid
    g_val = safe_div(torch.abs(dot(its1.n, -ray.d)), its1.t * its1.t)
    pdf0 = bs.pdf * g_val
    bsdf_val = sd.eval_bsdf(its, bs.wo, active) * safe_div(
        torch.ones_like(bs.pdf), bs.pdf)[..., None]
    bsdf_val = torch.where((its1.t < EPSILON)[..., None], 0.0, bsdf_val)
    weight2 = mis_weight(pdf0, sd.emitter_position_pdf(its.p, its1, active))
    return its1, active, bsdf_val, weight2


class PathTracer(Integrator):
    """PathTracer(max_depth) with next-event estimation and MIS."""

    def __init__(self, max_depth: int = 1, hide_emitters: bool = False):
        if max_depth < 0:
            raise ValueError("max_depth must be >= 0")
        self.max_depth = int(max_depth)
        self.hide_emitters = bool(hide_emitters)

    def Li(self, sd, sampler, ray, active, diff: bool = False):
        """Radiance along ``ray``; advances ``sampler.cnt`` by
        ``2 * max_depth`` like the JAX package's draw schedule.

        Detached (``diff=False``): K2 (:func:`mega.li_mega`) where
        ``mega.applicable(sd)``, else :meth:`_li_general`. Attached
        (``diff=True``, for the training step's reverse-mode pullback):
        :func:`shade_mega.li_interior`, whose K4 backward serves reverse
        mode only."""
        if diff:
            if not shade_mega.applicable(sd):
                raise _out_of_scope("the attached Li")
            out = shade_mega.li_interior(
                sd, ray, active, sampler.lane, sampler.seed_value,
                depth=self.max_depth, cnt0=sampler.cnt,
                hide_emitters=self.hide_emitters)
        elif mega.applicable(sd):
            out = mega.li_mega(
                *mega.build_tables(sd), ray.o.reshape(-1, 3).contiguous(),
                ray.d.reshape(-1, 3).contiguous(), active.reshape(-1),
                sampler.lane.reshape(-1), sampler.seed_value,
                depth=self.max_depth, cnt0=sampler.cnt,
                hide_emitters=self.hide_emitters).reshape(active.shape + (3,))
        else:
            return self._li_general(sd, sampler, ray, active)
        sampler.cnt += 2 * self.max_depth
        return out

    def _li_general(self, sd, sampler, ray, active):
        """The detached Li of any scene the port holds (``_li_xla`` of the
        JAX package with ``diff=False``); draws as K2 does, so it is lane
        for lane the megakernel's estimator."""
        ray = Ray(ray.o.detach(), ray.d.detach())
        its = sd.ray_intersect(ray, active)
        active = active & its.valid
        throughput = torch.ones(its.t.shape + (3,), dtype=torch.float32,
                                device=its.t.device)
        result = (torch.zeros_like(throughput) if self.hide_emitters
                  else sd.Le(its, active))
        for _ in range(self.max_depth):
            r = nee_contribution(sd, its, sampler, active, throughput)
            its, active, bsdf_val, weight2 = bsdf_bounce(sd, its, sampler,
                                                         active)
            throughput = throughput * bsdf_val
            contrib = sd.Le(its, active) * throughput * weight2[..., None]
            result = result + (r + torch.where(active[..., None], contrib,
                                               0.0))
        return result

    def Li_pair(self, sd, sampler, ray_n, ray_p, active):
        """Detached ``Li(ray_n) - Li(ray_p)`` for the primary-edge pass
        (reference integrator.cpp:185-186) in one K2 pair launch; draws as
        two sequential Li calls, so ``sampler.cnt`` advances by
        ``4 * max_depth``."""
        if not mega.applicable(sd):
            raise _out_of_scope("the primary-edge Li")
        out = mega.li_mega_pair(
            *mega.build_tables(sd),
            ray_n.o.reshape(-1, 3).contiguous(),
            ray_n.d.reshape(-1, 3).contiguous(),
            ray_p.o.reshape(-1, 3).contiguous(),
            ray_p.d.reshape(-1, 3).contiguous(), active.reshape(-1),
            sampler.lane.reshape(-1), sampler.seed_value,
            depth=self.max_depth, cnt0=sampler.cnt,
            hide_emitters=self.hide_emitters)
        sampler.cnt += 4 * self.max_depth
        return out.reshape(active.shape + (3,))
