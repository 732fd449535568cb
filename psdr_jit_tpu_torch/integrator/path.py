"""Unidirectional path tracer (counterpart of
``psdr_jit_tpu/integrator/path.py``, through the megakernels only): the
detached Li and its pair through K2, the attached interior Li through K2
stash, K3 and K4."""

from __future__ import annotations

from ..ops import megakernel as mega
from ..ops import shade_mega
from .base import Integrator, _NOT_PORTED


def _out_of_scope(what: str) -> NotImplementedError:
    return NotImplementedError(
        "scenes outside the megakernel's scope (one-sided constant "
        "DiffuseBSDFs, one AreaLight, at most "
        f"{mega.MEGA_MAX_TRIS} triangles, at most "
        f"{shade_mega.MAX_LIGHT_TRIS} light triangles) need the general "
        f"path-traced {what}, which " + _NOT_PORTED)


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

        Detached (``diff=False``): :func:`mega.li_mega`. Attached
        (``diff=True``, for the training step's reverse-mode pullback):
        :func:`shade_mega.li_interior`, whose K4 backward serves reverse
        mode only."""
        if diff:
            if not shade_mega.applicable(sd):
                raise _out_of_scope("attached Li")
            out = shade_mega.li_interior(
                sd, ray, active, sampler.lane, sampler.seed_value,
                depth=self.max_depth, cnt0=sampler.cnt,
                hide_emitters=self.hide_emitters)
        else:
            if not mega.applicable(sd):
                raise _out_of_scope("Li")
            out = mega.li_mega(
                *mega.build_tables(sd), ray.o.reshape(-1, 3).contiguous(),
                ray.d.reshape(-1, 3).contiguous(), active.reshape(-1),
                sampler.lane.reshape(-1), sampler.seed_value,
                depth=self.max_depth, cnt0=sampler.cnt,
                hide_emitters=self.hide_emitters).reshape(active.shape + (3,))
        sampler.cnt += 2 * self.max_depth
        return out

    def Li_pair(self, sd, sampler, ray_n, ray_p, active):
        """Detached ``Li(ray_n) - Li(ray_p)`` for the primary-edge pass
        (reference integrator.cpp:185-186) in one K2 pair launch; draws as
        two sequential Li calls, so ``sampler.cnt`` advances by
        ``4 * max_depth``."""
        if not mega.applicable(sd):
            raise _out_of_scope("Li")
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
