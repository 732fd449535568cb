"""Emitter base class (counterpart of ``psdr_jit_tpu/emitter/emitter.py``,
reference include/psdr/emitter/emitter.h:8-66)."""

from __future__ import annotations

from ..core.object import Object


class Emitter(Object):
    """Interface: the scene compile turns each emitter into configured
    data with a normalized ``sampling_weight``, on which the methods below
    run (``AreaLightData``, ``EnvironmentMapData``):

    * ``eval(its, active)``: the radiance emitted toward ``its.wi``;
    * ``sample_position(ref_p, sample2, active, u_coin)``: a
      :class:`~psdr_jit_tpu_torch.core.records.PositionSample`;
    * ``sample_position_pdf(ref_p, its, active)``: its density."""

    sampling_weight: float = 1.0

    def eval(self, its, active):
        raise NotImplementedError

    def sample_position(self, ref_p, sample2, active, u_coin=None):
        raise NotImplementedError

    def sample_position_pdf(self, ref_p, its, active):
        raise NotImplementedError
