"""Sample records (counterpart of ``psdr_jit_tpu/core/records.py``,
reference include/psdr/core/records.h and bsdf/bsdf.h:11-19)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PositionSample:
    """Emitter surface position sample (records.h:39-47)."""

    p: torch.Tensor         # (..., 3)
    n: torch.Tensor         # (..., 3)
    pdf: torch.Tensor       # (...,)
    J: torch.Tensor         # (...,) path-space Jacobian (1 when detached)
    is_valid: torch.Tensor  # (...,) bool


@dataclasses.dataclass
class BSDFSample:
    """BSDF direction sample in the local frame (bsdf/bsdf.h:11-19)."""

    wo: torch.Tensor        # (..., 3)
    pdf: torch.Tensor       # (...,)
    eta: torch.Tensor       # (...,)
    is_valid: torch.Tensor  # (...,) bool
