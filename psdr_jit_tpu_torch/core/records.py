"""Sample records (counterpart of ``psdr_jit_tpu/core/records.py``,
reference include/psdr/core/records.h and bsdf/bsdf.h:11-19)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SampleRecord:
    """Base record (records.h:39-44): a pdf and a validity mask, the
    reference's ``SampleRecordC/D`` (psdr.cpp:252-258)."""

    pdf: torch.Tensor       # (...,)
    is_valid: torch.Tensor  # (...,) bool


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


@dataclasses.dataclass
class SensorDirectSample:
    """Projection of a world point to the sensor (sensor/sensor.h:10-19)."""

    q: torch.Tensor           # (..., 2) sample-space position
    pixel_idx: torch.Tensor   # (...,) int64, -1 off screen
    sensor_val: torch.Tensor  # (...,) importance W_e
    is_valid: torch.Tensor    # (...,) bool


@dataclasses.dataclass
class BoundarySegSample:
    """Secondary-edge boundary segment sample (records.h:50-59)."""

    p0: torch.Tensor        # (..., 3) point on the edge, attached
    edge: torch.Tensor      # (..., 3) unit edge direction, detached
    edge2: torch.Tensor     # (..., 3) edge start to face 0's third vertex
    p2: torch.Tensor        # (..., 3) point on an emitter, detached
    n: torch.Tensor         # (..., 3) emitter normal
    pdf: torch.Tensor       # (...,)
    is_valid: torch.Tensor  # (...,) bool
