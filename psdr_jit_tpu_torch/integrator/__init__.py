from .base import Integrator
from .path import PathTracer
from .direct import Direct
from .collocated import CollocatedIntegrator
from .field import FieldExtractionIntegrator

__all__ = [
    "Integrator", "PathTracer", "Direct", "CollocatedIntegrator",
    "FieldExtractionIntegrator",
]
