from .base import Integrator
from .path import PathTracer
