"""psdr_jit_tpu_torch: the PyTorch and CUDA port of psdr_jit_tpu.

The JAX package ``psdr_jit_tpu`` is the reference; this package mirrors
its layout and names. It holds, for the megakernel's scene class (constant
one-sided diffuse materials lit by one area light), the primal render
``PathTracer(max_depth).renderC`` and the training step
``PathTracer(max_depth).loss_and_grad`` with the interior and primary-edge
terms, through hand-written Hopper kernels (``csrc/``): K1, the closest-hit
sweep; K2, the detached path-traced Li in its single, pair and stash
modes; K3, the attached interior shade; and K4, K3's adjoint. On CPU
tensors every kernel entry runs its plain PyTorch version instead; on CUDA
tensors it launches the kernel or raises.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
built at their first launch (``ops/_cuda.py``).
"""

from .core.types import RenderOption, Ray, Intersection
from .core.sampler import Sampler
from .shape.mesh import Mesh
from .bsdf.diffuse import DiffuseBSDF
from .emitter.area import AreaLight
from .sensor.perspective import PerspectiveCamera
from .scene.scene import Scene, SceneData
from .integrator.base import Integrator
from .integrator.path import PathTracer
from .interop import scene_to_arrays, params_to_torch

__all__ = [
    "RenderOption", "Ray", "Intersection", "Sampler", "Mesh", "DiffuseBSDF",
    "AreaLight", "PerspectiveCamera", "Scene", "SceneData", "Integrator",
    "PathTracer", "scene_to_arrays", "params_to_torch",
]
