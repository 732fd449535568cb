"""psdr_jit_tpu_torch: the PyTorch and CUDA port of psdr_jit_tpu.

The JAX package ``psdr_jit_tpu`` is the reference; this package mirrors
its layout and names. It holds the primal render
``PathTracer(max_depth).renderC`` of scenes of constant diffuse materials
lit by area lights, from the Cornell box to 10^5 triangles, and, for the
megakernel's scene class (constant one-sided diffuse materials lit by one
area light, at most 192 triangles), the training step
``PathTracer(max_depth).loss_and_grad`` with the interior, primary-edge
and secondary-edge terms, the last guided by
``PathTracer.preprocess_secondary_edges``. Hand-written Hopper kernels
(``csrc/``) carry them: K1, K5 and K6,
the closest-hit sweeps of small, mid-size and large scenes; K2, the
detached path-traced Li in its single, pair and stash modes; K3, the
attached interior shade; and K4, K3's adjoint. On CPU tensors every kernel
entry runs its plain PyTorch version instead; on CUDA tensors it launches
the kernel or raises. The entry points build scenes on the card unless
the caller asks for the CPU (``device="cpu"``).

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
built at their first launch (``ops/_cuda.py``).
"""

from .core.types import RenderOption, Ray, Intersection
from .core.sampler import Sampler
from .shape.mesh import Mesh
from .bsdf.diffuse import DiffuseBSDF
from .emitter.area import AreaLight
from .sensor.perspective import PerspectiveCamera
from .sensor.orthographic import OrthographicCamera
from .scene.scene import Scene, SceneData
from .integrator.base import Integrator
from .integrator.path import PathTracer
from .interop import scene_to_arrays, params_to_torch

__all__ = [
    "RenderOption", "Ray", "Intersection", "Sampler", "Mesh", "DiffuseBSDF",
    "AreaLight", "PerspectiveCamera", "OrthographicCamera", "Scene",
    "SceneData", "Integrator", "PathTracer", "scene_to_arrays",
    "params_to_torch",
]
