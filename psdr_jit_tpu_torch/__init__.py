"""psdr_jit_tpu_torch: the PyTorch and CUDA port of psdr_jit_tpu.

The JAX package ``psdr_jit_tpu`` is the reference; this package mirrors
its layout and names. It renders (``PathTracer(max_depth).renderC``;
also ``Direct``, ``CollocatedIntegrator`` and the AOVs of
``FieldExtractionIntegrator``), differentiates renders (``renderD``,
forward and reverse mode, ``PSDR_REMAT`` choosing how reverse mode bounds
its memory) and trains (``loss_and_grad`` with the interior, primary-edge
and secondary-edge terms, the last guided by
``preprocess_secondary_edges``; sharded over the pixels of several ranks
with ``parallel.make_fused_train_step``) on
triangle scenes of up to 10^5 triangles, with or without texture
coordinates, with ``DiffuseBSDF``s, ``MicrofacetBSDF``s,
``RoughConductorBSDF``s and ``RoughDielectricBSDF``s (constant or
textured parameters), ``MicrofacetBSDFPerVertex`` and ``NormalMapBSDF``s,
lit by ``AreaLight``s and an ``EnvironmentMap``. Hand-written Hopper
kernels (``csrc/``) carry them:
K1, K5 and K6, the closest-hit sweeps of small, mid-size and large
scenes; and for the megakernels' scene class (constant one-sided diffuse
materials lit by one area light, at most 192 triangles) K2, the detached
path-traced Li in its single, pair and stash modes, K3, the attached
interior shade, and K4, K3's adjoint. On CPU tensors every kernel entry
runs its plain PyTorch version instead; on CUDA tensors it launches the
kernel or raises. The entry points build scenes on the card unless the
caller asks for the CPU (``device="cpu"``), scenes loaded from files
(``load_file``, Mitsuba-style XML with OBJ meshes and EXR, PFM or NPY
images, read by the host library ``native/``) among them.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
built at their first launch (``ops/_cuda.py``).
"""

from .core.types import RenderOption, Ray, Intersection
from .core.sampler import Sampler
from .shape.mesh import Mesh
from .core.bitmap import Bitmap, Bitmap1f, Bitmap3f
from .bsdf.diffuse import DiffuseBSDF
from .bsdf.microfacet import MicrofacetBSDF
from .bsdf.microfacet_pv import MicrofacetBSDFPerVertex
from .bsdf.normalmap import NormalMapBSDF
from .bsdf.roughconductor import RoughConductorBSDF
from .bsdf.roughdielectric import RoughDielectricBSDF
from .emitter.area import AreaLight
from .emitter.envmap import EnvironmentMap
from .sensor.perspective import PerspectiveCamera
from .sensor.orthographic import OrthographicCamera
from .scene.scene import Scene, SceneData
from .integrator import (Integrator, PathTracer, Direct,
                         CollocatedIntegrator, FieldExtractionIntegrator)
from .interop import scene_to_arrays, params_to_torch
from .scene.loader import load_file, load_string

__all__ = [
    "RenderOption", "Ray", "Intersection", "Sampler", "Mesh", "DiffuseBSDF",
    "MicrofacetBSDF", "RoughConductorBSDF", "RoughDielectricBSDF",
    "MicrofacetBSDFPerVertex", "NormalMapBSDF", "Bitmap", "Bitmap1f", "Bitmap3f", "AreaLight",
    "EnvironmentMap", "PerspectiveCamera", "OrthographicCamera", "Scene",
    "SceneData", "Integrator", "PathTracer", "Direct",
    "CollocatedIntegrator", "FieldExtractionIntegrator", "scene_to_arrays",
    "params_to_torch", "load_file", "load_string",
]
