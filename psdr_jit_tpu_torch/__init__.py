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

The reference-compatible surface of the JAX package's ``__init__`` is
here too: the ``Object`` base of every scene class, the C/D aliases of the
records (``RayC``/``RayD``, ...: one type each here, as there), the
``transform`` helpers, ``EdgeSortOption`` and ``AQ_Option``, and the
smoke checks ``drjit_test``, ``drjit_memory`` and ``optix_jit_test``, which
run on the card unless the caller passes ``device="cpu"``.

Importing the package needs neither CUDA nor ``nvcc``: the kernels are
built at their first launch (``ops/_cuda.py``).
"""

import dataclasses as _dataclasses

import torch as _torch

from .core.types import RenderOption, Ray, Frame, Intersection
from .core.object import Object
from .core.bitmap import Bitmap, Bitmap1f, Bitmap3f
from .core.records import SampleRecord, PositionSample, SensorDirectSample
from .core import transform
from .core.sampler import Sampler
from .core.distribution import DiscreteDistribution
from .shape.mesh import Mesh
from .bsdf.bsdf import BSDF
from .bsdf.diffuse import DiffuseBSDF
from .bsdf.microfacet import MicrofacetBSDF
from .bsdf.microfacet_pv import MicrofacetBSDFPerVertex
from .bsdf.normalmap import NormalMapBSDF
from .bsdf.roughconductor import RoughConductorBSDF
from .bsdf.roughdielectric import RoughDielectricBSDF
from .emitter.emitter import Emitter
from .emitter.area import AreaLight
from .emitter.envmap import EnvironmentMap
from .sensor.sensor import Sensor
from .sensor.perspective import PerspectiveCamera
from .sensor.orthographic import OrthographicCamera
from .scene.scene import Scene, SceneData, _checked_device
from .integrator import (Integrator, PathTracer, Direct,
                         CollocatedIntegrator, FieldExtractionIntegrator)
from .interop import scene_to_arrays, params_to_torch
from .scene.loader import load_file, load_string

# The reference's detached/attached (C/D) type pairs: one type each here,
# the derivative seams being explicit detaches (JAX __init__.py:82-95).
Bitmap1fD = Bitmap1f
Bitmap3fD = Bitmap3f
RayC = RayD = Ray
FrameC = FrameD = Frame
# the reference's Interaction base (intersection.h:7-20) is Intersection
Interaction = Intersection
InteractionC = InteractionD = Intersection
IntersectionC = IntersectionD = Intersection
SampleRecordC = SampleRecordD = SampleRecord
PositionSampleC = PositionSampleD = PositionSample


@_dataclasses.dataclass
class EdgeSortOption:
    """Bound but unused in the reference (types.h:230-237,
    psdr.cpp:145-151); kept for scripts that construct it."""

    enable_sort: bool = False
    local_angle: float = 180.0
    global_angle: float = 90.0
    min_global_step: int = 1
    max_depth: int = 1


@_dataclasses.dataclass
class AQ_Option:
    """Adaptive-quadrature guiding options, dead code in the reference
    (types.h:240-268); accepted for compatibility and unused."""

    num_x: int = 1
    num_y: int = 1
    num_z: int = 1
    thold: float = 0.0
    wt1: float = 0.0
    max_depth: int = 0
    final_spp: int = 0
    RMSE_wt: float = 0.0
    eps: float = 0.0


def drjit_test(device="cuda"):
    """Autograd smoke check (the reference's psdr.cpp:70-86): the gradient
    of sum(2a) on ``device`` is 2 everywhere."""
    a = _torch.arange(4.0, device=_checked_device(device)).requires_grad_()
    (g,) = _torch.autograd.grad((a * 2.0).sum(), a)
    print("backward grad of sum(2a):", g.tolist())
    if not bool((g == 2.0).all()):
        raise AssertionError(f"grad of sum(2a) is {g.tolist()}, not 2")
    return True


def drjit_memory(device="cuda"):
    """Store and read-back smoke check (psdr.cpp:89-98): 1,024 floats
    tripled on ``device`` and read back on the host."""
    a = _torch.arange(1024, dtype=_torch.float32,
                      device=_checked_device(device))
    b = (a * 3.0).cpu().numpy()
    if b[-1] != (1024 - 1) * 3.0:
        raise AssertionError(f"read back {b[-1]}, not {(1024 - 1) * 3.0}")
    return True


def optix_jit_test(device="cuda"):
    """Intersection smoke check (psdr.cpp:65-68): four rays along +z
    through two parallel quads at z = 2 and 4 must all hit the nearer
    one. On the card the closest hit is K1; on the CPU its plain version.
    True where the ids resolve front to back."""
    from .ops.intersect import ray_intersect_detached

    dev = _checked_device(device)

    def f32(x):
        return _torch.tensor(x, dtype=_torch.float32, device=dev)

    p0 = f32([[-1, -1, 2], [-1, -1, 4]])
    e1 = f32([[2, 0, 0], [2, 0, 0]])
    e2 = f32([[0, 2, 0], [0, 2, 0]])
    ray = Ray(_torch.zeros((4, 3), dtype=_torch.float32, device=dev),
              f32([[0, 0, 1.0]] * 4))
    tri_id, valid, _, t = ray_intersect_detached(p0, e1, e2, ray)
    print("closest-hit ids:", tri_id.tolist(), "t:", t.tolist())
    return bool(valid.all()) and bool((tri_id == 0).all())


__version__ = "0.4.0"

__all__ = [
    "Object",
    "RenderOption", "Ray", "RayC", "RayD", "Frame", "FrameC", "FrameD",
    "Interaction", "InteractionC", "InteractionD",
    "Intersection", "IntersectionC", "IntersectionD",
    "SampleRecord", "SampleRecordC", "SampleRecordD",
    "PositionSample", "PositionSampleC", "PositionSampleD",
    "SensorDirectSample",
    "Sampler", "DiscreteDistribution",
    "Bitmap", "Bitmap1f", "Bitmap3f", "Bitmap1fD", "Bitmap3fD", "transform",
    "Mesh", "Scene", "SceneData", "load_file", "load_string",
    "BSDF", "DiffuseBSDF", "MicrofacetBSDF", "MicrofacetBSDFPerVertex",
    "RoughConductorBSDF", "RoughDielectricBSDF", "NormalMapBSDF",
    "Emitter", "AreaLight", "EnvironmentMap",
    "Sensor", "PerspectiveCamera", "OrthographicCamera",
    "Integrator", "PathTracer", "Direct", "CollocatedIntegrator",
    "FieldExtractionIntegrator",
    "EdgeSortOption", "AQ_Option",
    "drjit_test", "drjit_memory", "optix_jit_test",
    "scene_to_arrays", "params_to_torch",
]
