"""The benchmark's plain reference renderer: a frozen copy of
psdr_jit_tpu_torch's plain PyTorch path (its pure-PyTorch intersection,
the general path tracer ``PathTracer._li_general``, the edge estimators
and the training step), taken at commit 9e647a1 with every kernel route
removed. It imports nothing of the port: the benchmark builds its scenes
from the same arrays on both sides and holds the port's outputs against
this package's (``benchmark/check.py``).

Departures from the copied modules: ``ops/intersect.py`` keeps only the
unculled plain sweep (``ray_intersect_brute``, the plain version of K1 and
K5, on every device); ``integrator/path.py`` routes every Li through the
general path (the megakernels' estimator lane for lane, drawn in the same
order); the loader, the other integrators, sharding and the host library
are left out.
"""
from .core.types import RenderOption, Ray
from .core.bitmap import Bitmap
from .shape.mesh import Mesh
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
from .scene.scene import Scene
from .integrator import Integrator, PathTracer
from .interop import scene_from_arrays
