"""Scene container and scene compile (counterpart of
``psdr_jit_tpu/scene/scene.py``).

:class:`Scene` is the user-facing container (``add_Sensor``, ``add_BSDF``,
``add_Mesh``, ``configure``). :meth:`Scene.configure_data` packs the
world-space triangle SoA, the per-mesh BSDF and emitter slots, the emitter
weights, the cameras, (when ``sppe > 0``) the primary-edge tables and
(when ``sppse > 0``) the secondary-edge table with its length-weighted
sampling distribution into a :class:`SceneData` on ``Scene.device``.

The compile runs in float32 on the CPU and then moves to the device, so a
scene's tables are the same bits whichever device renders it. It is
differentiable: the parameters a training step sets on the scene objects
(vertex positions, transforms, reflectances, radiances; on any device)
are copied to the CPU inside the autograd graph, and the final ``.to``
copy to the device is in the graph too, so gradients on the device's
tables flow back to them. The BSDFs' parameters, which the compile only
carries, go to the device directly (a texture set on the card stays
there).

Above 256 faces the global triangle stream is permuted into the Morton
order of the faces' world centroids (:func:`morton_order`), the JAX
package's permutation bit for bit, so that triangle ids compare one to one
and the intersection kernels' clusters and tree leaves are spatially
tight.

:class:`SceneData` also holds the shading interface of the general path
tracer (``integrator/path.py``): the path-formulation intersection, the
per-lane BSDF and emitter dispatch and the emitter sampling; and the
secondary-edge term's boundary-segment sampling and differentiable
(``mode="solid"``) intersection.

A scene with an :class:`~psdr_jit_tpu_torch.emitter.envmap.EnvironmentMap`
(one at most) gets an inward-facing box around the scene and its cameras,
the bounding mesh, whose emitter is the map; it stays at the tail of the
triangle order. The map's importance table is built by
:meth:`Scene.configure` and cached on the map.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.types import (EDGE_EPSILON, EPSILON, RenderOption, Ray, Frame,
                          Intersection)
from ..core.math import (bilinear, cross, detached, dot, norm, normalize,
                         ray_intersect_triangle, safe_div, safe_sqrt,
                         sign_eps, squared_norm)
from ..core.object import Object
from ..core.distribution import (SEARCHSORTED_DENSE_MAX,
                                 DiscreteDistribution)
from ..core.records import BoundarySegSample, PositionSample
from ..shape.mesh import Mesh, SecondaryEdgeInfo, TriangleInfo, cpu_f32
from ..sensor.sensor import floored_edge_distrb
from ..bsdf.bsdf import (BSDF, eval_dispatch, material_table, pdf_dispatch,
                         sample_dispatch)
from ..bsdf.microfacet_pv import MicrofacetBSDFPerVertex
from ..emitter.area import AreaLight, AreaLightData, area_light_weight
from ..emitter.envmap import (EnvironmentMap, EnvironmentMapData,
                              build_envmap_distribution)
from ..core.bitmap import Bitmap
from ..ops import intersect
from ..ops.gather import gather_rows
from ..utils import profiling

# Scenes above this many faces get the Morton triangle order (the JAX
# package's threshold, scene.py _compute_tri_perm).
MORTON_MIN_FACES = 256


def _expand_bits10(v):
    """Spread the low 10 bits of ``v`` (uint32) three apart."""
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_order(centroids) -> np.ndarray:
    """Permutation of the rows of ``centroids`` (n, 3) by the 30-bit Morton
    code of each inside their bounding box, stable for equal codes: the
    arithmetic of the JAX package's host library (``hostops.cpp``
    ``morton_order``): ``inv = 1023 / extent`` in float32, then ``(c - lo) *
    inv``, clamped to [0, 1023] and truncated."""
    c = np.ascontiguousarray(centroids, np.float32).reshape(-1, 3)
    if c.shape[0] == 0:
        return np.zeros(0, np.int32)
    lo = c.min(0)
    ext = c.max(0) - lo
    with np.errstate(divide="ignore"):
        inv = np.where(ext > 0, np.float32(1023.0) / ext,
                       np.float32(0.0)).astype(np.float32)
    f = (c - lo) * inv
    q = np.minimum(np.maximum(f, np.float32(0.0)),
                   np.float32(1023.0)).astype(np.uint32)
    code = ((_expand_bits10(q[:, 0]) << np.uint32(2))
            | (_expand_bits10(q[:, 1]) << np.uint32(1))
            | _expand_bits10(q[:, 2]))
    return np.argsort(code, kind="stable").astype(np.int32)


def tree_map(fn, x):
    """Apply ``fn`` to every tensor of a SceneData (dataclasses, such as
    bitmaps, tuples and configured BSDFs), rebuilding the containers."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(tree_map(fn, v) for v in x)
    if isinstance(x, BSDF):
        y = copy.copy(x)
        for name in x._tensor_fields:
            setattr(y, name, tree_map(fn, getattr(x, name)))
        return y
    return x


@dataclasses.dataclass
class SceneData:
    """Everything a render needs, as tensors on one device."""

    tri: TriangleInfo
    face_normal_mask: torch.Tensor   # (F,) bool, per-face use_face_normals
    face_mesh_id: torch.Tensor       # (F,) int32
    mesh_bsdf_slot: torch.Tensor     # (M,) int32, -1 = none
    mesh_emitter_slot: torch.Tensor  # (M,) int32, -1 = none
    bsdfs: tuple                     # BSDF objects
    emitters: tuple                  # AreaLightData, EnvironmentMapData
    emitters_distrb: Optional[DiscreteDistribution]
    sensors: tuple                   # SensorData
    lower: torch.Tensor              # (3,) scene AABB (with an envmap, the
    upper: torch.Tensor              # (3,) bounding mesh's box)
    # the edges of every edge-enabled mesh in mesh order, and their
    # length-weighted distribution (sppse > 0 only)
    sec_edge: Optional[SecondaryEdgeInfo] = None
    sec_edge_distrb: Optional[DiscreteDistribution] = None
    # each face's corner UVs (F, 3, 2), zeros on meshes without; has_uv:
    # some mesh has UVs, so hits interpolate them and build UV frames
    tri_uv: Optional[torch.Tensor] = None
    has_uv: bool = False
    # some BSDF (or a normal map's nested BSDF) is per-vertex, so hits
    # gather their face's vertex ids
    has_pv: bool = False
    # each mesh's static ``Mesh.id`` string, in mesh order (the bounding
    # mesh's is ""): the field integrator's per-object filter
    mesh_ids: tuple = ()

    @profiling.spanned("hits")
    def ray_intersect(self, ray: Ray, active=None, mode: str = "path",
                      tape=None) -> Intersection:
        """Closest hit (scene.cpp:736-806). The kernel's payload is
        detached; ``mode`` says how the hit is rebuilt from it:

        * ``"path"``: the path formulation. The hit point is ``p0 + e1*u +
          e2*v`` at the payload's barycentrics, ``t`` its distance from
          the ray origin, and ``J`` the material-form Jacobian
          ``face_area / detach(face_area)`` (1 in value);
        * ``"solid"``: the solid-angle formulation. Moller-Trumbore runs
          again, differentiably, on the hit triangle's rows and the ray:
          ``p = o + t d``, ``wi`` from ``-d``, ``J = 1``.

        The rows are gathered with ``ops.gather.gather_rows``, so a hit
        point carries the gradients of the triangle tables (and, in solid
        mode, of the ray) unless they are detached. Where the hit face has
        texture coordinates whose triangle is not degenerate (``det !=
        0``), ``uv`` interpolates them, ``dp_du``/``dp_dv`` are the surface's
        UV tangents and the shading frame's ``s`` is ``dp_du`` made
        orthogonal to the shading normal (scene.cpp:727-759, in the JAX
        package's expression order); elsewhere the frame is
        ``Frame.from_normal`` of the shading normal, and ``uv`` and the
        tangents are 0. ``face_indices`` are the hit face's vertex ids in
        its mesh (the per-vertex BSDFs' rows) where ``has_pv``, else 0.

        ``tape`` (:class:`integrator.prb.IntersectTape`; where None, the
        tape of the enclosing checkpointed chunk, if any): recording, the
        kernel's detached payload ``(tri_id, valid, uv)`` is appended to
        it; replaying, the next payload is taken from it and no kernel is
        launched, so a chunk rebuilt in the backward sweep traces no ray
        again.

        The whole hit, kernel and rebuild, is the span ``hits``
        (``utils.profiling``), which counts the ``rays`` it takes and the
        ``active`` ones among them."""
        from ..integrator.prb import current_tape

        tri = self.tri
        if tape is None:
            tape = current_tape()
        if tape is not None and tape.replaying:
            tri_id, valid, uv = tape.pop()
        else:
            tree = (self.bvh if intersect.needs_tree(tri.p0.shape[0],
                                                     tri.p0.device)
                    else None)
            tri_id, valid, uv, _ = intersect.ray_intersect_detached(
                tri.p0, tri.e1, tri.e2, ray, active, tree)
            if tape is not None:
                tape.append((tri_id, valid, uv))
        if profiling.counting():
            n = tri_id.numel()
            profiling.count("rays", n)
            profiling.count("active", n if active is None else active.sum())
        idx = torch.clamp(tri_id, min=0).long()  # cast once for the rows

        def rows(x):
            return gather_rows(x, idx)

        p0, e1, e2 = rows(tri.p0), rows(tri.e1), rows(tri.e2)
        if mode == "path":
            p = bilinear(p0, e1, e2, uv)
            dirv = p - ray.o
            t = norm(dirv)
            wi_dir = -(dirv * safe_div(torch.ones_like(t), t)[..., None])
            face_area = rows(tri.face_area[:, None])[..., 0]
            jac = safe_div(face_area, face_area.detach())
        elif mode == "solid":
            uv, t = ray_intersect_triangle(p0, e1, e2, ray)
            p = ray.o + ray.d * t[..., None]
            wi_dir = -ray.d
            jac = torch.ones_like(t)
        else:
            raise ValueError(f"mode {mode!r}: 'path' or 'solid'")
        n0 = rows(tri.n0)
        sh_n = normalize(bilinear(n0, rows(tri.n1) - n0, rows(tri.n2) - n0,
                                  uv))
        face_normal = rows(tri.face_normal)
        sh_n = torch.where(rows(self.face_normal_mask)[..., None],
                           face_normal, sh_n)
        frame = Frame.from_normal(sh_n)
        if self.has_uv:
            uvs = rows(self.tri_uv.reshape(-1, 6))
            uv0, uv1, uv2 = uvs[..., 0:2], uvs[..., 2:4], uvs[..., 4:6]
            its_uv = bilinear(uv0, uv1 - uv0, uv2 - uv0, uv)
            duv0, duv1 = uv1 - uv0, uv2 - uv0
            det = duv0[..., 0] * duv1[..., 1] - duv0[..., 1] * duv1[..., 0]
            inv_det = safe_div(torch.ones_like(det), det)[..., None]
            valid_dp = (det != 0.0)[..., None]
            dp_du = torch.where(valid_dp, (duv1[..., 1:2] * e1
                                           - duv0[..., 1:2] * e2) * inv_det,
                                0.0)
            dp_dv = torch.where(valid_dp, (-duv1[..., 0:1] * e1
                                           + duv0[..., 0:1] * e2) * inv_det,
                                0.0)
            s = torch.where(valid_dp, normalize(
                dp_du - sh_n * dot(sh_n, dp_du)[..., None]), frame.s)
            frame = Frame(s, torch.where(valid_dp, cross(sh_n, s), frame.t),
                          sh_n)
        else:
            zero = t.new_zeros(())
            its_uv = zero.expand(t.shape + (2,))
            dp_du = dp_dv = zero.expand(t.shape + (3,))
        return Intersection(
            valid=valid, t=t, p=p, n=face_normal, sh_frame=frame,
            wi=frame.to_local(wi_dir), J=jac, bc=uv,
            tri_id=tri_id, mesh_id=rows(self.face_mesh_id), uv=its_uv,
            dp_du=dp_du, dp_dv=dp_dv,
            face_indices=(rows(tri.face_indices) if self.has_pv else
                          tri.face_indices.new_zeros(()).expand(
                              t.shape + (3,))))

    # -- per-lane emitter and BSDF dispatch (scene.py:236-270) --------------
    def emitter_slot(self, its: Intersection):
        slot = self.mesh_emitter_slot[torch.clamp(its.mesh_id, min=0).long()]
        return torch.where(its.valid, slot, -1)

    def is_emitter(self, its: Intersection, active):
        return active & its.valid & (self.emitter_slot(its) >= 0)

    def Le(self, its: Intersection, active):
        """Emitted radiance at a hit (intersection.h:31-42): ``(..., 3)``."""
        slot = self.emitter_slot(its)
        result = torch.zeros(its.t.shape + (3,), dtype=torch.float32,
                             device=its.t.device)
        for i, em in enumerate(self.emitters):
            m = active & (slot == i)
            result = torch.where(m[..., None], em.eval(its, m), result)
        return result

    @functools.cached_property
    def bvh(self):
        """The tree K1, K5 or K6 walks over the triangles
        (``intersect.routing_tree``), built for the scene's device at first
        use from the detached geometry; a new scene compile makes a new
        SceneData, and with it a new tree."""
        tri = self.tri
        return intersect.routing_tree(tri.p0.detach(), tri.e1.detach(),
                                      tri.e2.detach())

    @functools.cached_property
    def materials(self):
        """The BSDFs' per-type parameter tables on the scene's device,
        built at first use (``bsdf.material_table``)."""
        return material_table(self.bsdfs, self.tri.p0.device)

    def bsdf_slot(self, its: Intersection):
        slot = self.mesh_bsdf_slot[torch.clamp(its.mesh_id, min=0).long()]
        return torch.where(its.valid, slot, -1)

    def eval_bsdf(self, its, wo, active):
        return eval_dispatch(self.materials, self.bsdf_slot(its), its, wo,
                             active)

    def sample_bsdf(self, its, rnd3, active):
        return sample_dispatch(self.materials, self.bsdf_slot(its), its, rnd3,
                               active)

    def pdf_bsdf(self, its, wo, active):
        return pdf_dispatch(self.materials, self.bsdf_slot(its), its, wo,
                            active)

    # -- emitter sampling (scene.cpp:987-1024) ------------------------------
    def sample_emitter_position(self, ref_p, sample2, active,
                                u_coin=None) -> PositionSample:
        """A point on a light: one light directly, several through the
        emitter distribution with the second uniform reused. ``u_coin``:
        the environment map's alias coin, where
        :attr:`emitter_coin_needed`."""
        if not self.emitters:
            raise ValueError("the scene has no emitter")
        if len(self.emitters) == 1:
            return self.emitters[0].sample_position(ref_p, sample2, active,
                                                    u_coin)
        e_idx, e_pdf, u = self.emitters_distrb.sample_reuse(sample2[..., 1])
        sample2 = torch.stack([sample2[..., 0], u], dim=-1)
        out = None
        for i, em in enumerate(self.emitters):
            m = active & (e_idx == i)
            ps = em.sample_position(ref_p, sample2, m, u_coin)
            if out is None:
                out = ps
                continue
            out = PositionSample(
                p=torch.where(m[..., None], ps.p, out.p),
                n=torch.where(m[..., None], ps.n, out.n),
                pdf=torch.where(m, ps.pdf, out.pdf),
                J=torch.where(m, ps.J, out.J),
                is_valid=torch.where(m, ps.is_valid, out.is_valid))
        out.pdf = out.pdf * e_pdf
        return out

    def emitter_position_pdf(self, ref_p, its: Intersection, active):
        slot = self.emitter_slot(its)
        result = torch.zeros(its.t.shape, dtype=torch.float32,
                             device=its.t.device)
        for i, em in enumerate(self.emitters):
            m = active & (slot == i)
            result = torch.where(m, em.sample_position_pdf(ref_p, its, m),
                                 result)
        return result

    @property
    def emitter_coin_needed(self) -> bool:
        """Whether emitter-position sampling takes an alias coin, as an
        environment map's importance table with alias rows does: callers
        draw one more uniform iff this holds (JAX scene.py:275-284)."""
        return any(isinstance(em, EnvironmentMapData)
                   and em.cell_distrb.needs_coin for em in self.emitters)

    # -- boundary segment sampling (scene.cpp:1027-1068) --------------------
    def sample_boundary_segment_direct(self, sample3, active=None,
                                       u_coin=None, u_coin_emitter=None
                                       ) -> BoundarySegSample:
        """A segment from a point on a silhouette-candidate edge to a point
        on a light. The first uniform picks the edge by length (``u_coin``:
        the edge table's alias coin where it needs one) and is reused along
        it; the other two sample the light (``u_coin_emitter``: the
        environment map's alias coin where it needs one). The edge point
        ``p0`` carries the gradients of the edge's vertices; all else is
        detached. A segment is valid where the light faces the edge point
        and the edge is a boundary edge or a silhouette seen from the light
        point."""
        se = self.sec_edge
        if se is None:
            raise ValueError("no secondary edges configured: set sppse > 0 "
                             "before the scene compile")
        if active is None:
            active = torch.ones(sample3.shape[:-1], dtype=torch.bool,
                                device=sample3.device)
        edge_idx, pdf0, u0 = self.sec_edge_distrb.sample_reuse(
            sample3[..., 0], u_coin)
        edge_idx = edge_idx.long()  # cast once for the rows

        def rows(x):
            return gather_rows(x, edge_idx)

        p0_edge, e1 = rows(se.p0), rows(se.e1)
        p0 = p0_edge + e1 * u0[..., None]
        with detached():
            n0, n1, p2_third = rows(se.n0), rows(se.n1), rows(se.p2)
            is_boundary = rows(se.is_boundary)
            e1_det = e1.detach()
            edge_dir = normalize(e1_det)
            edge2 = p2_third - p0_edge.detach()
            p0_det = p0.detach()
            pdf0 = safe_div(pdf0, norm(e1_det))
            ps2 = self.sample_emitter_position(p0_det, sample3[..., 1:3],
                                               active, u_coin_emitter)
            e = ps2.p - p0_det
            dist_sqr = squared_norm(e)
            e = e * safe_div(1.0, safe_sqrt(dist_sqr))[..., None]
            cos_theta = dot(ps2.n, -e)
            sgn0 = sign_eps(dot(n0, e), EDGE_EPSILON)
            sgn1 = sign_eps(dot(n1, e), EDGE_EPSILON)
            is_valid = (active & ps2.is_valid & (cos_theta > EPSILON)
                        & ((is_boundary & (sgn0 != 0))
                           | (~is_boundary & (sgn0 * sgn1 < 0))))
            pdf = torch.where(is_valid,
                              pdf0 * ps2.pdf * safe_div(dist_sqr, cos_theta),
                              0.0)
        return BoundarySegSample(p0=p0, edge=edge_dir, edge2=edge2, p2=ps2.p,
                                 n=ps2.n, pdf=pdf, is_valid=is_valid)


class Scene(Object):
    """Mutable scene container mirroring the reference Python API, with
    the device its data lives on."""

    def __init__(self, device="cuda"):
        self.device = _checked_device(device)
        self.opts = RenderOption()
        self.meshes: list = []
        self.bsdfs: list = []
        self.bsdf_ids: list = []
        self.emitters: list = []
        self.sensors: list = []
        self.emitter_env: Optional[EnvironmentMap] = None
        self.param_map: dict = {}
        self.seed = 0
        self._data: Optional[SceneData] = None
        self._tri_perm = None
        self._sec_edge_distrb_cache: Optional[DiscreteDistribution] = None
        self._pe_distrb_caches: dict = {}
        # the sensors of the last configure() that get primary-edge tables;
        # None: all of them
        self._active_sensors = None

    @classmethod
    def from_arrays(cls, arrays, device="cuda") -> "Scene":
        """Build a scene from :func:`psdr_jit_tpu_torch.interop.scene_to_arrays`
        output (or the ``.npz`` it was saved to)."""
        from ..interop import scene_from_arrays

        return scene_from_arrays(arrays, device)

    # -- builders (psdr.cpp:406-418) ---------------------------------------
    @property
    def num_sensors(self) -> int:
        return len(self.sensors)

    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

    def get_num_emitters(self) -> int:
        return len(self.emitters)

    def add_Sensor(self, sensor):
        self.sensors.append(sensor)
        self._rebuild_param_map()
        return len(self.sensors) - 1

    def add_BSDF(self, bsdf, bsdf_id: str = "", twoSide: bool = False):
        bsdf.twoSide = bool(twoSide)
        bsdf.id = bsdf_id
        self.bsdfs.append(bsdf)
        self.bsdf_ids.append(bsdf_id)
        self._rebuild_param_map()
        return len(self.bsdfs) - 1

    def add_EnvironmentMap(self, env, to_world=None, scale=None):
        """Add the scene's one environment map: an :class:`EnvironmentMap`,
        or a radiance array with its transform and scale (the reference's
        two overloads, psdr.cpp:397-398)."""
        if self.emitter_env is not None:
            raise ValueError("A scene is only allowed to have one envmap!")
        if not isinstance(env, EnvironmentMap):
            env = EnvironmentMap(env, scale=1.0 if scale is None else scale)
        elif scale is not None:
            env.scale = scale
        if to_world is not None:
            env.to_world_raw = torch.as_tensor(to_world, dtype=torch.float32)
        self.emitter_env = env
        self.emitters.append(env)
        self._rebuild_param_map()

    def add_Mesh(self, mesh_or_file, transform=None, bsdf_id: str = "",
                 emitter: Optional[AreaLight] = None):
        """Add a :class:`Mesh`, or the OBJ file at a path, with its
        transform, the id of its BSDF and its area light."""
        mesh = (mesh_or_file if isinstance(mesh_or_file, Mesh)
                else Mesh().load(str(mesh_or_file)))
        if transform is not None:
            mesh.to_world_raw = torch.as_tensor(transform, dtype=torch.float32)
        if bsdf_id != "":
            if bsdf_id not in self.bsdf_ids:
                raise KeyError(f"Unknown BSDF id {bsdf_id!r}")
            mesh.bsdf_id = self.bsdf_ids.index(bsdf_id)
        if emitter is not None:
            emitter.mesh_index = len(self.meshes)
            mesh.emitter_id = len(self.emitters)
            self.emitters.append(emitter)
        self.meshes.append(mesh)
        self._rebuild_param_map()
        return mesh

    def add_normalmap_BSDF(self, nmap_bsdf, nested_bsdf, bsdf_id: str = "",
                           twoSide: bool = False):
        """Add a :class:`NormalMapBSDF` of the normal map ``nmap_bsdf`` (a
        bitmap, or a normal-map BSDF whose map is taken) over
        ``nested_bsdf`` (psdr.cpp add_normalmap_BSDF); its slot."""
        from ..bsdf.normalmap import NormalMapBSDF

        nm = NormalMapBSDF(getattr(nmap_bsdf, "nmap", nmap_bsdf),
                           nested_bsdf, twoSide=twoSide)
        return self.add_BSDF(nm, bsdf_id, twoSide)

    # -- loading (reference Scene.load_file/load_string, psdr.cpp:407-408)
    def load_file(self, file_name: str, auto_configure: bool = True):
        """Take the scene of an XML file (``scene.loader``), built on this
        scene's device; ``configure()`` it unless ``auto_configure`` is
        off."""
        from .loader import load_file

        self._adopt(load_file(file_name, self.device), auto_configure)

    def load_string(self, scene_xml: str, auto_configure: bool = True):
        """As :meth:`load_file`, from XML text (files resolve against the
        working directory)."""
        from .loader import load_string

        self._adopt(load_string(scene_xml, device=self.device),
                    auto_configure)

    def _adopt(self, other: "Scene", auto_configure: bool):
        for name in ("opts", "meshes", "bsdfs", "bsdf_ids", "emitters",
                     "sensors", "emitter_env", "param_map"):
            setattr(self, name, getattr(other, name))
        self._data = self._tri_perm = self._sec_edge_distrb_cache = None
        self._pe_distrb_caches = {}
        if auto_configure:
            self.configure()

    def _rebuild_param_map(self):
        pm = {}
        for name, objs in (("Mesh", self.meshes), ("BSDF", self.bsdfs),
                           ("Emitter", self.emitters),
                           ("Sensor", self.sensors)):
            for i, obj in enumerate(objs):
                pm[f"{name}[{i}]"] = obj
                if getattr(obj, "id", "") and name in ("Mesh", "BSDF"):
                    pm[f"{name}[id={obj.id}]"] = obj
        self.param_map = pm

    # -- scene compile (scene.cpp:311-600) -----------------------------------
    def configure_data(self, active_sensors=None) -> SceneData:
        """The scene data of the current parameters, attached to them;
        where ``sppe > 0``, the sensors of ``active_sensors`` (all when
        None) get primary-edge tables, the others none (JAX
        scene.py:747-752). The renders pass the last ``configure()``'s
        list (``_active_sensors``)."""
        if not self.meshes:
            raise ValueError("Missing meshes!")
        if not self.sensors:
            raise ValueError("Missing sensor!")
        opts = self.opts
        mesh_list = list(self.meshes)
        mesh_datas = [m.configure_data(with_edges=opts.sppse > 0)
                      for m in mesh_list]
        lower = torch.stack([md.vertex_positions.detach().amin(0)
                             for md in mesh_datas]).amin(0)
        upper = torch.stack([md.vertex_positions.detach().amax(0)
                             for md in mesh_datas]).amax(0)
        env = self.emitter_env
        if env is not None:
            # the bounding mesh (scene.py:576-618), the last mesh
            lower, upper = self._sky_box(lower, upper)
            bound = _make_bound_mesh(lower, upper)
            bound.emitter_id = self.emitters.index(env)
            env.mesh_index = len(mesh_list)
            mesh_list.append(bound)
            mesh_datas.append(bound.configure_data())
        tri = TriangleInfo(*(
            torch.cat([getattr(md.tri, f.name) for md in mesh_datas])
            for f in dataclasses.fields(TriangleInfo)))
        face_normal_mask = torch.cat([
            torch.full((m.num_faces,), bool(m.use_face_normals))
            for m in mesh_list])
        face_mesh_id = torch.cat([
            torch.full((m.num_faces,), i, dtype=torch.int32)
            for i, m in enumerate(mesh_list)])
        tri_uv = torch.cat([md.tri_uv for md in mesh_datas])
        # Morton-reorder the global triangle stream (scene.py:635-651): the
        # permutation comes from the last configure() and stays as it is
        # when parameters move
        perm = self._tri_perm
        if perm is not None and perm.shape[0] <= face_mesh_id.shape[0]:
            full = torch.cat([torch.from_numpy(perm).long(), torch.arange(
                perm.shape[0], face_mesh_id.shape[0])])
            tri = TriangleInfo(*(getattr(tri, f.name)[full]
                                 for f in dataclasses.fields(TriangleInfo)))
            face_normal_mask = face_normal_mask[full]
            face_mesh_id = face_mesh_id[full]
            tri_uv = tri_uv[full]
        mesh_bsdf_slot = torch.tensor([m.bsdf_id for m in mesh_list],
                                      dtype=torch.int32)
        mesh_emitter_slot = torch.tensor([m.emitter_id for m in mesh_list],
                                         dtype=torch.int32)

        # emitter weights (scene.cpp:489-515): an area light's is its area
        # times its luminance, the map's the sum of the others (1 when it
        # is alone); the normalized weight is detached, as in the JAX
        # package
        emitter_datas, emitters_distrb = [], None
        if self.emitters:
            weights = [area_light_weight(cpu_f32(em.radiance),
                                         mesh_datas[em.mesh_index])
                       if isinstance(em, AreaLight) else torch.zeros(())
                       for em in self.emitters]
            total = sum(weights)
            env_w = torch.where(total > 0.0, total, 1.0)
            weights = [env_w if em is env else w
                       for em, w in zip(self.emitters, weights)]
            wsum = sum(weights)
            emitters_distrb = DiscreteDistribution.init(torch.stack(weights))
            emitter_datas = [
                self._emitter_data(em, safe_div(w, wsum).detach(),
                                   mesh_datas, lower, upper)
                for em, w in zip(self.emitters, weights)]
        # the BSDFs' parameters take part in no computation of the compile:
        # they go to the device as they are (a texture is megabytes)
        bsdfs = [tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float32).to(self.device), b) for b in self.bsdfs]

        # secondary edges: every mesh's table in mesh order, sampled by
        # detached length (scene.cpp:546-571); a table above
        # SEARCHSORTED_DENSE_MAX edges takes the alias rows that the last
        # configure() attached, while its size holds (the table is
        # detached, so a stale one stays unbiased)
        sec_edge = sec_edge_distrb = None
        parts = [md.sec_edge for md in mesh_datas if md.sec_edge is not None]
        if parts:
            sec_edge = SecondaryEdgeInfo(*(
                torch.cat([getattr(x, f.name) for x in parts])
                for f in dataclasses.fields(SecondaryEdgeInfo)))
            sec_edge_distrb = DiscreteDistribution.init(
                norm(sec_edge.e1.detach()))
            cache = self._sec_edge_distrb_cache
            if cache is not None and cache.size == sec_edge_distrb.size:
                sec_edge_distrb = cache

        # large primary-edge tables: the floored alias table of the last
        # configure(), while its size holds (JAX scene.py:749-762)
        if active_sensors is None:
            active_sensors = range(len(self.sensors))
        sensors = []
        for i, s in enumerate(self.sensors):
            sdat = s.configure_data(
                opts.width, opts.height, mesh_list, mesh_datas,
                with_edges=opts.sppe > 0 and i in active_sensors)
            cache = self._pe_distrb_caches.get(i)
            ei = sdat.edge_info
            if (cache is not None and ei is not None
                    and cache.size == ei.distrb.size):
                sdat = dataclasses.replace(sdat, edge_info=dataclasses.replace(
                    ei, distrb=cache))
            sensors.append(sdat)

        sd = SceneData(
            tri=tri,
            face_normal_mask=face_normal_mask,
            face_mesh_id=face_mesh_id,
            mesh_bsdf_slot=mesh_bsdf_slot,
            mesh_emitter_slot=mesh_emitter_slot,
            bsdfs=tuple(bsdfs),
            emitters=tuple(emitter_datas),
            emitters_distrb=emitters_distrb,
            sensors=tuple(sensors),
            lower=lower,
            upper=upper,
            sec_edge=sec_edge,
            sec_edge_distrb=sec_edge_distrb,
            tri_uv=tri_uv,
            has_uv=any(m.has_uv for m in mesh_list),
            has_pv=any(isinstance(getattr(b, "bsdf", b),
                                  MicrofacetBSDFPerVertex)
                       for b in self.bsdfs),
            mesh_ids=tuple(getattr(m, "id", "") for m in mesh_list),
        )
        return tree_map(lambda x: x.to(self.device), sd)

    def _sky_box(self, lower, upper):
        """The bounding mesh's box: the geometry's and every camera's (a
        perspective camera's eye, an orthographic camera's film corners),
        widened by 5% of its largest extent and at least 1e-3 of its
        magnitude (JAX scene.py:576-613; the reference's min-extent margin
        collapses for flat scenes)."""
        from ..sensor.orthographic import OrthographicCamera

        aspect = float(self.opts.width) / float(self.opts.height)
        pts = []
        for s in self.sensors:
            tw = (cpu_f32(s.to_world_left) @ cpu_f32(s.to_world_raw)
                  @ cpu_f32(s.to_world_right)).detach()
            if isinstance(s, OrthographicCamera):
                for cx in (-1.2, 1.2):
                    for cy in (-1.2 / aspect, 1.2 / aspect):
                        pts.append(torch.tensor([cx, cy, 0.0]) @ tw[:3, :3].T
                                   + tw[:3, 3])
            else:
                pts.append(tw[:3, 3])
        if pts:
            pts = torch.stack(pts)
            lower = torch.minimum(lower, pts.amin(0))
            upper = torch.maximum(upper, pts.amax(0))
        margin = torch.maximum(
            0.05 * (upper - lower).amax(),
            1e-3 * torch.clamp((upper.abs() + lower.abs()).amax(), min=1.0))
        return lower - margin, upper + margin

    def _emitter_data(self, em, weight, mesh_datas, lower, upper):
        """The configured emitter ``em`` with its normalized ``weight``."""
        if isinstance(em, AreaLight):
            return AreaLightData(radiance=cpu_f32(em.radiance),
                                 sampling_weight=weight,
                                 mesh_data=mesh_datas[em.mesh_index],
                                 mesh_index=em.mesh_index)
        # the importance table of the last configure(), else built now
        # (detached) without alias rows (scene.py:691-713)
        radiance = tree_map(cpu_f32, em.radiance)
        cells = em._cell_distrb_cache
        if cells is None:
            cells = build_envmap_distribution(radiance)
        to_world = cpu_f32(em.to_world_left) @ cpu_f32(em.to_world_raw)
        return EnvironmentMapData(
            radiance=radiance, scale=cpu_f32(em.scale), to_world=to_world,
            from_world=torch.linalg.inv(to_world), cell_distrb=cells,
            lower=lower, upper=upper, sampling_weight=weight,
            mesh_index=em.mesh_index)

    def configure(self, active_sensors=None) -> SceneData:
        """(Re)build and cache the scene data (reference sc.configure()),
        with the Morton permutation of the current geometry, the
        environment map's importance table with its alias rows, and, for
        edge tables above ``SEARCHSORTED_DENSE_MAX`` entries, the
        secondary-edge table's alias rows and each camera's floored
        primary-edge table (``sensor.floored_edge_distrb``); later scene
        compiles reuse them all (JAX scene.py:795-852).
        ``active_sensors``: the sensors that get primary-edge tables, in
        this compile and in the renders' and training steps' until the
        next ``configure()``; None: all. With ``opts.log_level > 0`` it
        prints "Configured in X seconds.", the device synchronised."""
        from ..utils.profiling import log_time

        with log_time("Configured", self.opts.log_level > 0,
                      device=self.device):
            return self._configure(active_sensors)

    def _configure(self, active_sensors) -> SceneData:
        self._active_sensors = (None if active_sensors is None
                                else [int(i) for i in active_sensors])
        self._tri_perm = self._compute_tri_perm()
        env = self.emitter_env
        if env is not None:
            cells = build_envmap_distribution(
                tree_map(cpu_f32, env.radiance)).with_alias()
            env._cell_distrb_cache = tree_map(lambda x: x.to(self.device),
                                              cells)
        self._sec_edge_distrb_cache = None
        self._pe_distrb_caches = {}
        self._data = self.configure_data(self._active_sensors)
        sed = self._data.sec_edge_distrb
        if sed is not None and sed.size > SEARCHSORTED_DENSE_MAX:
            self._sec_edge_distrb_cache = sed = sed.with_alias()
        sensors = []
        for i, sdat in enumerate(self._data.sensors):
            ei = sdat.edge_info
            if ei is not None and ei.distrb.size > SEARCHSORTED_DENSE_MAX:
                self._pe_distrb_caches[i] = floored_edge_distrb(ei)
                sdat = dataclasses.replace(sdat, edge_info=dataclasses.replace(
                    ei, distrb=self._pe_distrb_caches[i]))
            sensors.append(sdat)
        self._data = dataclasses.replace(self._data, sec_edge_distrb=sed,
                                         sensors=tuple(sensors))
        return self._data

    def _world_tri_centroids(self) -> np.ndarray:
        """Per-face world-space centroids under the current transforms, in
        float32 numpy as the JAX package computes them (scene.py:864-877)."""
        def np32(x):
            return torch.as_tensor(x, dtype=torch.float32).detach().cpu()

        cents = []
        for m in self.meshes:
            tw = (np32(m.to_world_left) @ np32(m.to_world_raw)
                  @ np32(m.to_world_right)).numpy()
            v = np32(m.vertex_positions_raw).numpy() @ tw[:3, :3].T + tw[:3, 3]
            f = np.asarray(torch.as_tensor(m.face_indices).cpu(), np.int64)
            cents.append(v[f].mean(axis=1))
        return np.concatenate(cents)

    def _compute_tri_perm(self):
        """Morton permutation of all faces, or None at most
        ``MORTON_MIN_FACES`` faces (scene.py:879-893)."""
        if sum(m.num_faces for m in self.meshes) <= MORTON_MIN_FACES:
            return None
        return morton_order(self._world_tri_centroids())

    def _cluster_quality(self, perm, cents) -> float:
        """The summed surface area of the boxes of ``CLUSTER``-triangle
        runs of ``cents`` (the world centroids) in the order ``perm``: what
        the intersection kernels' cluster culling depends on (JAX
        scene.py:895-918, at the port's cluster size)."""
        c = cents[np.asarray(perm)]
        n_pad = -(-c.shape[0] // intersect.CLUSTER) * intersect.CLUSTER
        if n_pad != c.shape[0]:
            c = np.concatenate([c, np.tile(c[-1:], (n_pad - c.shape[0], 1))])
        c = c.reshape(-1, intersect.CLUSTER, 3)
        ext = c.max(axis=1) - c.min(axis=1)
        return float(2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                            + ext[:, 0] * ext[:, 2]).sum())

    def _staleness_and_fresh_perm(self):
        """``(staleness, fresh permutation)`` in one pass; a permutation
        that no longer addresses the faces (meshes replaced since
        ``configure()``) is infinitely stale (JAX scene.py:929-949)."""
        perm = self._tri_perm
        if perm is None:
            return 1.0, None
        fresh = self._compute_tri_perm()
        if fresh is None:
            return float("inf"), None
        cents = self._world_tri_centroids()
        if np.asarray(perm).max(initial=-1) >= cents.shape[0]:
            return float("inf"), fresh
        q_fresh = self._cluster_quality(fresh, cents)
        if q_fresh <= 0.0:
            return 1.0, fresh
        return self._cluster_quality(perm, cents) / q_fresh, fresh

    def tri_perm_staleness(self) -> float:
        """How far the Morton order of the last ``configure()`` has
        degraded under the current transforms: the cluster quality of the
        cached order over that of a fresh one (1: still the best)."""
        return self._staleness_and_fresh_perm()[0]

    def refresh_tri_perm(self, threshold: float = 1.25) -> bool:
        """Replace the Morton order where :meth:`tri_perm_staleness`
        exceeds ``threshold`` (or drop it where the scene fell below
        ``MORTON_MIN_FACES`` faces); True where it changed. The renders
        and training steps compile the scene at each call, so they take
        the new order at once; the cached ``data`` is rebuilt."""
        if self._tri_perm is None:
            return False
        ratio, fresh = self._staleness_and_fresh_perm()
        if ratio == float("inf") and fresh is None:
            self._tri_perm = None
            self._data = None
            return True
        if ratio <= threshold or fresh is None:
            return False
        self._tri_perm = fresh
        self._data = None
        return True

    @property
    def data(self) -> SceneData:
        if self._data is None:
            self.configure(self._active_sensors)
        return self._data

    def is_ready(self) -> bool:
        return self._data is not None

    def _user_rays(self, ray_o, ray_d) -> Ray:
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        return Ray(f32(ray_o), f32(ray_d))

    def unit_ray_intersect(self, ray_o, ray_d) -> Intersection:
        """Detached intersection of user rays (reference
        unit_ray_intersect, psdr.cpp:404)."""
        return self.data.ray_intersect(self._user_rays(ray_o, ray_d))

    def unit_ray_intersectAD(self, ray_o, ray_d) -> Intersection:
        """The attached intersection of user rays (psdr.cpp:405): the
        scene compiled again from its current parameters and the hit
        rebuilt in the solid-angle form, so ``t``, ``p`` and the frame
        carry the gradients of the geometry and of the rays."""
        sd = self.configure_data(self._active_sensors)
        return sd.ray_intersect(self._user_rays(ray_o, ray_d), mode="solid")


def _make_bound_mesh(lower, upper) -> Mesh:
    """The inward-facing box ``[lower, upper]`` for an environment map
    (scene.cpp:447-470): face normals, no edges, no BSDF. Corner ``i``
    takes ``upper`` on the axes whose bit is set in ``i``."""
    corners = torch.arange(8)
    sel = torch.stack([(corners >> j) & 1 for j in range(3)], -1).to(
        torch.float32)
    verts = lower * (1.0 - sel) + upper * sel
    faces = torch.tensor([[0, 1, 3], [0, 3, 2], [1, 5, 7], [1, 7, 3],
                          [2, 3, 7], [2, 7, 6], [0, 5, 1], [0, 4, 5],
                          [0, 2, 6], [0, 6, 4], [4, 7, 5], [4, 6, 7]],
                         dtype=torch.int32)
    mesh = Mesh()
    mesh.use_face_normals = True
    mesh.enable_edges = False
    mesh.load_raw(verts, faces)
    return mesh


def _checked_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card visible
    raises (the entry points default to the card and never fall back)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA card is visible; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return device
