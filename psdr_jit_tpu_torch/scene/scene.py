"""Scene container and scene compile (counterpart of
``psdr_jit_tpu/scene/scene.py``).

:class:`Scene` is the user-facing container (``add_Sensor``, ``add_BSDF``,
``add_Mesh``, ``configure``). :meth:`Scene.configure_data` packs the
world-space triangle SoA, the per-mesh BSDF and emitter slots, the emitter
weights, the cameras and (when ``sppe > 0``) the primary-edge tables into
a :class:`SceneData` on ``Scene.device``.

The compile runs in float32 on the CPU and then moves to the device, so a
scene's tables are the same bits whichever device renders it. It is
differentiable: the parameters a training step sets on the scene objects
(vertex positions, transforms, reflectances, radiances; on any device)
are copied to the CPU inside the autograd graph, and the final ``.to``
copy to the device is in the graph too, so gradients on the device's
tables flow back to them.

Above 256 faces the global triangle stream is permuted into the Morton
order of the faces' world centroids (:func:`morton_order`), the JAX
package's permutation bit for bit, so that triangle ids compare one to one
and the intersection kernels' clusters and tree leaves are spatially
tight.

:class:`SceneData` also holds the shading interface of the general path
tracer (``integrator/path.py``): the path-formulation intersection, the
per-lane BSDF and emitter dispatch and the emitter sampling.

Not ported yet: secondary edges (``sppse`` builds nothing) and environment
maps.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.types import RenderOption, Ray, Frame, Intersection
from ..core.math import bilinear, norm, normalize, safe_div
from ..core.distribution import DiscreteDistribution
from ..core.records import PositionSample
from ..shape.mesh import Mesh, TriangleInfo, cpu_f32
from ..bsdf.bsdf import (BSDF, eval_dispatch, material_table, pdf_dispatch,
                         sample_dispatch)
from ..emitter.area import AreaLight, AreaLightData, area_light_weight
from ..ops import intersect

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
    """Apply ``fn`` to every tensor of a SceneData (dataclasses, tuples and
    configured BSDFs), rebuilding the containers."""
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
        y.reflectance = fn(x.reflectance)
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
    emitters: tuple                  # AreaLightData
    emitters_distrb: Optional[DiscreteDistribution]
    sensors: tuple                   # SensorData
    lower: torch.Tensor              # (3,) scene AABB
    upper: torch.Tensor              # (3,)

    def ray_intersect(self, ray: Ray, active=None) -> Intersection:
        """Closest hit, reconstructed in the path formulation (detached
        barycentrics; scene.cpp:736-806): the hit point is
        ``p0 + e1*u + e2*v`` and ``t`` its distance from the ray origin.
        Without texture coordinates the shading frame is
        ``Frame.from_normal`` of the shading normal."""
        tri = self.tri
        tree = (self.bvh if intersect.needs_tree(tri.p0.shape[0],
                                                 tri.p0.device) else None)
        tri_id, valid, uv, _ = intersect.ray_intersect_detached(
            tri.p0, tri.e1, tri.e2, ray, active, tree)
        idx = torch.clamp(tri_id, min=0).long()
        p = bilinear(tri.p0[idx], tri.e1[idx], tri.e2[idx], uv)
        dirv = p - ray.o
        t = norm(dirv)
        dirv = dirv * safe_div(torch.ones_like(t), t)[..., None]
        n0 = tri.n0[idx]
        sh_n = normalize(bilinear(n0, tri.n1[idx] - n0, tri.n2[idx] - n0, uv))
        face_normal = tri.face_normal[idx]
        sh_n = torch.where(self.face_normal_mask[idx][..., None],
                           face_normal, sh_n)
        frame = Frame.from_normal(sh_n)
        return Intersection(
            valid=valid, t=t, p=p, n=face_normal, sh_frame=frame,
            wi=frame.to_local(-dirv), J=torch.ones_like(t), bc=uv,
            tri_id=tri_id, mesh_id=self.face_mesh_id[idx])

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
        """The BSDFs' ``(reflectance (n, 3), two_side (n,))`` on the
        scene's device, built at first use (``bsdf.material_table``)."""
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
    def sample_emitter_position(self, ref_p, sample2,
                                active) -> PositionSample:
        """A point on a light: one light directly, several through the
        emitter distribution with the second uniform reused."""
        if not self.emitters:
            raise ValueError("the scene has no emitter")
        if len(self.emitters) == 1:
            return self.emitters[0].sample_position(ref_p, sample2, active)
        e_idx, e_pdf, u = self.emitters_distrb.sample_reuse(sample2[..., 1])
        sample2 = torch.stack([sample2[..., 0], u], dim=-1)
        out = None
        for i, em in enumerate(self.emitters):
            m = active & (e_idx == i)
            ps = em.sample_position(ref_p, sample2, m)
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


class Scene:
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
        self.param_map: dict = {}
        self.seed = 0
        self._data: Optional[SceneData] = None
        self._tri_perm = None

    @classmethod
    def from_arrays(cls, arrays, device="cuda") -> "Scene":
        """Build a scene from :func:`psdr_jit_tpu_torch.interop.scene_to_arrays`
        output (or the ``.npz`` it was saved to)."""
        from ..interop import scene_from_arrays

        return scene_from_arrays(arrays, device)

    # -- builders (psdr.cpp:406-418) ---------------------------------------
    @property
    def num_meshes(self) -> int:
        return len(self.meshes)

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

    def add_Mesh(self, mesh: Mesh, transform=None, bsdf_id: str = "",
                 emitter: Optional[AreaLight] = None):
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
    def configure_data(self) -> SceneData:
        if not self.meshes:
            raise ValueError("Missing meshes!")
        if not self.sensors:
            raise ValueError("Missing sensor!")
        opts = self.opts
        mesh_datas = [m.configure_data() for m in self.meshes]
        lower = torch.stack([md.vertex_positions.detach().amin(0)
                             for md in mesh_datas]).amin(0)
        upper = torch.stack([md.vertex_positions.detach().amax(0)
                             for md in mesh_datas]).amax(0)
        tri = TriangleInfo(*(
            torch.cat([getattr(md.tri, f.name) for md in mesh_datas])
            for f in dataclasses.fields(TriangleInfo)))
        face_normal_mask = torch.cat([
            torch.full((m.num_faces,), bool(m.use_face_normals))
            for m in self.meshes])
        face_mesh_id = torch.cat([
            torch.full((m.num_faces,), i, dtype=torch.int32)
            for i, m in enumerate(self.meshes)])
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
        mesh_bsdf_slot = torch.tensor([m.bsdf_id for m in self.meshes],
                                      dtype=torch.int32)
        mesh_emitter_slot = torch.tensor([m.emitter_id for m in self.meshes],
                                         dtype=torch.int32)

        # emitter weights (scene.cpp:489-515); the normalized weight is
        # detached, as in the JAX package
        emitter_datas, emitters_distrb = [], None
        if self.emitters:
            radiances = [cpu_f32(em.radiance) for em in self.emitters]
            weights = [area_light_weight(r, mesh_datas[em.mesh_index])
                       for em, r in zip(self.emitters, radiances)]
            wsum = sum(weights)
            emitters_distrb = DiscreteDistribution.init(torch.stack(weights))
            emitter_datas = [
                AreaLightData(radiance=r,
                              sampling_weight=safe_div(w, wsum).detach(),
                              mesh_data=mesh_datas[em.mesh_index],
                              mesh_index=em.mesh_index)
                for em, r, w in zip(self.emitters, radiances, weights)]
        bsdfs = []
        for b in self.bsdfs:
            b = copy.copy(b)
            b.reflectance = cpu_f32(b.reflectance)
            bsdfs.append(b)

        sd = SceneData(
            tri=tri,
            face_normal_mask=face_normal_mask,
            face_mesh_id=face_mesh_id,
            mesh_bsdf_slot=mesh_bsdf_slot,
            mesh_emitter_slot=mesh_emitter_slot,
            bsdfs=tuple(bsdfs),
            emitters=tuple(emitter_datas),
            emitters_distrb=emitters_distrb,
            sensors=tuple(s.configure_data(opts.width, opts.height,
                                           self.meshes, mesh_datas,
                                           with_edges=opts.sppe > 0)
                          for s in self.sensors),
            lower=lower,
            upper=upper,
        )
        return tree_map(lambda x: x.to(self.device), sd)

    def configure(self) -> SceneData:
        """(Re)build and cache the scene data (reference sc.configure()),
        with the Morton permutation of the current geometry."""
        self._tri_perm = self._compute_tri_perm()
        self._data = self.configure_data()
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

    @property
    def data(self) -> SceneData:
        if self._data is None:
            self.configure()
        return self._data

    def unit_ray_intersect(self, ray_o, ray_d) -> Intersection:
        """Detached intersection of user rays (reference
        unit_ray_intersect, psdr.cpp:404)."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        return self.data.ray_intersect(Ray(f32(ray_o), f32(ray_d)))


def _checked_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card visible
    raises (the entry points default to the card and never fall back)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA card is visible; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return device
