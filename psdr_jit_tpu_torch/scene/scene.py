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

Not ported yet: secondary edges (``sppse`` builds nothing), environment
maps, and the Morton triangle order that the JAX package applies above 256
faces.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from ..core.types import RenderOption, Ray, Frame, Intersection
from ..core.math import bilinear, norm, normalize, safe_div
from ..core.distribution import DiscreteDistribution
from ..shape.mesh import Mesh, TriangleInfo, cpu_f32
from ..bsdf.bsdf import BSDF
from ..emitter.area import AreaLight, AreaLightData, area_light_weight
from ..ops.intersect import ray_intersect_detached

# The JAX package Morton-orders the triangles of larger scenes
# (scene.py _compute_tri_perm); the port does not yet.
MAX_UNORDERED_FACES = 256


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
        ``p0 + e1*u + e2*v`` and ``t`` its distance from the ray origin."""
        tri = self.tri
        tri_id, valid, uv, _ = ray_intersect_detached(
            tri.p0, tri.e1, tri.e2, ray, active)
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


class Scene:
    """Mutable scene container mirroring the reference Python API, with
    the device its data lives on."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.opts = RenderOption()
        self.meshes: list = []
        self.bsdfs: list = []
        self.bsdf_ids: list = []
        self.emitters: list = []
        self.sensors: list = []
        self.param_map: dict = {}
        self.seed = 0
        self._data: Optional[SceneData] = None

    @classmethod
    def from_arrays(cls, arrays, device="cpu") -> "Scene":
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
        n_faces = sum(m.num_faces for m in self.meshes)
        if n_faces > MAX_UNORDERED_FACES:
            raise NotImplementedError(
                f"{n_faces} faces: the Morton triangle order the JAX package "
                f"applies above {MAX_UNORDERED_FACES} faces is not ported yet "
                "(it comes with the large-scene kernels, ROADMAP.md)")
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
        """(Re)build and cache the scene data (reference sc.configure())."""
        self._data = self.configure_data()
        return self._data

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
