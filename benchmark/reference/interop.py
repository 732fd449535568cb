"""Rebuild a scene from plain arrays (the ``.npz`` layout of
``psdr_jit_tpu_torch.interop.scene_to_arrays``) through the normal
``add_*`` calls: meshes, constant and textured BSDFs of the six types,
area lights, an environment map and cameras; anything else raises."""

from __future__ import annotations

import numpy as np
import torch

_TRANSFORMS = ("to_world_left", "to_world_raw", "to_world_right")
_MICROFACET = ("specularReflectance", "diffuseReflectance", "roughness")
# each BSDF type's bitmap parameters, in its constructor's order; the
# per-vertex Microfacet's three tables are plain arrays of the same names
_BITMAPS = {
    "MicrofacetBSDF": _MICROFACET,
    "RoughConductorBSDF": ("alpha_u", "alpha_v", "eta", "k",
                           "specular_reflectance"),
    "RoughDielectricBSDF": ("alpha_u", "alpha_v"),
    "NormalMapBSDF": ("nmap",),
}
_CAMERAS = ("PerspectiveCamera", "OrthographicCamera")


def _f32(x):
    return np.asarray(x, np.float32)


def _tensor(x):
    return torch.tensor(np.asarray(x, np.float32))


def _get_bitmap(a, key):
    from .core.bitmap import Bitmap

    scale, rot, tx, ty = (float(v) for v in a[f"{key}.uv"])
    return Bitmap(_tensor(a[f"{key}.data"]), scale, rot, (tx, ty))


def _get_bsdf(a, key):
    """The BSDF written under ``key`` (its ``twoSide`` set)."""
    from . import (DiffuseBSDF, MicrofacetBSDF, MicrofacetBSDFPerVertex,
                   NormalMapBSDF, RoughConductorBSDF, RoughDielectricBSDF)

    kind = str(a.get(f"{key}.type", "DiffuseBSDF"))
    two = bool(a[f"{key}.twoSide"])
    if kind == "DiffuseBSDF":
        refl = (_get_bitmap(a, f"{key}.reflectance")
                if f"{key}.reflectance.data" in a
                else _tensor(a[f"{key}.reflectance"]))
        return DiffuseBSDF(refl, twoSide=two)
    if kind == "MicrofacetBSDFPerVertex":
        return MicrofacetBSDFPerVertex(
            *(_tensor(a[f"{key}.{name}"]) for name in _MICROFACET),
            twoSide=two)
    if kind not in _BITMAPS:
        raise NotImplementedError(f"{key}: {kind}")
    maps = [_get_bitmap(a, f"{key}.{name}") for name in _BITMAPS[kind]]
    if kind == "RoughDielectricBSDF":
        return RoughDielectricBSDF(*maps, int_ior=float(
            a[f"{key}.eta_value"]), twoSide=two)
    if kind == "NormalMapBSDF":
        return NormalMapBSDF(*maps, _get_bsdf(a, f"{key}.nested"),
                             twoSide=two)
    cls = {"MicrofacetBSDF": MicrofacetBSDF,
           "RoughConductorBSDF": RoughConductorBSDF}[kind]
    return cls(*maps, twoSide=two)


def scene_from_arrays(arrays, device="cuda"):
    """``{name: array}`` (or a loaded ``.npz``) -> this package's Scene on
    ``device`` (the card unless the caller asks for the CPU)."""
    from . import (AreaLight, EnvironmentMap, Mesh, OrthographicCamera,
                   PerspectiveCamera, RenderOption, Scene)
    from .core.distribution import HyperCubeDistribution
    from .scene.scene import tree_map

    a = {k: np.asarray(arrays[k]) for k in arrays.keys()}
    sc = Scene(device=device)
    sc.opts = RenderOption(*(int(v) for v in a["opts"]))
    sc.seed = int(a["seed"])
    n_meshes, n_bsdfs, n_emitters, n_sensors = (int(v) for v in a["counts"])
    for s in range(n_sensors):
        fov, near, far = (float(v) for v in a[f"sensor.{s}.fov_near_far"])
        kind = str(a.get(f"sensor.{s}.kind", "PerspectiveCamera"))
        if kind not in _CAMERAS:
            raise NotImplementedError(f"sensor {s}: {kind}")
        if kind == "OrthographicCamera":
            cam = OrthographicCamera(near, far)
        elif f"sensor.{s}.intrinsic" in a:
            cam = PerspectiveCamera.from_intrinsic(
                *(float(v) for v in a[f"sensor.{s}.intrinsic"]), near, far)
        else:
            cam = PerspectiveCamera(fov, near, far)
        for name in _TRANSFORMS:
            setattr(cam, name, _tensor(a[f"sensor.{s}.{name}"]))
        sc.add_Sensor(cam)
    for j in range(n_bsdfs):
        sc.add_BSDF(_get_bsdf(a, f"bsdf.{j}"), str(a["bsdf_ids"][j]),
                    twoSide=bool(a[f"bsdf.{j}.twoSide"]))

    def add_envmaps():
        """The environment map whose turn in the emitter order has come."""
        k = len(sc.emitters)
        if k < n_emitters and str(a.get(f"emitter.{k}.type", "")) == \
                "EnvironmentMap":
            env = EnvironmentMap(_get_bitmap(a, f"emitter.{k}.radiance"),
                                 float(a[f"emitter.{k}.scale"]))
            env.to_world_left = _tensor(a[f"emitter.{k}.to_world_left"])
            sc.add_EnvironmentMap(env, _tensor(a[f"emitter.{k}.to_world_raw"]))
            if f"emitter.{k}.cell_pmf" in a:
                env._cell_distrb_cache = tree_map(
                    lambda x: x.to(sc.device), HyperCubeDistribution.init(
                        a[f"emitter.{k}.cell_res"],
                        _tensor(a[f"emitter.{k}.cell_pmf"])).with_alias())

    for i in range(n_meshes):
        add_envmaps()
        mesh = Mesh()
        mesh.enable_edges = bool(a[f"mesh.{i}.enable_edges"])
        uv = (_tensor(a[f"mesh.{i}.vertex_uv"]),
              torch.tensor(a[f"mesh.{i}.face_uv_indices"])) if (
            f"mesh.{i}.vertex_uv" in a) else (None, None)
        mesh.load_raw(_tensor(a[f"mesh.{i}.vertex_positions_raw"]),
                      torch.tensor(a[f"mesh.{i}.face_indices"]), *uv)
        for name in _TRANSFORMS:
            setattr(mesh, name, _tensor(a[f"mesh.{i}.{name}"]))
        mesh.use_face_normals = bool(a[f"mesh.{i}.use_face_normals"])
        mesh.bsdf_id = int(a[f"mesh.{i}.bsdf_id"])
        emitter_id = int(a[f"mesh.{i}.emitter_id"])
        emitter = None
        if emitter_id >= 0:
            if emitter_id != len(sc.emitters):
                raise ValueError("emitters must follow mesh order")
            emitter = AreaLight(_tensor(a[f"emitter.{emitter_id}.radiance"]))
        sc.add_Mesh(mesh, None, "", emitter)
    add_envmaps()
    if len(sc.emitters) != n_emitters:
        raise ValueError(f"{n_emitters} emitters listed, "
                         f"{len(sc.emitters)} attached to meshes")
    return sc


