"""Carry a scene across from the JAX package as plain arrays.

A renderer's inputs are its scene: meshes, transforms, materials, lights
and cameras. :func:`scene_to_arrays` reads them off a ``psdr_jit_tpu``
``Scene`` with ``np.asarray`` (it never imports JAX; the JAX scene's
arrays convert themselves), and :func:`scene_from_arrays` rebuilds the
same scene in this package through the normal ``add_*`` calls. The dict
saves to and loads from ``.npz`` as it is, so a machine without JAX can
render a scene that was built with it. :func:`params_to_torch` does the
same for a training step's parameters (a radiance texture among them), so
both packages can take the same step.

Scope: meshes with or without texture coordinates, ``DiffuseBSDF``s
(a constant reflectance as ``bsdf.{j}.reflectance``, a texture as a
bitmap with its UV transform), ``MicrofacetBSDF``s and
``RoughConductorBSDF``s (their bitmaps), ``RoughDielectricBSDF``s (two
bitmaps and ``eta_value``), ``MicrofacetBSDFPerVertex`` (its three
per-vertex tables as plain arrays), ``NormalMapBSDF``s (the map, and the
nested BSDF under ``bsdf.{j}.nested``), ``AreaLight``s, an
``EnvironmentMap``, ``PerspectiveCamera``s (field of view or
intrinsics) and
``OrthographicCamera``s; anything else raises. A key ``bsdf.{j}.type``
or ``emitter.{k}.type`` is written only for a type other than
``DiffuseBSDF`` or ``AreaLight``, a mesh's ``vertex_uv`` and
``face_uv_indices`` only where it has them, and a camera's
``sensor.{s}.intrinsic`` (fx, fy, cx, cy) only for the intrinsic form.
"""

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


def _put_bitmap(out, key, bm):
    out[f"{key}.data"] = _f32(bm.data)
    out[f"{key}.uv"] = np.asarray([bm.scale, bm.rot, *np.asarray(bm.trans)],
                                  np.float32)


def _get_bitmap(a, key):
    from .core.bitmap import Bitmap

    scale, rot, tx, ty = (float(v) for v in a[f"{key}.uv"])
    return Bitmap(_tensor(a[f"{key}.data"]), scale, rot, (tx, ty))


def _put_bsdf(out, key, b):
    """Write BSDF ``b`` under ``key``."""
    kind = type(b).__name__
    out[f"{key}.twoSide"] = np.asarray(bool(b.twoSide))
    if kind == "DiffuseBSDF":
        refl = b.reflectance
        if np.asarray(refl.data).size == 3:
            out[f"{key}.reflectance"] = _f32(refl.data).reshape(3)
        else:
            _put_bitmap(out, f"{key}.reflectance", refl)
        return
    if kind == "MicrofacetBSDFPerVertex":
        out[f"{key}.type"] = np.asarray(kind)
        for name in _MICROFACET:
            out[f"{key}.{name}"] = _f32(getattr(b, name))
        return
    if kind not in _BITMAPS:
        raise NotImplementedError(f"{key} ({kind}): not a BSDF of the port")
    out[f"{key}.type"] = np.asarray(kind)
    for name in _BITMAPS[kind]:
        _put_bitmap(out, f"{key}.{name}", getattr(b, name))
    if kind == "RoughDielectricBSDF":
        out[f"{key}.eta_value"] = _f32(b.eta_value).reshape(())
    elif kind == "NormalMapBSDF":
        _put_bsdf(out, f"{key}.nested", b.bsdf)


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


def scene_to_arrays(scene, cell_table: bool = False) -> dict:
    """``psdr_jit_tpu.Scene`` -> ``{name: np.ndarray}``. ``cell_table``:
    also carry the masses of an environment map's importance table as the
    JAX scene's last ``configure()`` built it (``emitter.{k}.cell_pmf``),
    so that the port can sample from that very table."""
    o = scene.opts
    out = {
        "opts": np.asarray([o.width, o.height, o.spp, o.sppe, o.sppse],
                           np.int64),
        "seed": np.asarray(int(scene.seed), np.int64),
        "counts": np.asarray([len(scene.meshes), len(scene.bsdfs),
                              len(scene.emitters), len(scene.sensors)],
                             np.int64),
        "bsdf_ids": np.asarray([str(b) for b in scene.bsdf_ids] or [""]),
    }
    for j, b in enumerate(scene.bsdfs):
        _put_bsdf(out, f"bsdf.{j}", b)
    for k, em in enumerate(scene.emitters):
        kind = type(em).__name__
        if kind == "EnvironmentMap":
            out[f"emitter.{k}.type"] = np.asarray(kind)
            _put_bitmap(out, f"emitter.{k}.radiance", em.radiance)
            out[f"emitter.{k}.scale"] = _f32(em.scale).reshape(())
            for name in ("to_world_raw", "to_world_left"):
                out[f"emitter.{k}.{name}"] = _f32(getattr(em, name))
            cells = getattr(em, "_cell_distrb_cache", None)
            if cell_table and cells is not None:
                out[f"emitter.{k}.cell_pmf"] = _f32(cells.distrb.pmf)
                out[f"emitter.{k}.cell_res"] = np.asarray(cells.res,
                                                          np.int64)
            continue
        if kind != "AreaLight":
            raise NotImplementedError(
                f"emitter {k} ({kind}): only AreaLights and an "
                "EnvironmentMap carry over")
        out[f"emitter.{k}.radiance"] = _f32(em.radiance).reshape(3)
        out[f"emitter.{k}.mesh_index"] = np.asarray(int(em.mesh_index),
                                                    np.int64)
    for i, m in enumerate(scene.meshes):
        out[f"mesh.{i}.vertex_positions_raw"] = _f32(m.vertex_positions_raw)
        out[f"mesh.{i}.face_indices"] = np.asarray(m.face_indices, np.int32)
        if m.vertex_uv is not None:
            out[f"mesh.{i}.vertex_uv"] = _f32(m.vertex_uv)
            out[f"mesh.{i}.face_uv_indices"] = np.asarray(m.face_uv_indices,
                                                          np.int32)
        for name in _TRANSFORMS:
            out[f"mesh.{i}.{name}"] = _f32(getattr(m, name))
        out[f"mesh.{i}.use_face_normals"] = np.asarray(bool(m.use_face_normals))
        out[f"mesh.{i}.enable_edges"] = np.asarray(bool(m.enable_edges))
        out[f"mesh.{i}.bsdf_id"] = np.asarray(int(m.bsdf_id), np.int64)
        out[f"mesh.{i}.emitter_id"] = np.asarray(int(m.emitter_id), np.int64)
    for s, cam in enumerate(scene.sensors):
        kind = type(cam).__name__
        if kind not in _CAMERAS:
            raise NotImplementedError(
                f"sensor {s} ({kind}): only PerspectiveCameras and "
                "OrthographicCameras carry over")
        if kind != "PerspectiveCamera":  # no key: a perspective camera
            out[f"sensor.{s}.kind"] = np.asarray(kind)
        out[f"sensor.{s}.fov_near_far"] = np.asarray(
            [getattr(cam, "fov", 0.0), cam.near_clip, cam.far_clip],
            np.float64)
        if getattr(cam, "use_intrinsic", False):
            out[f"sensor.{s}.intrinsic"] = np.asarray(
                [cam.fx, cam.fy, cam.cx, cam.cy], np.float64)
        for name in _TRANSFORMS:
            out[f"sensor.{s}.{name}"] = _f32(getattr(cam, name))
    return out


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


def params_to_torch(np_params, device="cuda") -> dict:
    """A training step's parameters, ``{name: array}`` (numpy, or anything
    ``np.asarray`` takes, such as the JAX package's arrays), as float32
    tensors on ``device`` (the card unless the caller asks for the CPU)."""
    from .scene.scene import _checked_device

    device = _checked_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in np_params.items()}
