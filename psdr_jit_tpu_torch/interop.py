"""Carry a scene across from the JAX package as plain arrays.

A renderer's inputs are its scene: meshes, transforms, materials, lights
and cameras. :func:`scene_to_arrays` reads them off a ``psdr_jit_tpu``
``Scene`` with ``np.asarray`` (it never imports JAX; the JAX scene's
arrays convert themselves), and :func:`scene_from_arrays` rebuilds the
same scene in this package through the normal ``add_*`` calls. The dict
saves to and loads from ``.npz`` as it is, so a machine without JAX can
render a scene that was built with it. :func:`params_to_torch` does the
same for a training step's parameters, so both packages can take the same
step.

Scope: constant ``DiffuseBSDF``s, ``AreaLight``s, field-of-view
``PerspectiveCamera``s and ``OrthographicCamera``s; anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

_TRANSFORMS = ("to_world_left", "to_world_raw", "to_world_right")
_CAMERAS = ("PerspectiveCamera", "OrthographicCamera")


def _f32(x):
    return np.asarray(x, np.float32)


def _tensor(x):
    return torch.tensor(np.asarray(x, np.float32))


def scene_to_arrays(scene) -> dict:
    """``psdr_jit_tpu.Scene`` -> ``{name: np.ndarray}``."""
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
        data = np.asarray(getattr(getattr(b, "reflectance", None), "data",
                                  np.zeros(0)))
        if type(b).__name__ != "DiffuseBSDF" or data.size != 3:
            raise NotImplementedError(
                f"BSDF {j} ({type(b).__name__}): only constant DiffuseBSDFs "
                "carry over")
        out[f"bsdf.{j}.reflectance"] = _f32(data).reshape(3)
        out[f"bsdf.{j}.twoSide"] = np.asarray(bool(b.twoSide))
    for k, em in enumerate(scene.emitters):
        if type(em).__name__ != "AreaLight":
            raise NotImplementedError(
                f"emitter {k} ({type(em).__name__}): only AreaLights carry "
                "over")
        out[f"emitter.{k}.radiance"] = _f32(em.radiance).reshape(3)
        out[f"emitter.{k}.mesh_index"] = np.asarray(int(em.mesh_index),
                                                    np.int64)
    for i, m in enumerate(scene.meshes):
        if getattr(m, "vertex_uv", None) is not None:
            raise NotImplementedError(f"mesh {i}: texture coordinates do "
                                      "not carry over")
        out[f"mesh.{i}.vertex_positions_raw"] = _f32(m.vertex_positions_raw)
        out[f"mesh.{i}.face_indices"] = np.asarray(m.face_indices, np.int32)
        for name in _TRANSFORMS:
            out[f"mesh.{i}.{name}"] = _f32(getattr(m, name))
        out[f"mesh.{i}.use_face_normals"] = np.asarray(bool(m.use_face_normals))
        out[f"mesh.{i}.enable_edges"] = np.asarray(bool(m.enable_edges))
        out[f"mesh.{i}.bsdf_id"] = np.asarray(int(m.bsdf_id), np.int64)
        out[f"mesh.{i}.emitter_id"] = np.asarray(int(m.emitter_id), np.int64)
    for s, cam in enumerate(scene.sensors):
        kind = type(cam).__name__
        if (kind not in _CAMERAS
                or getattr(cam, "use_intrinsic", False)):
            raise NotImplementedError(
                f"sensor {s} ({kind}): only field-of-view "
                "PerspectiveCameras and OrthographicCameras carry over")
        if kind != "PerspectiveCamera":  # no key: a perspective camera
            out[f"sensor.{s}.kind"] = np.asarray(kind)
        out[f"sensor.{s}.fov_near_far"] = np.asarray(
            [getattr(cam, "fov", 0.0), cam.near_clip, cam.far_clip],
            np.float64)
        for name in _TRANSFORMS:
            out[f"sensor.{s}.{name}"] = _f32(getattr(cam, name))
    return out


def scene_from_arrays(arrays, device="cuda"):
    """``{name: array}`` (or a loaded ``.npz``) -> this package's Scene on
    ``device`` (the card unless the caller asks for the CPU)."""
    from . import (AreaLight, DiffuseBSDF, Mesh, OrthographicCamera,
                   PerspectiveCamera, RenderOption, Scene)

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
        cam = (OrthographicCamera(near, far) if kind == "OrthographicCamera"
               else PerspectiveCamera(fov, near, far))
        for name in _TRANSFORMS:
            setattr(cam, name, _tensor(a[f"sensor.{s}.{name}"]))
        sc.add_Sensor(cam)
    for j in range(n_bsdfs):
        sc.add_BSDF(DiffuseBSDF(_tensor(a[f"bsdf.{j}.reflectance"])),
                    str(a["bsdf_ids"][j]),
                    twoSide=bool(a[f"bsdf.{j}.twoSide"]))
    for i in range(n_meshes):
        mesh = Mesh()
        mesh.enable_edges = bool(a[f"mesh.{i}.enable_edges"])
        mesh.load_raw(_tensor(a[f"mesh.{i}.vertex_positions_raw"]),
                      torch.tensor(a[f"mesh.{i}.face_indices"]))
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
