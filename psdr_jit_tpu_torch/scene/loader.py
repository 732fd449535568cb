"""Mitsuba-0.5-style XML scene loader (counterpart of
``psdr_jit_tpu/scene/loader.py``; reference src/scene/scene_loader.cpp).

The reference's node set: one ``<sensor type="perspective">`` (its film
and sampler set the render options), ``<emitter type="envmap">``,
``<bsdf>`` of the types diffuse, roughconductor, roughdielectric,
microfacet and normalmap, and ``<shape type="obj">`` with a ``<ref>`` to
its BSDF, an optional area ``<emitter>`` and a ``face_normals`` flag.
Transforms: translate, rotate, scale, lookat and matrix
(scene_loader.cpp:81-128), composed in float32 in document order. Every
file a scene names (OBJ, texture, environment map) resolves against the
scene file's directory. The scene is built on the caller's device: the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from ..bsdf.diffuse import DiffuseBSDF
from ..bsdf.microfacet import MicrofacetBSDF
from ..bsdf.normalmap import NormalMapBSDF
from ..bsdf.roughconductor import RoughConductorBSDF
from ..bsdf.roughdielectric import RoughDielectricBSDF
from ..core import transform as xf
from ..core.bitmap import Bitmap
from ..emitter.area import AreaLight
from ..emitter.envmap import EnvironmentMap
from ..sensor.perspective import PerspectiveCamera
from ..shape.mesh import Mesh
from ..utils.image import read_image
from .scene import Scene


def _parse_vector(text: str) -> np.ndarray:
    parts = [float(x) for x in text.replace(",", " ").split()]
    if len(parts) == 1:
        parts = parts * 3
    return np.asarray(parts, np.float32)


def _parse_named(node, name, default=None):
    """The value of ``node``'s child named ``name``, by its tag."""
    for child in node:
        if child.get("name") != name:
            continue
        tag = child.tag
        if tag in ("float", "integer"):
            v = float(child.get("value"))
            return int(v) if tag == "integer" else v
        if tag in ("rgb", "spectrum", "vector", "point"):
            return _parse_vector(child.get("value"))
        if tag == "string":
            return child.get("value")
        if tag == "boolean":
            return child.get("value").lower() == "true"
    return default


def _axes(node, default: float) -> np.ndarray:
    return np.asarray([float(node.get(a, default)) for a in "xyz"],
                      np.float32)


def _parse_transform(node) -> torch.Tensor:
    """A ``<transform>``'s children, each applied after the ones before."""
    m = torch.eye(4, dtype=torch.float32)
    for child in node:
        tag = child.tag
        if tag == "translate":
            m = xf.translate(_axes(child, 0.0)) @ m
        elif tag == "scale":
            v = child.get("value")
            m = xf.scale(_parse_vector(v) if v is not None
                         else _axes(child, 1.0)) @ m
        elif tag == "rotate":
            m = xf.rotate(_axes(child, 0.0),
                          float(child.get("angle", 0.0))) @ m
        elif tag == "lookat":
            m = xf.look_at(_parse_vector(child.get("origin")),
                           _parse_vector(child.get("target")),
                           _parse_vector(child.get("up", "0, 1, 0"))) @ m
        elif tag == "matrix":
            vals = [float(x) for x in child.get("value").split()]
            m = torch.tensor(vals, dtype=torch.float32).reshape(4, 4) @ m
    return m


def _texture_or_value(node, name, channels, default, base_dir) -> Bitmap:
    """A ``<texture>`` file (``<string name="filename">``), an ``<rgb>`` or
    ``<spectrum>``, or a ``<float>`` named ``name``; else ``default``."""
    for child in node:
        if child.get("name") != name:
            continue
        if child.tag == "texture":
            arr = read_image(os.path.join(base_dir,
                                          _parse_named(child, "filename")))
            if channels == 1 and arr.ndim == 3:
                arr = arr[..., :1]
            return Bitmap.from_array(np.ascontiguousarray(arr))
        if child.tag in ("rgb", "spectrum"):
            return Bitmap.from_value(_parse_vector(child.get("value")),
                                     channels)
        if child.tag == "float":
            return Bitmap.from_value(
                np.full(channels, float(child.get("value")), np.float32),
                channels)
    return Bitmap.from_value(np.asarray(default, np.float32), channels)


def _parse_bsdf(node, base_dir):
    t = node.get("type")

    def tex(name, channels, default):
        return _texture_or_value(node, name, channels, default, base_dir)

    if t == "diffuse":
        return DiffuseBSDF(tex("reflectance", 3, (0.5, 0.5, 0.5)))
    if t == "microfacet":
        return MicrofacetBSDF(tex("specularReflectance", 3, (0.04,) * 3),
                              tex("diffuseReflectance", 3, (0.5,) * 3),
                              tex("roughness", 1, (0.5,)))
    if t == "roughconductor":
        # alpha, eta and k take textures (scene_loader.cpp:336-357)
        return RoughConductorBSDF(
            tex("alpha", 1, (0.1,)), tex("alpha", 1, (0.1,)),
            tex("eta", 3, (0.2004, 0.9228, 1.102)),
            tex("k", 3, (3.913, 2.448, 2.1765)))
    if t == "roughdielectric":
        alpha = tex("alpha", 1, (0.1,))
        return RoughDielectricBSDF(
            alpha, alpha, int_ior=_parse_named(node, "intIOR", 1.5),
            ext_ior=_parse_named(node, "extIOR", 1.0))
    if t == "normalmap":
        nested = None
        for child in node:
            if child.tag == "bsdf":
                nested = _parse_bsdf(child, base_dir)
        return NormalMapBSDF(tex("normalmap", 3, (0.5, 0.5, 1.0)),
                             nested or DiffuseBSDF())
    raise ValueError(f"Unknown BSDF type: {t}")


def _add_sensor(sc: Scene, node):
    if node.get("type") != "perspective":
        raise ValueError(f"sensor type {node.get('type')!r}: only "
                         "perspective sensors")
    cam = PerspectiveCamera(_parse_named(node, "fov", 60.0),
                            _parse_named(node, "nearClip", 1e-6),
                            _parse_named(node, "farClip", 1e7))
    transform = None
    for child in node:
        # the first <transform> child, whatever its name
        # (scene_loader.cpp:269)
        if child.tag == "transform" and transform is None:
            transform = child
        elif child.tag == "film":
            sc.opts.width = int(_parse_named(child, "width", 128))
            sc.opts.height = int(_parse_named(child, "height", 128))
        elif child.tag == "sampler":
            sc.opts.spp = int(_parse_named(child, "sampleCount", 1))
    if transform is not None:
        cam.to_world_raw = _parse_transform(transform)
    sc.add_Sensor(cam)


def _add_envmap(sc: Scene, node, base_dir):
    fname = _parse_named(node, "filename")
    env = EnvironmentMap(os.path.join(base_dir, fname) if fname else None,
                         scale=_parse_named(node, "scale", 1.0))
    for child in node:
        if child.tag == "transform":
            env.to_world_raw = _parse_transform(child)
    sc.add_EnvironmentMap(env)


def _add_shape(sc: Scene, node, base_dir):
    if node.get("type") != "obj":
        raise ValueError(f"shape type {node.get('type')!r}: only obj")
    mesh = Mesh()
    mesh.use_face_normals = bool(_parse_named(node, "face_normals", False))
    mesh.load(os.path.join(base_dir, _parse_named(node, "filename")))
    to_world, bsdf_id, emitter = torch.eye(4, dtype=torch.float32), "", None
    for child in node:
        if child.tag == "transform":
            to_world = _parse_transform(child)
        elif child.tag == "ref":
            bsdf_id = child.get("id")
        elif child.tag == "emitter":
            emitter = AreaLight(np.atleast_1d(np.asarray(
                _parse_named(child, "radiance", (1.0, 1.0, 1.0)),
                np.float32)))
    sc.add_Mesh(mesh, to_world, bsdf_id, emitter)


def load_string(text: str, base_dir: str = ".", device="cuda") -> Scene:
    """The scene of the XML ``text`` on ``device`` (the card unless the
    caller asks for the CPU); file names resolve against ``base_dir``."""
    root = ET.fromstring(text)
    if root.tag != "scene":
        raise ValueError(f"<{root.tag}>: a <scene> document expected")
    sc = Scene(device=device)
    # the reference's order (scene_loader.cpp:209-245): sensors, BSDFs,
    # emitters, shapes, so that a shape may <ref> a BSDF defined later
    for node in (n for n in root if n.tag == "sensor"):
        _add_sensor(sc, node)
    for node in (n for n in root if n.tag == "bsdf"):
        sc.add_BSDF(_parse_bsdf(node, base_dir),
                    node.get("id", f"bsdf{len(sc.bsdfs)}"))
    for node in (n for n in root if n.tag == "emitter"):
        if node.get("type") == "envmap":
            _add_envmap(sc, node, base_dir)
    for node in (n for n in root if n.tag == "shape"):
        _add_shape(sc, node, base_dir)
    return sc


def load_file(path, device="cuda") -> Scene:
    """The scene of the XML file at ``path`` on ``device`` (the card unless
    the caller asks for the CPU)."""
    path = os.fspath(path)
    with open(path) as f:
        return load_string(f.read(), os.path.dirname(path) or ".", device)
