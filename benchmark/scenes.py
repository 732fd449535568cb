"""A configuration's scene and parameters, built from its files
(``configs/<name>.json`` and the arrays it names) for a renderer package:
the port (``psdr_jit_tpu_torch``) or the reference (``reference``), which
take the same arrays and the same calls.

A parameter is an offset added to a value of the scene (``kind``):
``translate_x`` of mesh ``index`` (``to_world_raw[0, 3]``),
``vertex_offset`` of mesh ``index`` (its raw vertex positions),
``reflectance`` of BSDF ``index`` (a constant ``DiffuseBSDF``) and
``radiance`` of emitter ``index``. Its start offset is drawn uniformly
in ``+-start`` from the run's seed, and its target lies ``target`` away
from the start in every component, on a side drawn from the seed: every
seed sets the parameters the same distance from their target, so that
the loss, and the check's relative gap of it, are of one size."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

CONFIG_DIR = Path(__file__).resolve().parent / "configs"
SEED_MASK = 0xFFFFFFFF  # the renderers take a u32 sampler seed


def load_config(name: str) -> dict:
    return json.loads((CONFIG_DIR / f"{name}.json").read_text())


def scene_arrays(config: dict, size=None, spp=None) -> dict:
    """The scene's arrays with the configuration's frame size and sample
    counts; ``size = (width, height)`` and ``spp`` override them (the CPU
    tests' small runs)."""
    with np.load(CONFIG_DIR / config["scene"]) as f:
        arrays = {k: f[k] for k in f.files}
    w, h = size or (config["width"], config["height"])
    counts = [config["spp"], config["sppe"], config["sppse"]]
    if spp is not None:
        counts = [min(c, spp) for c in counts]
    arrays["opts"] = np.asarray([w, h, *counts], np.int64)
    return arrays


def round_floats(arrays: dict, dtype) -> dict:
    """The arrays with every float32 array rounded through ``dtype``."""
    out = {}
    for k, v in arrays.items():
        if v.dtype == np.float32:
            v = torch.from_numpy(v).to(dtype).float().numpy()
        out[k] = v
    return out


def param_shape(arrays: dict, p: dict) -> tuple:
    kind = p["kind"]
    if kind == "translate_x":
        return ()
    if kind == "vertex_offset":
        return arrays[f"mesh.{p['index']}.vertex_positions_raw"].shape
    if kind in ("reflectance", "radiance"):
        return (3,)
    raise ValueError(f"unknown parameter kind {kind!r}")


def draw_offsets(config: dict, arrays: dict, seed: int):
    """``(start, target)``: dicts of float32 offsets drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    start, target = {}, {}
    for p in config["params"]:
        shape = param_shape(arrays, p)
        s = rng.uniform(-p["start"], p["start"], shape)
        side = np.where(rng.uniform(-1.0, 1.0, shape) < 0.0, -1.0, 1.0)
        start[p["name"]] = s.astype(np.float32)
        target[p["name"]] = (s + p["target"] * side).astype(np.float32)
    return start, target


def build_scene(pkg, arrays: dict, device):
    """The package's scene of ``arrays`` on ``device``, configured."""
    scene = pkg.Scene.from_arrays(arrays, device=device)
    scene.configure()
    return scene


class Parameters:
    """Sets a configuration's parameters (offsets) on a scene's objects."""

    def __init__(self, scene, config: dict):
        self.scene = scene
        self.specs = config["params"]
        self.base = {}
        for p in self.specs:
            self.base[p["name"]] = self._get(p).detach().clone()

    def _get(self, p):
        sc, i = self.scene, p["index"]
        kind = p["kind"]
        if kind == "translate_x":
            return sc.meshes[i].to_world_raw
        if kind == "vertex_offset":
            return sc.meshes[i].vertex_positions_raw
        if kind == "reflectance":
            return sc.bsdfs[i].reflectance.data.reshape(3)
        return sc.emitters[i].radiance

    def device_of(self, name: str):
        return self.base[name].device

    def apply(self, values: dict):
        """Set ``values`` (offsets by name, tensors) on the scene."""
        sc = self.scene
        for p in self.specs:
            name, i = p["name"], p["index"]
            v = values[name]
            base = self.base[name]
            if p["kind"] == "translate_x":
                e03 = torch.zeros_like(base)
                e03[0, 3] = 1.0
                sc.meshes[i].to_world_raw = base + v * e03
            elif p["kind"] == "vertex_offset":
                sc.meshes[i].vertex_positions_raw = base + v
            elif p["kind"] == "reflectance":
                sc.bsdfs[i].reflectance.data = (base + v).reshape(1, 1, 3)
            else:
                sc.emitters[i].radiance = base + v

    def tensors(self, offsets: dict) -> dict:
        """Numpy offsets as float32 tensors on their bases' devices."""
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device_of(k)).clone()
                for k, v in offsets.items()}


def rays_per_iteration(config: dict, mix: dict, n_pix: int | None = None,
                       counts=None) -> int:
    """Rays one iteration traces, by ``bench.py``'s accounting (its
    docstring, lines 46-49): a pixel's interior term ``spp (1 + 2d)``
    (camera, then a shadow and a bounce ray a depth), primary-edge term
    ``sppe 2 (1 + 2d)`` (two detached Li a lane) and secondary-edge term
    ``sppse 3`` (visibility, opposite and camera rays), over the terms
    the mix names."""
    d = config["max_depth"]
    spp, sppe, sppse = counts or (config["spp"], config["sppe"],
                                  config["sppse"])
    per = {"interior": spp * (1 + 2 * d),
           "primary_edge": sppe * 2 * (1 + 2 * d),
           "secondary_edge": sppse * 3}
    if n_pix is None:
        n_pix = config["width"] * config["height"]
    return n_pix * sum(per[t] for t in mix["rays"])
