"""Procedural scenes of the PyTorch port's examples: the Cornell box and the
room (BASELINE configs #1/#2 and #5), built with the port's public API
(``Mesh.load_raw``, ``add_BSDF``, ``add_Mesh``, ...) from the classic
published Cornell-box measurements and the room's procedural layout.
They are the same scenes, constant for constant, as ``make_cbox`` and
``make_room`` of the JAX package's test scenes, and import nothing of it.

Each builder takes ``device``: the card unless the caller asks for the CPU.
:func:`launch_ranks` starts the ranks of the multi-process examples.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import psdr_jit_tpu_torch as pt  # noqa: E402


def quads_to_mesh(quads, use_face_normals: bool = True) -> pt.Mesh:
    """A mesh of convex polygons, each fanned into triangles."""
    verts, faces = [], []
    for q in quads:
        base = len(verts)
        verts.extend(q)
        for k in range(1, len(q) - 1):
            faces.append([base, base + k, base + k + 1])
    mesh = pt.Mesh()
    mesh.use_face_normals = use_face_normals
    mesh.load_raw(np.asarray(verts, np.float32), np.asarray(faces, np.int32))
    return mesh


FLOOR = [[(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)]]
CEILING = [[(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2),
            (0, 548.8, 0)]]
BACK = [[(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
         (556, 548.8, 559.2)]]
GREEN_WALL = [[(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)]]
RED_WALL = [[(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
             (556, 548.8, 0)]]
LIGHT = [[(343, 548.8, 227), (343, 548.8, 332), (213, 548.8, 332),
          (213, 548.8, 227)]]
SHORT_BLOCK = [
    [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
    [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
    [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
    [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
    [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
]
TALL_BLOCK = [
    [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
    [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
    [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
    [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
    [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
]


def make_cbox(width=64, height=64, spp=4, sppe=0, sppse=0,
              light_radiance=(20.0, 20.0, 8.0), light_offset_y=-0.5,
              max_blocks=2, fov=39.0, device="cuda") -> pt.Scene:
    """The Cornell box: a fov-39 camera, five diffuse materials, the light
    quad lowered by ``light_offset_y`` (mesh 0), the short and tall blocks
    (meshes 1 and 2) and the floor, ceiling, back, green and red walls
    (meshes 3 to 7)."""
    sc = pt.Scene(device=device)
    sc.opts = pt.RenderOption(width, height, spp, sppe, sppse)
    cam = pt.PerspectiveCamera(fov, 1e-6, 1e7)
    cam.to_world = np.array([[1.0, 0, 0, 278.0], [0, 1, 0, 273.0],
                             [0, 0, 1, -800.0], [0, 0, 0, 1.0]], np.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "light")
    sc.add_BSDF(pt.DiffuseBSDF([0.7, 0.7, 0.7]), "box")
    sc.add_BSDF(pt.DiffuseBSDF([0.95, 0.95, 0.95]), "white")
    sc.add_BSDF(pt.DiffuseBSDF([0.20, 0.90, 0.20]), "green")
    sc.add_BSDF(pt.DiffuseBSDF([0.90, 0.20, 0.20]), "red")
    light = quads_to_mesh(LIGHT)
    light.to_world_raw = torch.tensor(
        [[1.0, 0, 0, 0], [0, 1, 0, light_offset_y], [0, 0, 1, 0],
         [0, 0, 0, 1.0]], dtype=torch.float32)
    sc.add_Mesh(light, None, "light", pt.AreaLight(light_radiance))
    for b in [SHORT_BLOCK, TALL_BLOCK][:max_blocks]:
        sc.add_Mesh(quads_to_mesh(b), None, "box", None)
    for quads, bsdf in ((FLOOR, "white"), (CEILING, "white"),
                        (BACK, "white"), (GREEN_WALL, "green"),
                        (RED_WALL, "red")):
        sc.add_Mesh(quads_to_mesh(quads), None, bsdf, None)
    return sc


def box_quads(cx, cy, cz, sx, sy, sz, ry=0.0):
    """The six outward-wound quads of an axis-aligned box centred at
    ``(cx, cy, cz)`` with sides ``(sx, sy, sz)``, turned ``ry`` radians
    about +y."""
    hx, hy, hz = sx / 2.0, sy / 2.0, sz / 2.0
    c, s = np.cos(ry), np.sin(ry)

    def pt_(x, y, z):
        return (cx + (c * x + s * z), cy + y, cz + (-s * x + c * z))

    return [
        [pt_(-hx, hy, -hz), pt_(-hx, hy, hz), pt_(hx, hy, hz),
         pt_(hx, hy, -hz)],
        [pt_(-hx, -hy, -hz), pt_(hx, -hy, -hz), pt_(hx, -hy, hz),
         pt_(-hx, -hy, hz)],
        [pt_(hx, -hy, -hz), pt_(hx, hy, -hz), pt_(hx, hy, hz),
         pt_(hx, -hy, hz)],
        [pt_(-hx, -hy, -hz), pt_(-hx, -hy, hz), pt_(-hx, hy, hz),
         pt_(-hx, hy, -hz)],
        [pt_(-hx, -hy, hz), pt_(hx, -hy, hz), pt_(hx, hy, hz),
         pt_(-hx, hy, hz)],
        [pt_(-hx, -hy, -hz), pt_(-hx, hy, -hz), pt_(hx, hy, -hz),
         pt_(hx, -hy, -hz)],
    ]


def make_room(width=64, height=64, spp=4, sppe=0, sppse=0,
              light_radiance=(30.0, 28.0, 24.0), device="cuda") -> pt.Scene:
    """BASELINE config #5's room (metres; x, z in [0, 5], y in [0, 3]):
    a ceiling light panel, five walls, a Microfacet table on four diffuse
    legs, and on it a rough-conductor brass block (mesh 11), a red box
    (mesh 12) and a blue prism (mesh 13); 14 meshes, 108 triangles."""
    sc = pt.Scene(device=device)
    sc.opts = pt.RenderOption(width, height, spp, sppe, sppse)
    cam = pt.PerspectiveCamera(55.0, 1e-4, 1e5)
    cam.to_world = np.array([[1.0, 0, 0, 2.5], [0, 1.0, 0, 1.5],
                             [0, 0, 1.0, -4.2], [0, 0, 0, 1.0]], np.float32)
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF([0.0, 0.0, 0.0]), "light")
    sc.add_BSDF(pt.DiffuseBSDF([0.72, 0.70, 0.66]), "plaster")
    sc.add_BSDF(pt.DiffuseBSDF([0.45, 0.30, 0.18]), "wood_d")
    sc.add_BSDF(pt.MicrofacetBSDF(
        [0.04, 0.04, 0.04], [0.50, 0.33, 0.20], 0.25), "wood")
    sc.add_BSDF(pt.RoughConductorBSDF(
        alpha_u=0.15, eta=[0.2, 0.92, 1.1], k=[3.9, 2.45, 2.14],
        specular_reflectance=[1.0, 0.78, 0.42]), "brass")
    sc.add_BSDF(pt.DiffuseBSDF([0.20, 0.35, 0.70]), "blue")
    sc.add_BSDF(pt.DiffuseBSDF([0.75, 0.25, 0.20]), "red")
    light = quads_to_mesh([[(2.0, 2.98, 2.0), (3.0, 2.98, 2.0),
                            (3.0, 2.98, 3.0), (2.0, 2.98, 3.0)]])
    sc.add_Mesh(light, None, "light", pt.AreaLight(light_radiance))
    for quad, bsdf in (
            ([(0, 0, 0), (0, 0, 5), (5, 0, 5), (5, 0, 0)], "plaster"),
            ([(0, 3, 0), (5, 3, 0), (5, 3, 5), (0, 3, 5)], "plaster"),
            ([(0, 0, 5), (0, 3, 5), (5, 3, 5), (5, 0, 5)], "plaster"),
            ([(0, 0, 0), (0, 3, 0), (0, 3, 5), (0, 0, 5)], "red"),
            ([(5, 0, 0), (5, 0, 5), (5, 3, 5), (5, 3, 0)], "blue")):
        sc.add_Mesh(quads_to_mesh([quad]), None, bsdf)
    sc.add_Mesh(quads_to_mesh(box_quads(2.5, 0.78, 2.5, 1.6, 0.06, 1.0)),
                None, "wood")
    for dx, dz in [(-0.7, -0.4), (0.7, -0.4), (-0.7, 0.4), (0.7, 0.4)]:
        sc.add_Mesh(quads_to_mesh(box_quads(2.5 + dx, 0.375, 2.5 + dz,
                                            0.08, 0.75, 0.08)),
                    None, "wood_d")
    for args, bsdf in (((2.15, 0.96, 2.45, 0.3, 0.3, 0.3, 0.5), "brass"),
                       ((2.95, 0.91, 2.3, 0.22, 0.2, 0.22, -0.3), "red"),
                       ((2.6, 1.11, 2.75, 0.16, 0.6, 0.16, 0.9), "blue")):
        sc.add_Mesh(quads_to_mesh(box_quads(*args)), None, bsdf)
    return sc


def free_port() -> int:
    """A free local TCP port for a ``torch.distributed`` group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(script: str, world: int, args=(), timeout: float = 600.0,
                 stdout=None):
    """Run ``python script --rank r --world world --port P *args`` for each
    rank r as a process of its own, each joining the gloo group at a free
    local port; wait for each at most ``timeout`` seconds (then kill it).
    ``stdout``: a file the ranks write their output to (this process's
    output when None). True where every rank exits with 0."""
    import subprocess

    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-u", script, "--rank", str(r), "--world",
         str(world), "--port", port, *map(str, args)], stdout=stdout)
        for r in range(world)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(None)
    for p in procs:  # never leave a rank behind
        if p.poll() is None:
            p.kill()
            p.wait()
    print("rank exit codes:", codes)
    return all(c == 0 for c in codes)


def join_group(rank: int, world: int, port: int, timeout: float = 600.0):
    """Join the gloo group of ``world`` ranks at the local ``port``."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def print_launches(rank: int):
    """Print this rank's kernel launches (``ops._cuda.LAUNCHES``) as one
    line: ``rank <r> kernel launches: {json}``."""
    import json

    from psdr_jit_tpu_torch.ops import _cuda

    print(f"rank {rank} kernel launches: {json.dumps(_cuda.LAUNCHES)}",
          flush=True)


def rank_args(argv=None):
    """``(rank, world, port, the rest)`` of a rank's command line, or None
    where it names no rank (the launcher)."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ns, rest = ap.parse_known_args(argv)
    if ns.rank is None:
        return None
    return ns.rank, ns.world, ns.port, rest
