#!/usr/bin/env python3
"""On-card smoke run of psdr_jit_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Builds the port's kernels from ``psdr_jit_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (K1; K2 in
its single, pair and stash modes; K3, the attached shade; K4, its adjoint;
K5, the streamed super-block sweep; K6, the tree traversal), checks a
32x32 render against ``tests/golden_cbox32.npy``, then drives three main
paths at full size as a user would, each with the launch counts set to 0
just before it and read just after:

* serving the Cornell box of ``tests/data/cbox_scene.npz``: a picking
  query (``Scene.unit_ray_intersect``, K1) and a frame (``renderC``, K2)
  at 512x512, spp 32, ``PathTracer(3)``;
* training on it: one step of ``PathTracer(3).loss_and_grad`` at 512x512,
  spp 32, sppe 32 (interior term through K2 stash, K3 and K4; primary-edge
  term through K2 pair), with gradients to a light translation, the tall
  block's vertex offsets, a reflectance and the radiance;
* serving a large scene, the procedural gallery of ``gallery_arrays``
  (102,412 triangles): a picking query and a frame at 256x256, spp 4,
  ``PathTracer(2)``, through the general Li and K6; and the same frame of
  the 1,292-triangle gallery through K5.

A 64x64 training step of the box and a 64x64 frame of the 5,132-triangle
gallery run through the kernels and, on the CPU, through the plain
versions, and the two must agree. One training step and one gallery frame
run with every launch recorded, and each launch is held against its plain
version on the inputs it was given. Kernels, frames and step are timed
against their plain versions, and each kernel's least possible time on an
H100 (its bound) is computed from its inputs.

Every phase prints one line; any failure exits non-zero without the final
line. The last two lines are the card (``nvidia-smi`` name and power limit)
and ``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record. Exits non-zero when no CUDA card is visible. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE_NPZ = ROOT / "tests" / "data" / "cbox_scene.npz"
GOLDEN = ROOT / "tests" / "golden_cbox32.npy"
FRAME = (512, 512, 32)  # width, height, spp of cbox_scene.npz
SPPE = 32  # edge samples per pixel of the training step
SEED = 0
DEPTH = 3
# the large-scene path: gallery_arrays() at 256x256, spp 4, PathTracer(2)
LARGE = (256, 256, 4)
LARGE_DEPTH = 2
WIDE = (512, 512, 8)  # the same scene's larger frame, timed only
CHECK_RAYS = 1 << 18  # rays of the [K5] and [K6] checks
PLAIN_RAYS = 1 << 16  # of them, the rays [K6] holds against the plain K6


def log(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn`` (which ends on the device) over ``reps``
    runs after one warm-up, each closed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def on_plane_rays(box, n_per: int, gen, device):
    """Axis-aligned rays whose origin lies on a cluster box's face plane:
    the case where a per-ray slab test meets 0 * inf."""
    import torch

    lo, hi = box[:3].T, box[3:].T  # (nc, 3)
    nc = lo.shape[0]
    c = torch.randint(0, nc, (n_per,), generator=gen, device=device)
    p = lo[c] + (hi[c] - lo[c]) * torch.rand((n_per, 3), generator=gen,
                                             device=device)
    axis = torch.randint(0, 3, (n_per,), generator=gen, device=device)
    side = torch.randint(0, 2, (n_per,), generator=gen, device=device)
    plane = torch.where(side == 0, lo[c, axis], hi[c, axis])
    p[torch.arange(n_per, device=device), axis] = plane
    d = torch.zeros((n_per, 3), device=device)
    dax = torch.randint(0, 3, (n_per,), generator=gen, device=device)
    sgn = torch.where(torch.rand(n_per, generator=gen, device=device) < 0.5,
                      -1.0, 1.0)
    d[torch.arange(n_per, device=device), dax] = sgn
    return p.contiguous(), d.contiguous()


def pixel_center_rays(sd, width, height, device):
    """One ray through each pixel center, pixel-major."""
    import torch

    pix = torch.arange(width * height, device=device)
    xy = torch.stack([(pix % width).float() + 0.5,
                      (pix // width).float() + 0.5], -1)
    xy = xy / torch.tensor([width, height], dtype=torch.float32,
                           device=device)
    return sd.sensors[0].sample_primary_ray(xy)


def rel_l1(a, b) -> float:
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# limit): memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float32 operations of THE hit test (csrc/sweep.cuh hit_test), a fused
# multiply-add counted as two as the peak counts it: three cross products
# (27), three dot products (15), the reciprocal, three differences and
# u + v, less the shared terms: 46.
TEST_FLOPS = 46
# float32 operations of one depth of a lane's shading outside its sweeps
# (hit attributes, the light sample, MIS, the cosine bounce): a lower
# estimate, for the megakernels' bounds; the adjoint counts three times it.
SHADE_FLOPS = 200
# bytes a ray moves through an intersection kernel: origin and direction
# in, (t, id, u, v) out
RAY_BYTES = 24 + 16
# bytes of a triangle that any closest hit must read: p0, e1 and e2 in
# float32 (a kernel's own tree, boxes or padding are its design, not its work)
TRI_BYTES = 36


def ptxas_report(kernel: str, report: str | None = None) -> str:
    """Registers, stack and spills of each compiled instance of ``kernel``
    in ptxas's ``report`` (by default that of the package's build,
    ``ptxas.txt``), as ``"<template argument>:<registers>r/<stack>B/<spill
    stores>+<spill loads>B"`` joined by commas."""
    import re

    from psdr_jit_tpu_torch.ops import _cuda

    if report is None:
        report = (_cuda.build().parent / "ptxas.txt").read_text()
    out, name = [], None
    stack = None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            stack = m.groups()
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and stack is not None:
            args = re.search(kernel + r"IL\w(\d+)EE", name)
            out.append(f"{args.group(1) if args else '-'}:{m.group(1)}r/"
                       f"{stack[0]}B/{stack[1]}+{stack[2]}B")
            name = stack = None
    return ",".join(out)


def bound(nbytes: float, flops: float):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` and do ``flops``, and which of the two sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def needed_tests(lo, hi, size: int, o, d, t, active=None,
                 chunk: int = 1 << 13) -> int:
    """The (ray, triangle) tests these rays need: for each ray the
    clusters (widened boxes ``lo``, ``hi`` (nc, 3), ``size`` triangles
    each) that its slab test enters before its closest hit ``t``, as a
    culling sweep that knew the answer would still test them. The kernels'
    culling, which only knows the hit found so far, tests at least these;
    the plain K1 and K5 test every triangle."""
    import torch
    from psdr_jit_tpu_torch.ops.intersect import box_visit

    inv = 1.0 / d
    total = 0
    for s in range(0, o.shape[0], chunk):
        e = s + chunk
        v = box_visit(lo[None], hi[None], o[s:e, None], inv[s:e, None],
                      t[s:e, None])
        if active is not None:
            v = v & active[s:e, None]
        total += int(v.sum())
    return total * size


def triangle_box_tests(p0, e1, e2, o, d, t, active=None, cluster: int = 64,
                       chunk: int = 1 << 12) -> int:
    """The (ray, triangle) tests any hierarchy of boxes over these
    triangles must make: for each ray, the triangles whose own widened box
    (``widen_boxes``) its slab test enters before its closest hit ``t``.
    Counted exactly, but only inside the ``cluster``-triangle runs of
    consecutive ids whose box (the union of theirs) the ray enters, which
    contain those triangle boxes. It depends on the rays, their hits and
    the triangles, not on the kernel's hierarchy."""
    import torch
    from psdr_jit_tpu_torch.ops.intersect import box_visit, widen_boxes

    f = p0.shape[0]
    v1, v2 = p0 + e1, p0 + e2
    lo, hi = widen_boxes(torch.minimum(torch.minimum(p0, v1), v2),
                         torch.maximum(torch.maximum(p0, v1), v2))
    nc = -(-f // cluster)
    pad = nc * cluster - f
    clo = torch.cat([lo, lo.new_full((pad, 3), float("inf"))]).reshape(
        nc, cluster, 3).amin(1)
    chi = torch.cat([hi, hi.new_full((pad, 3), float("-inf"))]).reshape(
        nc, cluster, 3).amax(1)
    inv = 1.0 / d
    k = torch.arange(cluster, device=o.device)
    total = 0
    for s in range(0, o.shape[0], chunk):
        e = s + chunk
        v = box_visit(clo[None], chi[None], o[s:e, None], inv[s:e, None],
                      t[s:e, None])
        if active is not None:
            v = v & active[s:e, None]
        r, c = torch.nonzero(v).unbind(1)
        j = c[:, None] * cluster + k[None]
        ok = j < f
        j = torch.clamp(j, max=f - 1)
        r = r + s
        total += int((box_visit(lo[j], hi[j], o[r, None], inv[r, None],
                                t[r, None]) & ok).sum())
    return total


def camera_tests(tab, box, o, d, active=None) -> int:
    """``needed_tests`` of rays against a packed table of at most 512
    triangles and its 16-triangle cluster boxes (``pack_triangles``), their
    closest hits found by K1 outside any counted run."""
    from psdr_jit_tpu_torch.ops import intersect as ix

    t, _, _ = ix.intersect_cuda(tab, box, o.contiguous(), d.contiguous())
    lo, hi = ix.widen_boxes(box[:3].T, box[3:].T)
    return needed_tests(lo, hi, ix.CLUSTER, o, d, t, active)


def render_plain(sd, opts, seed, depth, chunk_lanes):
    """The main path with K2 replaced by its plain version: the same lane
    setup, primary rays, tables, chunking and average as renderC."""
    import torch
    from psdr_jit_tpu_torch.core.math import scrub_nonfinite
    from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.ops.image import interior_average

    dev = sd.tri.p0.device
    spp = opts.spp
    n_pix = opts.num_pixels
    pix = torch.arange(n_pix, device=dev)
    out = torch.empty((n_pix, 3), device=dev)
    step = max(chunk_lanes // spp, 1)
    tables = mk.build_tables(sd)
    for s in range(0, n_pix, step):
        m, sampler, samples = interior_lane_setup(
            opts.width, opts.height, spp, seed, pix[s:s + step])
        ray = sd.sensors[0].sample_primary_ray(samples)
        li = mk.li_mega_plain(
            *tables, ray.o, ray.d, torch.ones(m * spp, dtype=torch.bool,
                                              device=dev),
            sampler.lane, sampler.seed_value, depth, sampler.cnt)
        out[s:s + step] = interior_average(scrub_nonfinite(li), m, spp)
    return out


def train_setup(scene, seed: int = SEED):
    """``(params, apply_params, pixel_loss)`` of a training step with the
    JAX package's test parameters: a translation of the light (mesh 0),
    the tall block's raw vertex offsets (mesh 2), the reflectance of
    ``bsdfs[1]`` and the radiance; an L2 loss against a random target."""
    import numpy as np
    import torch

    light, block = scene.meshes[0], scene.meshes[2]
    base = light.to_world_raw.clone()
    verts = block.vertex_positions_raw.clone()
    target = torch.from_numpy(np.random.default_rng(seed).random(
        (scene.opts.num_pixels, 3)).astype(np.float32)).to(scene.device)

    def apply_params(p):
        light.to_world_raw = base + torch.nn.functional.pad(
            p["tx"].reshape(1, 1), (3, 0, 0, 3))
        block.vertex_positions_raw = verts + p["dv"]
        scene.bsdfs[1].reflectance = p["alb"]
        scene.emitters[0].radiance = p["rad"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"tx": torch.zeros(()), "dv": torch.zeros_like(verts),
              "alb": scene.bsdfs[1].reflectance.clone(),
              "rad": scene.emitters[0].radiance.clone()}
    return params, apply_params, pixel_loss


_EYE4 = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]]


def _icosphere(subdiv: int):
    """Unit icosphere: the icosahedron subdivided ``subdiv`` times (20 *
    4^subdiv faces); numpy copy of ``tests/scenes.py`` ``_icosphere``."""
    import numpy as np

    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        edges, verts, nf = {}, list(v), []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                edges[key] = len(verts) - 1
            return edges[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def gallery_arrays(width=256, height=256, spp=4, n_spheres=80, subdiv=3,
                   seed=0) -> dict:
    """The large-scene gallery of ``tests/scenes.py`` ``make_gallery`` as
    the dict ``interop.scene_to_arrays`` makes of it, built with numpy: a
    lit box room [0, 10]^3 (open front) holding a jittered grid of
    ``n_spheres`` smooth icospheres, ``n_spheres * 20 * 4^subdiv + 12``
    triangles (102,412 by default). The card's machine has no JAX."""
    import numpy as np

    out = {"opts": np.asarray([width, height, spp, 0, 0], np.int64),
           "seed": np.asarray(0, np.int64)}
    eye = np.asarray(_EYE4, np.float32)
    ids = ["light", "wall"] + [f"m{i}" for i in range(6)]
    refl = [[0.0, 0.0, 0.0], [0.75, 0.73, 0.70]] + [
        [0.2 + 0.12 * (i % 3), 0.25 + 0.1 * ((i + 1) % 3),
         0.3 + 0.11 * ((i + 2) % 3)] for i in range(6)]
    out["bsdf_ids"] = np.asarray(ids)
    for j, r in enumerate(refl):
        out[f"bsdf.{j}.reflectance"] = np.asarray(r, np.float32)
        out[f"bsdf.{j}.twoSide"] = np.asarray(False)
    out["emitter.0.radiance"] = np.asarray((40.0, 38.0, 34.0), np.float32)
    out["emitter.0.mesh_index"] = np.asarray(0, np.int64)
    meshes = []  # (vertices, faces, use_face_normals, enable_edges, bsdf)

    def quad(q):
        return (np.asarray(q, np.float32), np.asarray([[0, 1, 2], [0, 2, 3]],
                                                       np.int32), True, True)

    meshes.append(quad([(3.5, 9.98, 3.5), (6.5, 9.98, 3.5),
                        (6.5, 9.98, 6.5), (3.5, 9.98, 6.5)]) + ("light",))
    for q in ([(0, 0, 0), (0, 0, 10), (10, 0, 10), (10, 0, 0)],
              [(0, 10, 0), (10, 10, 0), (10, 10, 10), (0, 10, 10)],
              [(0, 0, 10), (0, 10, 10), (10, 10, 10), (10, 0, 10)],
              [(0, 0, 0), (0, 10, 0), (0, 10, 10), (0, 0, 10)],
              [(10, 0, 0), (10, 0, 10), (10, 10, 10), (10, 10, 0)]):
        meshes.append(quad(q) + ("wall",))
    rng = np.random.default_rng(seed)
    sv, sf = _icosphere(subdiv)
    side = int(np.ceil(n_spheres ** (1.0 / 3.0)))
    placed = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if placed >= n_spheres:
                    break
                c = (np.asarray([ix, iy, iz]) + 0.5) / side * 8.0 + 1.0
                c += rng.uniform(-0.3, 0.3, 3)
                r = rng.uniform(0.35, 0.6)
                meshes.append(((sv * r + c[None, :]).astype(np.float32), sf,
                               False, False, f"m{placed % 6}"))
                placed += 1
    for i, (v, f, fn, edges, bsdf) in enumerate(meshes):
        out[f"mesh.{i}.vertex_positions_raw"] = v
        out[f"mesh.{i}.face_indices"] = f
        for name in ("to_world_left", "to_world_raw", "to_world_right"):
            out[f"mesh.{i}.{name}"] = eye
        out[f"mesh.{i}.use_face_normals"] = np.asarray(fn)
        out[f"mesh.{i}.enable_edges"] = np.asarray(edges)
        out[f"mesh.{i}.bsdf_id"] = np.asarray(ids.index(bsdf), np.int64)
        out[f"mesh.{i}.emitter_id"] = np.asarray(0 if i == 0 else -1,
                                                 np.int64)
    out["counts"] = np.asarray([len(meshes), len(ids), 1, 1], np.int64)
    out["sensor.0.fov_near_far"] = np.asarray([55.0, 1e-4, 1e5], np.float64)
    out["sensor.0.to_world_left"] = eye
    out["sensor.0.to_world_raw"] = np.asarray(
        [[1.0, 0, 0, 5.0], [0, 1.0, 0, 5.0], [0, 0, 1.0, -9.0],
         [0, 0, 0, 1.0]], np.float32)
    out["sensor.0.to_world_right"] = eye
    return out


def tie_case(n_tri: int = 5000, n_pairs: int = 150, seed: int = 41):
    """``(p0, e1, e2, ray_o, ray_d, low)``, numpy: ``n_tri`` small
    triangles scattered in [-1, 1]^3 (in Morton order), ``n_pairs`` of
    them copied to other ids, and a ray from a random origin aimed at each
    copied triangle, so that rays hit two triangles at exactly the same
    distance; ``low`` is the lower id of each ray's pair, the hit the
    unculled sweep keeps."""
    import numpy as np
    from psdr_jit_tpu_torch.scene.scene import morton_order

    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1, e2 = (rng.uniform(-0.03, 0.03, (n_tri, 3)).astype(np.float32)
              for _ in range(2))
    src = rng.choice(n_tri, n_pairs, replace=False)
    dst = rng.choice(np.setdiff1d(np.arange(n_tri), src), n_pairs,
                     replace=False)
    for x in (p0, e1, e2):
        x[dst] = x[src]
    target = p0[src] + 0.3 * e1[src] + 0.3 * e2[src]
    ro = rng.uniform(-2, 2, (n_pairs, 3)).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    # in the Morton order a scene compile gives its triangles
    perm = morton_order(p0 + (e1 + e2) / 3.0)
    rank = np.argsort(perm)
    return (p0[perm], e1[perm], e2[perm], ro, rd,
            np.minimum(rank[src], rank[dst]))


def swapped_children(tree):
    """``tree`` with the two children of every node swapped: the same
    tree, visited in another order."""
    import dataclasses

    import torch

    return dataclasses.replace(tree, node=torch.cat(
        [tree.node[:, 8:], tree.node[:, :8]], 1).contiguous())


class PlainCalls:
    """Counts calls of the plain versions while active (by wrapping the
    module globals their dispatchers call), so a run can show that it
    reached none of them."""

    def __init__(self):
        from psdr_jit_tpu_torch.ops import intersect as ix
        from psdr_jit_tpu_torch.ops import megakernel as mk
        from psdr_jit_tpu_torch.ops import shade_mega as sm

        from psdr_jit_tpu_torch.ops import bvh

        self.sites = [(ix, "ray_intersect_brute"), (mk, "_li_plain"),
                      (sm, "li_attached_plain"),
                      (bvh, "ray_intersect_bvh_plain")]
        self.count = 0

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.sites]
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, self._counted(fn))
        return self

    def _counted(self, fn):
        def wrapper(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return wrapper

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)


def train_kernel_phases(sd, sd_edges, tables, dev, gen, kernels):
    """[K2-pair], [K2-stash], [K3], [K4]: each kernel against its plain
    version on a 131,072-lane crop of the training step's inputs."""
    import torch
    from psdr_jit_tpu_torch.core.sampler import Sampler
    from psdr_jit_tpu_torch.integrator.base import (STREAM_PRIMARY,
                                                    interior_lane_setup)
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.ops import shade_mega as sm
    from psdr_jit_tpu_torch.sensor.sensor import sample_primary_edge

    W, H, SPP = FRAME
    n = 1 << 17

    # K2 pair: the primary-edge pass's first 131,072 edge samples
    sampler = Sampler(SEED + STREAM_PRIMARY, torch.arange(n, device=dev))
    es = sample_primary_edge(sd_edges.sensors[0], sampler.next_1d())
    valid = es.idx >= 0
    args = (*tables, es.ray_n.o.contiguous(), es.ray_n.d.contiguous(),
            es.ray_p.o.contiguous(), es.ray_p.d.contiguous(), valid,
            sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
    out = mk.li_mega_pair_cuda(*args)
    ref = mk.li_mega_pair_plain(*args)
    torch.cuda.synchronize()
    rel, err = rel_l1(out, ref), float((out - ref).abs().max())
    ms = cuda_ms(lambda: mk.li_mega_pair_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: mk.li_mega_pair_plain(*args), 3)
    log("K2-pair", lanes=n, valid=int(valid.sum()), depth=DEPTH,
        bitwise_equal_to_plain=torch.equal(out, ref), rel_l1=f"{rel:.3e}",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(bool(torch.isfinite(out).all()), "K2-pair: non-finite values")
    require(float(out.abs().sum()) > 0, "K2-pair: all differences zero")
    require(rel < 1e-3, "K2-pair: rel L1 vs plain >= 1e-3")
    kernels["K2-pair"] = dict(
        name="K2 pair mode: Li(ray_n) - Li(ray_p)", route="cuda",
        source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:591", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=None)

    # K2 stash: the camera lanes of a 4096-pixel crop (131,072 lanes)
    crop = torch.arange(H // 2 * W, (H // 2 + 8) * W, device=dev)
    m, sampler, samples = interior_lane_setup(W, H, SPP, SEED, crop)
    ray = sd.sensors[0].sample_primary_ray(samples, diff=False)
    o, d = ray.o.contiguous(), ray.d.contiguous()
    act = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    args = (*tables, o, d, act, sampler.lane, sampler.seed_value, DEPTH,
            sampler.cnt)
    li, hits = mk.li_mega_stash_cuda(*args)
    li_p, hits_p = mk.li_mega_stash_plain(*args)
    torch.cuda.synchronize()
    same = hits[0] == hits_p[0]
    uv_equal = all(torch.equal(a[same], b[same])
                   for a, b in zip(hits[1:], hits_p[1:]))
    rel, err = rel_l1(li, li_p), float((li - li_p).abs().max())
    id_match = same.float().mean().item()
    ms = cuda_ms(lambda: mk.li_mega_stash_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: mk.li_mega_stash_plain(*args), 3)
    log("K2-stash", lanes=o.shape[0], hits=hits[0].shape[0],
        id_match=f"{id_match:.6f}", uv_equal_where_ids_match=uv_equal,
        rel_l1=f"{rel:.3e}", max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    require(rel < 1e-3, "K2-stash: rel L1 vs plain >= 1e-3")
    require(id_match >= 0.999 and uv_equal, "K2-stash: hits differ")
    kernels["K2-stash"] = dict(
        name="K2 stash mode: detached Li and the hits of every path",
        route="cuda", source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:591", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=None)

    # K3 and K4 on the kernel's own stash
    tabs = [t.detach().contiguous() for t in sm.attached_tables(sd)]
    lane32 = mk._lane_i32(sampler.lane)
    shade_args = (*tabs, *hits, o, d, act, lane32, sampler.seed_value,
                  DEPTH, sampler.cnt)
    out = sm.shade_cuda(*shade_args)
    leaves = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    ref = sm.li_attached_plain(*leaves[:3], *hits, leaves[3], leaves[4],
                               act, sampler.lane, sampler.seed_value, DEPTH,
                               sampler.cnt)
    torch.cuda.synchronize()
    rel = rel_l1(out, ref.detach())
    err = float((out - ref.detach()).abs().max())
    ms = cuda_ms(lambda: sm.shade_cuda(*shade_args), 20)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: sm.li_attached_plain(
            *tabs, *hits, o, d, act, sampler.lane, sampler.seed_value,
            DEPTH, sampler.cnt), 3)
    log("K3", lanes=o.shape[0], depth=DEPTH, rel_l1=f"{rel:.3e}",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(bool(torch.isfinite(out).all()), "K3: non-finite radiance")
    require(rel < 1e-5, "K3: rel L1 vs plain >= 1e-5")
    kernels["K3"] = dict(
        name="K3 attached interior shade", route="cuda",
        source="psdr_jit_tpu_torch/csrc/shade.cu",
        replaces="psdr_jit_tpu/ops/shade_mega.py:476", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=None)

    ct = torch.randn(out.shape, device=dev, generator=gen)
    grads = sm.shade_adjoint_cuda(*shade_args, False, ct)
    again = sm.shade_adjoint_cuda(*shade_args, False, ct)
    refs = torch.autograd.grad(ref, leaves, ct, retain_graph=True,
                               allow_unused=True)
    torch.cuda.synchronize()
    rels, errs = {}, []
    for name, g, r in zip(("table", "light", "misc", "o", "d"), grads, refs):
        r = torch.zeros_like(g) if r is None else r
        rels[name] = rel_l1(g, r) if r.abs().sum() > 0 else float(
            g.abs().sum())
        errs.append(float((g - r).abs().max()))
    spread = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                 for a, b in zip(grads[:3], again[:3]))
    ms = cuda_ms(lambda: sm.shade_adjoint_cuda(*shade_args, False, ct), 20)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        ref, leaves, ct, retain_graph=True, allow_unused=True), 3)
    log("K4", lanes=o.shape[0], depth=DEPTH,
        ptxas=ptxas_report("shade_bwd_kernel"),
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        max_abs_err=f"{max(errs):.3e}", run_to_run_rel=f"{spread:.3e}",
        bitwise_run_to_run=all(torch.equal(a, b)
                               for a, b in zip(grads, again)),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(all(torch.isfinite(g).all() for g in grads), "K4: non-finite")
    require(all(v < 1e-4 for v in rels.values()),
            "K4: a cotangent group's rel L1 vs autograd >= 1e-4")
    kernels["K4"] = dict(
        name="K4 adjoint of K3, written by hand", route="cuda",
        source="psdr_jit_tpu_torch/csrc/shade.cu",
        replaces="psdr_jit_tpu/ops/shade_mega.py:476", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None)


class KernelCalls:
    """Records the inputs and outputs of every launch of the kernels in
    ``sites`` (``{name: (module, wrapper name)}``; by default K2-stash, K3,
    K4 and K2-pair) while active, by wrapping the module globals their
    dispatchers call, so each launch of a run can be held against its plain
    version on exactly the inputs the run gave it."""

    def __init__(self, sites=None):
        from psdr_jit_tpu_torch.ops import megakernel as mk
        from psdr_jit_tpu_torch.ops import shade_mega as sm

        self.sites = sites or {"K2-stash": (mk, "li_mega_stash_cuda"),
                               "K3": (sm, "shade_cuda"),
                               "K4": (sm, "shade_adjoint_cuda"),
                               "K2-pair": (mk, "li_mega_pair_cuda")}
        self.calls = {k: [] for k in self.sites}

    def __enter__(self):
        self.saved = {k: getattr(m, n) for k, (m, n) in self.sites.items()}
        for k, (m, n) in self.sites.items():
            setattr(m, n, self._recorded(k, self.saved[k]))
        return self

    def _recorded(self, kernel, fn):
        import torch

        def wrapper(*args):
            out = fn(*args)
            # a copy: autograd may add into a cotangent the kernel returned
            kept = torch.utils._pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
            self.calls[kernel].append((fn, args, kept))
            return out
        return wrapper

    def __exit__(self, *exc):
        for k, (m, n) in self.sites.items():
            setattr(m, n, self.saved[k])


def _synced_ms(fn):
    """``(result, host ms)`` of one call of ``fn``, closed by a
    synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _plain_shade(args, ct, slice_lanes: int = 1 << 20):
    """K3's and K4's plain versions on the recorded inputs ``args`` of a
    ``shade_cuda`` launch, in slices of ``slice_lanes`` lanes: the radiance
    (N, 3), autograd's cotangents of (table, light, misc, o, d) for the
    output cotangent ``ct`` (the table groups summed over the slices), and
    the host ms of the forwards and of the backwards."""
    import torch
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    table, light, misc, ids, us, vs, o, d, act, lane, *rest = args
    n = o.shape[0]
    outs, d_o, d_d = [], [], []
    sums = [torch.zeros_like(t) for t in (table, light, misc)]
    fwd_ms = bwd_ms = 0.0
    for s in range(0, n, slice_lanes):
        e = min(s + slice_lanes, n)
        leaves = [x.detach().clone().requires_grad_()
                  for x in (table, light, misc, o[s:e], d[s:e])]
        with torch.enable_grad():
            out, ms = _synced_ms(lambda: sm.li_attached_plain(
                *leaves[:3], ids[:, s:e], us[:, s:e], vs[:, s:e], leaves[3],
                leaves[4], act[s:e], lane[s:e], *rest))
            fwd_ms += ms
            grads, ms = _synced_ms(lambda: torch.autograd.grad(
                out, leaves, ct[s:e], allow_unused=True))
            bwd_ms += ms
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        for acc, g in zip(sums, grads[:3]):
            acc += g
        outs.append(out.detach())
        d_o.append(grads[3])
        d_d.append(grads[4])
    return (torch.cat(outs), (*sums, torch.cat(d_o), torch.cat(d_d)),
            fwd_ms, bwd_ms)


def train_frame_phase(step, kernels):
    """[train-frame]: one step of the training main path with each
    K2-stash, K3, K4 and K2-pair launch recorded, then each launch held
    against its plain version on the same inputs (K4 with the step's own
    loss cotangent) and timed at the step's shapes."""
    import torch
    from psdr_jit_tpu_torch.ops import megakernel as mk

    with KernelCalls() as rec:
        step()
        torch.cuda.synchronize()
    stats = {}

    def note(kernel, err, diff, ref, ms, plain_ms, **extra):
        s = stats.setdefault(kernel, dict(launches=0, lanes=0, err=0.0,
                                          diff=0.0, ref=0.0, ms=0.0,
                                          plain_ms=0.0, nbytes=0,
                                          flops=0))
        s["launches"] += 1
        s["err"] = max(s["err"], err)
        s["diff"] += diff
        s["ref"] += ref
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        for k, v in extra.items():
            s[k] = s.get(k, 0) + v

    for fn, args, (li, hits) in rec.calls["K2-stash"]:
        (li_p, hits_p), plain_ms = _synced_ms(
            lambda: mk.li_mega_stash_plain(*args))
        n, n_hits = li.shape[0], hits[0].shape[0]
        same = hits[0] == hits_p[0]
        uv_off = sum(int((a[same] != b[same]).sum())
                     for a, b in zip(hits[1:], hits_p[1:]))
        diff = (li - li_p).abs()
        note("K2-stash", float(diff.max()), float(diff.sum()),
             float(li_p.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=li.shape[0], hits=same.numel(),
             ids_off=int((~same).sum()), uv_off=uv_off,
             nbytes=n * (29 + 12 + 12 * n_hits),
             flops=camera_tests(*args[:2], *args[5:8]) * TEST_FLOPS
             + n * DEPTH * SHADE_FLOPS)
    k4_calls = rec.calls["K4"]
    require(len(k4_calls) == len(rec.calls["K3"]),
            "train-frame: K3 and K4 launches differ")
    groups = ("table", "light", "misc", "o", "d")
    k4 = {g: [0.0, 0.0] for g in groups}
    for (fn3, args, out), (fn4, args4, grads) in zip(rec.calls["K3"],
                                                     k4_calls):
        ct = args4[-1]
        require(all(a.data_ptr() == b.data_ptr()
                    if isinstance(a, torch.Tensor) else a == b
                    for a, b in zip(args, args4[:-1])),
                "train-frame: K4 ran on other inputs than K3")
        ref, ref_grads, fwd_ms, bwd_ms = _plain_shade(args, ct)
        diff = (out - ref).abs()
        n, n_hits = out.shape[0], args[3].shape[0]
        table_bytes = sum(4 * a.numel() for a in args[:3])
        note("K3", float(diff.max()), float(diff.sum()),
             float(ref.abs().sum()), cuda_ms(lambda: fn3(*args), 3), fwd_ms,
             lanes=n, nbytes=n * (29 + 12 + 12 * n_hits) + table_bytes,
             flops=n * DEPTH * SHADE_FLOPS)
        again = fn4(*args4)
        spread = max(float((a - b).abs().max()
                           / a.abs().max().clamp_min(1e-30))
                     for a, b in zip(grads[:3], again[:3]))
        err = 0.0
        for g, a, r in zip(groups, grads, ref_grads):
            k4[g][0] += float((a - r).abs().sum())
            k4[g][1] += float(r.abs().sum())
            err = max(err, float((a - r).abs().max()))
        note("K4", err, 0.0, 0.0, cuda_ms(lambda: fn4(*args4), 3), bwd_ms,
             lanes=n, nbytes=n * (29 + 12 + 12 * n_hits + 24)
             + 2 * table_bytes, flops=3 * n * DEPTH * SHADE_FLOPS)
        stats["K4"]["spread"] = max(stats["K4"].get("spread", 0.0), spread)
    for fn, args, out in rec.calls["K2-pair"]:
        ref, plain_ms = _synced_ms(lambda: mk.li_mega_pair_plain(*args))
        diff = (out - ref).abs()
        n, valid = out.shape[0], args[9]
        note("K2-pair", float(diff.max()), float(diff.sum()),
             float(ref.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=n, valid=int(valid.sum()), nbytes=n * (53 + 12),
             flops=(camera_tests(*args[:2], args[5], args[6], valid)
                    + camera_tests(*args[:2], args[7], args[8], valid))
             * TEST_FLOPS
             + 2 * n * DEPTH * SHADE_FLOPS)
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        require(k in stats, f"train-frame: the step launched no {k}")

    rels = {}
    for k in ("K2-stash", "K3", "K2-pair"):
        s = stats[k]
        rels[k] = s["diff"] / max(s["ref"], 1e-30)
    k4_rel = {g: (d / r if r > 0 else d) for g, (d, r) in k4.items()}
    s = stats["K2-stash"]
    id_match = 1.0 - s["ids_off"] / s["hits"]
    log("train-frame", **{
        f"{k}": (f"launches:{v['launches']},lanes:{v['lanes']},"
                 f"max_abs_err:{v['err']:.3e},ms:{v['ms']:.4f},"
                 f"plain_ms:{v['plain_ms']:.1f}")
        for k, v in stats.items()},
        stash_id_match=f"{id_match:.6f}", stash_uv_off=s["uv_off"],
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        K4_rel_l1=",".join(f"{g}:{v:.3e}" for g, v in k4_rel.items()),
        K4_run_to_run_rel=f"{stats['K4']['spread']:.3e}",
        pair_valid=stats["K2-pair"]["valid"])
    require(rels["K2-stash"] < 1e-3 and rels["K2-pair"] < 1e-3,
            "train-frame: a K2 mode's rel L1 vs plain >= 1e-3")
    require(id_match >= 0.999 and s["uv_off"] == 0,
            "train-frame: K2-stash hits differ")
    require(rels["K3"] < 1e-5, "train-frame: K3 rel L1 vs plain >= 1e-5")
    require(all(v < 1e-4 for v in k4_rel.values()),
            "train-frame: a K4 cotangent group's rel L1 vs autograd >= 1e-4")
    for k, s in stats.items():
        bound_ms, bound_by = bound(s["nbytes"], s["flops"])
        kernels[k].update(max_abs_err=max(kernels[k]["max_abs_err"],
                                          s["err"]),
                          ms=s["ms"], plain_ms=s["plain_ms"],
                          bound_ms=bound_ms, bound_by=bound_by)


def mixed_rays(sd, n: int, gen, device):
    """``(o, d, active)`` of ``n`` rays against scene data ``sd``: a quarter
    camera rays of its frame (jittered as renderC's), a quarter leaving
    points on triangles in random directions (as NEE and bounce rays
    leave surfaces), a quarter from random points inside the scene's box
    in random directions, the rest axis-aligned on cluster-box planes
    (``on_plane_rays``); every seventh lane inactive."""
    import torch
    from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
    from psdr_jit_tpu_torch.ops import intersect as ix

    q = n // 4
    sensor = sd.sensors[0]
    pix = torch.arange(q, device=device) % (sensor.width * sensor.height)
    _, _, samples = interior_lane_setup(sensor.width, sensor.height, 1,
                                        SEED, pix)
    cam = sensor.sample_primary_ray(samples, diff=False)
    tri = sd.tri
    j = torch.randint(0, tri.p0.shape[0], (q,), generator=gen, device=device)
    b = torch.rand((q, 2), generator=gen, device=device) * 0.5
    so = tri.p0[j] + tri.e1[j] * b[:, :1] + tri.e2[j] * b[:, 1:]
    lo, hi = sd.lower, sd.upper
    ro = lo + (hi - lo) * torch.rand((q, 3), generator=gen, device=device)
    dirs = torch.nn.functional.normalize(
        torch.randn((2 * q, 3), generator=gen, device=device), dim=-1)
    _, box = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
    po, pd = on_plane_rays(box, n - 3 * q, gen, device)
    o = torch.cat([cam.o, so, ro, po]).contiguous()
    d = torch.cat([cam.d, dirs, pd]).contiguous()
    active = torch.ones(n, dtype=torch.bool, device=device)
    active[::7] = False
    return o, d, active


def hit_agreement(k, p) -> dict:
    """A kernel's hits ``k = (t, id, uv)`` against its plain version's
    ``p``: bitwise equality, the id match, and whether every mismatch is an
    f32 tie (both hit, at distances within 1e-5 relative)."""
    import torch

    (t_k, id_k, uv_k), (t_p, id_p, uv_p) = k, p
    same = id_k == id_p
    ties = ~same
    both = same & (id_k >= 0)
    t_rel = float(((t_k - t_p).abs()[both]
                   / t_p[both].abs().clamp_min(1e-30)).max()) if bool(
        both.any()) else 0.0
    return dict(
        bitwise=(torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
                 and torch.equal(uv_k, uv_p)),
        id_match=float(same.float().mean()), mismatches=int(ties.sum()),
        ties_ok=bool(((id_k[ties] >= 0) & (id_p[ties] >= 0)
                      & ((t_k[ties] - t_p[ties]).abs()
                         <= 1e-5 * t_p[ties].abs())).all()),
        t_max_rel=t_rel)


def require_agreement(what: str, a: dict):
    require(a["bitwise"] or (a["id_match"] >= 0.999 and a["ties_ok"]
                             and a["t_max_rel"] <= 1e-5),
            f"{what}: hits differ from the plain version beyond f32 ties")


def k5_plain(tri, box, o, d, active):
    """K5's plain version with K5's signature: the unculled sweep."""
    import torch
    from psdr_jit_tpu_torch.ops import intersect as ix

    t, ids, u, v = ix.sweep_plain(tri, o.unbind(-1), d.unbind(-1))
    t, ids, u, v = (torch.where(active, x, m)
                    for x, m in zip((t, ids, u, v), ix.miss_like(t)))
    return t, ids, torch.stack([u, v], dim=-1)


def k6_plain(h, o, d, active, stats=None):
    """K6's plain version with K6's signature."""
    from psdr_jit_tpu_torch.ops import bvh

    ids, _, uv, t = bvh.ray_intersect_bvh_plain(h, o, d, active, stats)
    return t, ids, uv


class PlainRoute:
    """Sends K5's and K6's launches to their plain versions, on the card's
    tensors, while active (by replacing the module globals the routing
    calls), so a render can be repeated with only the kernels swapped."""

    def __enter__(self):
        from psdr_jit_tpu_torch.ops import bvh
        from psdr_jit_tpu_torch.ops import intersect as ix

        self.saved = [(ix, "intersect_super_cuda", ix.intersect_super_cuda),
                      (bvh, "bvh_cuda", bvh.bvh_cuda)]
        ix.intersect_super_cuda = k5_plain
        bvh.bvh_cuda = k6_plain
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def intersect_record(name, source, replaces, calls, plain, tests_of,
                     table_bytes):
    """Hold each recorded launch ``(fn, args, (t, id, uv))`` of an
    intersection kernel against its plain version on the same inputs and
    time both: ``(record for the kernels' JSON, agreement, needed tests,
    each launch's ms)``. ``tests_of(args, t)`` counts a launch's needed
    tests, ``table_bytes(args)`` the bytes of the scene it must read."""
    ms = plain_ms = 0.0
    launch_ms = []
    nbytes = flops = 0
    agree = dict(bitwise=True, id_match=1.0, mismatches=0, ties_ok=True,
                 t_max_rel=0.0)
    err = 0.0
    for fn, args, out in calls:
        ref, p_ms = _synced_ms(lambda: plain(*args))
        a = hit_agreement(out, ref)
        agree = dict(bitwise=agree["bitwise"] and a["bitwise"],
                     id_match=min(agree["id_match"], a["id_match"]),
                     mismatches=agree["mismatches"] + a["mismatches"],
                     ties_ok=agree["ties_ok"] and a["ties_ok"],
                     t_max_rel=max(agree["t_max_rel"], a["t_max_rel"]))
        same = (out[1] == ref[1]) & (out[1] >= 0)
        if bool(same.any()):
            err = max(err, float((out[0] - ref[0]).abs()[same].max()))
        launch_ms.append(cuda_ms(lambda: fn(*args), 3))
        ms += launch_ms[-1]
        plain_ms += p_ms
        nbytes += out[0].shape[0] * (RAY_BYTES + 1) + table_bytes(args)
        flops += tests_of(args, out[0]) * TEST_FLOPS
    bound_ms, bound_by = bound(nbytes, flops)
    rec = dict(name=name, route="cuda", source=source, replaces=replaces,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    return rec, agree, flops / TEST_FLOPS, launch_ms


def large_scene_phases(kernels, dev, gen) -> dict:
    """[K5], [K6], [large-64], [main-path-large], [large-frame] and
    [K5-frame]: the large-scene path (renderC of the gallery through the
    general Li, K5 and K6). Returns the K5 and K6 launches of their main
    paths."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    W, H, SPP = LARGE
    n_pix = W * H
    lanes = n_pix * SPP
    integ = pt.PathTracer(LARGE_DEPTH)
    k5_src, k6_src = ("psdr_jit_tpu_torch/csrc/intersect_super.cu",
                      "psdr_jit_tpu_torch/csrc/bvh.cu")
    k5_rep, k6_rep = ("psdr_jit_tpu/ops/intersect_pallas.py:234",
                      "psdr_jit_tpu/ops/bvh.py:309")

    def k5_tests(args, t):
        tab, box, o, d, act = args
        lo, hi = ix.widen_boxes(box[:3].T, box[3:].T)
        return needed_tests(lo, hi, ix.CLUSTER, o, d, t, act)

    def k6_tests(args, t):
        h, o, d, act = args
        return triangle_box_tests(h.tri4[:, 0:3], h.tri4[:, 3:6],
                                  h.tri4[:, 6:9], o, d, t, act)

    def k5_bytes(args):
        return 4 * (args[0].numel() + args[1].numel())

    def k6_bytes(args):
        return TRI_BYTES * args[0].tri4.shape[0]

    def k6_counted(args):
        """K6's own (triangle tests, node visits) for a launch's inputs,
        from its counting build, outside any counted run."""
        c = torch.zeros((args[1].shape[0], 2), dtype=torch.int32,
                        device=dev)
        bvh.bvh_cuda(*args, counts=c)
        return c.sum(0).tolist()

    # ---- [K5]: the 1,292-triangle gallery ----------------------------------
    mid = pt.Scene.from_arrays(gallery_arrays(W, H, SPP, 4, 2), device=dev)
    sd5 = mid.configure()
    f5 = sd5.tri.p0.shape[0]
    require(ix.K1_MAX_TRIS < f5 <= ix.K5_MAX_TRIS, "K5 scene out of range")
    o, d, act = mixed_rays(sd5, CHECK_RAYS, gen, dev)
    tab, box = ix.pack_triangles(sd5.tri.p0, sd5.tri.e1, sd5.tri.e2, ix.SUPER)
    args = (tab, box, o, d, act)
    rec, a, tests, _ = intersect_record(
        "K5", k5_src, k5_rep,
        [(ix.intersect_super_cuda, args, ix.intersect_super_cuda(*args))],
        k5_plain, k5_tests, k5_bytes)
    log("K5", rays=o.shape[0], triangles=f5, bitwise_equal_to_plain=a[
        "bitwise"], id_match=f"{a['id_match']:.6f}",
        mismatches=a["mismatches"], mismatches_are_ties=a["ties_ok"],
        t_max_rel=f"{a['t_max_rel']:.3e}", ms=f"{rec['ms']:.4f}",
        plain_ms=f"{rec['plain_ms']:.4f}",
        tests_per_ray=f"{tests / o.shape[0]:.1f}",
        bound_ms=f"{rec['bound_ms']:.4f}")
    require_agreement("K5", a)

    # ---- [K6]: the 102,412-triangle gallery ----------------------------------
    big = pt.Scene.from_arrays(gallery_arrays(W, H, SPP), device=dev)
    sd6 = big.configure()
    f6 = sd6.tri.p0.shape[0]
    require(f6 > ix.K5_MAX_TRIS, "K6 scene out of range")
    o, d, act = mixed_rays(sd6, CHECK_RAYS, gen, dev)
    torch.cuda.synchronize()
    h, tree_ms = _synced_ms(lambda: sd6.bvh)
    out = bvh.bvh_cuda(h, o, d, act)
    sub = torch.randperm(o.shape[0], generator=gen, device=dev)[:PLAIN_RAYS]
    sub_args = (h, o[sub].contiguous(), d[sub].contiguous(), act[sub])
    stats = {}
    ref, plain_ms = _synced_ms(lambda: k6_plain(*sub_args, stats))
    a = hit_agreement(tuple(x[sub] for x in out), ref)
    # the tie case: equal distances, lowest id, in two visit orders
    tp0, te1, te2, tro, trd, low = (torch.from_numpy(x).to(dev)
                                    for x in tie_case())
    tie_tree = bvh.build_bvh(tp0, te1, te2)
    tie_act = torch.ones(tro.shape[0], dtype=torch.bool, device=dev)
    tie_ref = k6_plain(tie_tree, tro, trd, tie_act)
    tie_ok = all(hit_agreement(bvh.bvh_cuda(tr, tro, trd, tie_act),
                               tie_ref)["bitwise"]
                 for tr in (tie_tree, swapped_children(tie_tree)))
    tie_hits = int((tie_ref[1] == low.to(torch.int32)).sum())
    k6_ms = cuda_ms(lambda: bvh.bvh_cuda(h, o, d, act), 10)
    k6_sub_ms = cuda_ms(lambda: bvh.bvh_cuda(*sub_args), 10)
    tests = k6_tests((h, o, d, act), out[0])
    own_tests, visits = k6_counted((h, o, d, act))
    log("K6", rays=o.shape[0], triangles=f6, leaf=bvh.LEAF, depth=h.depth,
        ptxas=ptxas_report("bvh_kernel"),
        tree_build_ms=f"{tree_ms:.2f}", plain_rays=sub.shape[0],
        bitwise_equal_to_plain=a["bitwise"],
        id_match=f"{a['id_match']:.6f}", mismatches=a["mismatches"],
        mismatches_are_ties=a["ties_ok"], t_max_rel=f"{a['t_max_rel']:.3e}",
        tie_case_bitwise=tie_ok, tie_rays_on_lowest_id=tie_hits,
        ms=f"{k6_ms:.4f}", ms_plain_rays=f"{k6_sub_ms:.4f}",
        plain_ms=f"{plain_ms:.1f}",
        tests_per_ray=f"{own_tests / o.shape[0]:.1f}",
        node_visits_per_ray=f"{visits / o.shape[0]:.1f}",
        needed_tests_per_ray=f"{tests / o.shape[0]:.1f}",
        plain_tests_per_ray=f"{stats['tri_tests'] / sub.shape[0]:.1f}")
    require_agreement("K6", a)
    require(a["bitwise"] and tie_ok, "K6: not bitwise equal to its plain "
            "traversal")
    require(tie_hits > tro.shape[0] // 2, "K6: the tie case has few ties")
    require(int(h.tri4.shape[0]) == f6 and h.depth <= bvh.STACK,
            "K6: the tree does not fit its stack")

    # ---- [large-64]: the kernels against the CPU's plain path ----------------
    imgs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        sc = pt.Scene.from_arrays(gallery_arrays(64, 64, 2, 4, 3),
                                  device=device)
        t0 = time.perf_counter()
        imgs[name] = integ.renderC(sc, 0, seed=SEED).cpu()
        imgs[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    rel64 = rel_l1(imgs["card"], imgs["cpu"])
    log("large-64", triangles=sc.data.tri.p0.shape[0], spp=2,
        depth=LARGE_DEPTH, image_rel_l1=f"{rel64:.3e}",
        bitwise=torch.equal(imgs["card"], imgs["cpu"]),
        ms=f"{imgs['card_ms']:.1f}", plain_cpu_ms=f"{imgs['cpu_ms']:.1f}")
    require(rel64 < 1e-3, "large-64: image differs from the CPU plain path")

    # ---- [main-path-large]: picking and renderC of the headline gallery ------
    chunks = -(-n_pix // max(base.GENERAL_CHUNK_LANES // SPP, 1))
    picks = pixel_center_rays(sd6, W, H, dev)
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        its = big.unit_ray_intersect(picks.o, picks.d)
        img = integ.renderC(big, 0, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    log("main-path-large", **{f"{k}_LAUNCHES": v for k, v in
                              launches.items()}, chunks=chunks,
        picks_hit=f"{its.valid.float().mean().item():.4f}",
        plain_calls=plain.count)
    require(launches["K6"] == (1 + 2 * LARGE_DEPTH) * chunks + 1,
            "large main path: K6 launches != 5 a chunk + 1")
    require(all(v == 0 for k, v in launches.items() if k != "K6"),
            "large main path: another kernel ran")
    require(plain.count == 0, "large main path: a plain version ran")
    require(tuple(img.shape) == (n_pix, 3), "large renderC: wrong shape")
    require(bool(torch.isfinite(img).all()), "large renderC: non-finite")
    require(float(img.abs().sum()) > 0, "large renderC: black image")
    rows = torch.arange(H // 2 * W, (H // 2 + 2) * W, device=dev)
    crop_exact = torch.equal(integ.renderC(big, 0, seed=SEED, pix_id=rows),
                             img[rows])
    require(crop_exact, "large renderC: crop rows differ from the frame")

    # ---- [large-frame]: every K6 launch of a frame against its plain version -
    with KernelCalls({"K6": (bvh, "bvh_cuda")}) as rec_calls:
        integ.renderC(big, 0, seed=SEED)
        torch.cuda.synchronize()
    calls = rec_calls.calls["K6"]
    require(len(calls) == (1 + 2 * LARGE_DEPTH) * chunks,
            "large-frame: K6 launches != 5 a chunk")
    k6, a, tests, k6_launch_ms = intersect_record(
        "K6 tree traversal", k6_src, k6_rep, calls, k6_plain, k6_tests,
        k6_bytes)
    require_agreement("large-frame", a)
    require(a["bitwise"], "large-frame: K6 not bitwise equal to its plain "
            "traversal")
    own = [sum(x) for x in zip(*(k6_counted(c[1]) for c in calls))]
    frame_ms = wall_ms(lambda: integ.renderC(big, 0, seed=SEED), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(big, 0, seed=SEED)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    wide = pt.Scene.from_arrays(gallery_arrays(*WIDE), device=dev)
    wide.configure()
    wide_ms = wall_ms(lambda: integ.renderC(wide, 0, seed=SEED), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(wide, 0, seed=SEED)
    wide_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    rays = lanes * (1 + 2 * LARGE_DEPTH)
    n_rays = sum(c[2][0].shape[0] for c in calls)
    log("large-frame", size=f"{W}x{H}", spp=SPP, depth=LARGE_DEPTH,
        K6_launches=len(calls), bitwise_equal_to_plain=a["bitwise"],
        mismatches=a["mismatches"], mismatches_are_ties=a["ties_ok"],
        K6_ms=f"{k6['ms']:.3f}",
        K6_launch_ms=",".join(f"{x:.3f}" for x in k6_launch_ms),
        K6_plain_ms=f"{k6['plain_ms']:.1f}",
        K6_bound_ms=f"{k6['bound_ms']:.4f}", K6_bound_by=k6["bound_by"],
        tests_per_ray=f"{own[0] / n_rays:.1f}",
        node_visits_per_ray=f"{own[1] / n_rays:.1f}",
        needed_tests_per_ray=f"{tests / n_rays:.1f}",
        ms=f"{frame_ms:.2f}", mrays_per_s=f"{rays / frame_ms / 1e3:.1f}",
        peak_gb=f"{peak_gb:.3f}", mean=f"{img.mean().item():.6f}",
        wide=f"{WIDE[0]}x{WIDE[1]}spp{WIDE[2]}", wide_ms=f"{wide_ms:.2f}",
        wide_peak_gb=f"{wide_peak:.3f}")
    kernels["K6"] = k6

    # ---- [K5-frame]: renderC of the 1,292-triangle gallery through K5 --------
    torch.cuda.synchronize()
    with PlainCalls() as plain, KernelCalls(
            {"K5": (ix, "intersect_super_cuda")}) as rec_calls:
        _cuda.reset_launches()
        img5 = integ.renderC(mid, 0, seed=SEED)
        torch.cuda.synchronize()
        launches5 = dict(_cuda.LAUNCHES)
    with PlainRoute():
        img5_plain = integ.renderC(mid, 0, seed=SEED)
    k5, a, tests, _ = intersect_record(
        "K5 streamed super-block sweep", k5_src, k5_rep,
        rec_calls.calls["K5"], k5_plain, k5_tests, k5_bytes)
    k5_frame_ms = wall_ms(lambda: integ.renderC(mid, 0, seed=SEED), 3)
    log("K5-frame", triangles=f5, K5_LAUNCHES=launches5["K5"],
        chunks=chunks, plain_calls=plain.count,
        bitwise_equal_to_plain_render=torch.equal(img5, img5_plain),
        image_rel_l1_vs_plain=f"{rel_l1(img5, img5_plain):.3e}",
        launches_bitwise=a["bitwise"], K5_ms=f"{k5['ms']:.3f}",
        K5_plain_ms=f"{k5['plain_ms']:.1f}",
        K5_bound_ms=f"{k5['bound_ms']:.4f}", K5_bound_by=k5["bound_by"],
        ms=f"{k5_frame_ms:.2f}")
    require(launches5["K5"] == (1 + 2 * LARGE_DEPTH) * chunks,
            "K5-frame: K5 launches != 5 a chunk")
    require(all(v == 0 for k, v in launches5.items() if k != "K5"),
            "K5-frame: another kernel ran")
    require(plain.count == 0, "K5-frame: a plain version ran")
    require(bool(torch.isfinite(img5).all()) and float(img5.sum()) > 0,
            "K5-frame: non-finite or black image")
    require(rel_l1(img5, img5_plain) < 1e-6,
            "K5-frame: the render differs from its plain-version render")
    require_agreement("K5-frame", a)
    kernels["K5"] = k5
    return {"K5": launches5["K5"], "K6": launches["K6"]}


def train_step_fn(integrator, scene):
    """A closure that takes one training step on ``scene``."""
    params, apply_params, pixel_loss = train_setup(scene)
    return lambda: integrator.loss_and_grad(scene, params, apply_params,
                                            pixel_loss, 0, SEED)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "psdr_jit_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(psdr_jit_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.integrator.base import (CHUNK_LANES,
                                                    interior_lane_setup)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    kernels = {}

    # ---- 1. card and build ------------------------------------------------
    log("card", nvidia_smi=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = (lib_path.parent / "ptxas.txt").read_text()
    regs = [ln.strip() for ln in ptxas.splitlines()
            if "registers" in ln or "spill" in ln]
    log("build", seconds=f"{build_s:.2f}", lib=lib_path.relative_to(ROOT))
    for ln in regs:
        print(f"[build] ptxas: {ln}")

    arrays = np.load(SCENE_NPZ)
    scene = pt.Scene.from_arrays(arrays, device=dev)
    W, H, SPP = scene.opts.width, scene.opts.height, scene.opts.spp
    require((W, H, SPP) == FRAME, f"{SCENE_NPZ.name} holds the {FRAME} frame")
    n_pix = W * H
    sd = scene.configure()
    tri = sd.tri
    tables = mk.build_tables(sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 2. K1 vs plain ---------------------------------------------------
    picks = pixel_center_rays(sd, W, H, dev)
    _, sampler, samples = interior_lane_setup(
        W, H, 2, SEED, torch.arange(n_pix, device=dev))
    cam = sd.sensors[0].sample_primary_ray(samples)
    po, pd = on_plane_rays(tables[1], 1 << 18, gen, dev)
    lo, hi = sd.lower, sd.upper
    ro = lo + (hi - lo) * torch.rand((1 << 17, 3), generator=gen, device=dev)
    rd = torch.nn.functional.normalize(
        torch.randn((1 << 17, 3), generator=gen, device=dev), dim=-1)
    o1 = torch.cat([picks.o, cam.o, po, ro]).contiguous()
    d1 = torch.cat([picks.d, cam.d, pd, rd]).contiguous()
    n1 = o1.shape[0]
    tri_tab, box_tab = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
    t_c, id_c, uv_c = ix.intersect_cuda(tri_tab, box_tab, o1, d1)
    id_p, _, uv_p, t_p = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2,
                                                 o1, d1)
    torch.cuda.synchronize()
    # the plain sweep visits every triangle: equal bits mean K1's per-ray
    # cluster culling changed no hit
    bitwise = (torch.equal(t_c, t_p) and torch.equal(id_c, id_p)
               and torch.equal(uv_c, uv_p))
    same = id_c == id_p
    both = same & (id_c >= 0)
    t_err = (t_c - t_p).abs()[both]
    t_rel = (t_err / t_p[both].abs()).max().item()
    ties = ~same
    # a mismatch must be a tie: both hit, at the same distance
    tie_ok = bool(((id_c[ties] >= 0) & (id_p[ties] >= 0)
                   & ((t_c[ties] - t_p[ties]).abs()
                      <= 1e-5 * t_p[ties].abs())).all())
    match = same.float().mean().item()
    k1_ms_main = cuda_ms(lambda: ix.intersect_cuda(
        tri_tab, box_tab, picks.o.contiguous(), picks.d.contiguous()), 50)
    k1_ms = cuda_ms(lambda: ix.intersect_cuda(tri_tab, box_tab, o1, d1), 20)
    k1_plain_ms = cuda_ms(lambda: ix.ray_intersect_brute(
        tri.p0, tri.e1, tri.e2, o1, d1), 5)
    log("K1", rays=n1, bitwise_equal_to_plain=bitwise,
        id_match=f"{match:.6f}", mismatches=int(ties.sum()),
        mismatches_are_ties=tie_ok, t_max_rel=f"{t_rel:.3e}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
        ms_pick_rays=f"{k1_ms_main:.4f}")
    require(match >= 0.999 and tie_ok, "K1: ids differ beyond f32 ties")
    require(t_rel <= 1e-5, "K1: t differs beyond rtol 1e-5")
    lo, hi = ix.widen_boxes(box_tab[:3].T, box_tab[3:].T)
    k1_bound = bound(n1 * RAY_BYTES + 4 * (tri_tab.numel() + box_tab.numel()),
                     needed_tests(lo, hi, ix.CLUSTER, o1, d1, t_c)
                     * TEST_FLOPS)
    kernels["K1"] = dict(
        name="K1 closest-hit sweep", route="cuda",
        source="psdr_jit_tpu_torch/csrc/intersect.cu",
        replaces="psdr_jit_tpu/ops/intersect_pallas.py:267",
        max_abs_err=float(t_err.max()) if t_err.numel() else 0.0,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound[0],
        bound_by=k1_bound[1], library_ms=None)

    # ---- 3. K2 vs plain on a 4096-pixel crop of the frame ------------------
    crop = torch.arange(H // 2 * W, (H // 2 + 8) * W, device=dev)
    m, sampler, samples = interior_lane_setup(W, H, SPP, SEED, crop)
    ray = sd.sensors[0].sample_primary_ray(samples)
    o2, d2 = ray.o.contiguous(), ray.d.contiguous()
    act = torch.ones(o2.shape[0], dtype=torch.bool, device=dev)
    args = (*tables, o2, d2, act, sampler.lane, sampler.seed_value, DEPTH,
            sampler.cnt)
    li_k = mk.li_mega_cuda(*args)
    li_p = mk.li_mega_plain(*args)
    torch.cuda.synchronize()
    k2_rel = rel_l1(li_k, li_p)
    k2_err = float((li_k - li_p).abs().max())
    k2_crop_ms = cuda_ms(lambda: mk.li_mega_cuda(*args), 20)
    k2_crop_plain_ms = cuda_ms(lambda: mk.li_mega_plain(*args), 3)
    log("K2", lanes=o2.shape[0], depth=DEPTH, rel_l1=f"{k2_rel:.3e}",
        max_abs_err=f"{k2_err:.3e}", finite=bool(torch.isfinite(li_k).all()),
        ms=f"{k2_crop_ms:.4f}", plain_ms=f"{k2_crop_plain_ms:.4f}")
    require(bool(torch.isfinite(li_k).all()), "K2: non-finite radiance")
    require(k2_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3")

    # K2 alone at the frame's shape, each renderC chunk's launch, against
    # its plain version on the same inputs
    step = CHUNK_LANES // SPP
    k2_frame_ms = k2_frame_plain_ms = 0.0
    frame_err = frame_diff = frame_ref = 0.0
    k2_bytes = k2_flops = 0
    for s in range(0, n_pix, step):
        m, sampler, samples = interior_lane_setup(
            W, H, SPP, SEED, torch.arange(s, min(s + step, n_pix),
                                          device=dev))
        ray = sd.sensors[0].sample_primary_ray(samples)
        args = (*tables, ray.o.contiguous(), ray.d.contiguous(),
                torch.ones(m * SPP, dtype=torch.bool, device=dev),
                sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
        li_p = mk.li_mega_plain(*args)
        diff = (mk.li_mega_cuda(*args) - li_p).abs()
        frame_err = max(frame_err, float(diff.max()))
        frame_diff += float(diff.sum())
        frame_ref += float(li_p.abs().sum())
        k2_frame_ms += cuda_ms(lambda: mk.li_mega_cuda(*args), 5)
        k2_frame_plain_ms += cuda_ms(lambda: mk.li_mega_plain(*args), 1)
        # the camera sweep's tests; the 2 DEPTH inner sweeps' rays are the
        # kernel's own and are not counted
        k2_bytes += m * SPP * (29 + 12)
        k2_flops += (camera_tests(*tables[:2], *args[5:8]) * TEST_FLOPS
                     + m * SPP * DEPTH * SHADE_FLOPS)
    frame_rel = frame_diff / max(frame_ref, 1e-30)
    log("K2-frame", lanes=n_pix * SPP, rel_l1=f"{frame_rel:.3e}",
        max_abs_err=f"{frame_err:.3e}", ms=f"{k2_frame_ms:.3f}",
        plain_ms=f"{k2_frame_plain_ms:.3f}")
    require(frame_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3 on the frame")
    k2_bound = bound(k2_bytes, k2_flops)
    kernels["K2"] = dict(
        name="K2 detached Li megakernel", route="cuda",
        source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:591",
        max_abs_err=max(k2_err, frame_err), ms=k2_frame_ms,
        plain_ms=k2_frame_plain_ms, bound_ms=k2_bound[0],
        bound_by=k2_bound[1], library_ms=None)

    # ---- 3b. K2 pair and stash, K3, K4 vs plain on 131,072-lane crops ------
    edge_scene = pt.Scene.from_arrays(arrays, device=dev)
    edge_scene.opts.sppe = SPPE
    train_kernel_phases(sd, edge_scene.configure(), tables, dev, gen, kernels)

    # ---- 4. golden 32x32 render ---------------------------------------------
    small = pt.Scene.from_arrays(arrays, device=dev)
    small.opts = pt.RenderOption(32, 32, 4, 0, 0)
    img32 = pt.PathTracer(2).renderC(small, 0, seed=0).cpu().numpy()
    golden = np.load(GOLDEN)
    g_rel = float(np.abs(img32 - golden).sum() / np.abs(golden).sum())
    g_frac = float((np.abs(img32 - golden).max(-1) > 1e-3).mean())
    log("golden", rel_l1=f"{g_rel:.3e}", frac_pixels_off=f"{g_frac:.4f}")
    require(g_rel < 5e-3 and g_frac < 0.1, "golden: 32x32 render off")

    # ---- 5. the main path at full size -------------------------------------
    integrator = pt.PathTracer(DEPTH)
    n_chunks = -(-n_pix // (CHUNK_LANES // SPP))
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        its = scene.unit_ray_intersect(picks.o, picks.d)
        img = integrator.renderC(scene, 0, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    log("main-path", K1_LAUNCHES=launches["K1"], K2_LAUNCHES=launches["K2"],
        chunks=n_chunks, picks_hit=f"{its.valid.float().mean().item():.4f}",
        plain_calls=plain.count)
    require(launches["K1"] == 1, "main path: K1 was not launched once")
    require(launches["K2"] == n_chunks, "main path: K2 launches != chunks")
    require(plain.count == 0, "main path: a plain version ran")
    require(tuple(img.shape) == (n_pix, 3), "renderC: wrong shape")
    require(bool(torch.isfinite(img).all()), "renderC: non-finite pixels")
    require(float(img.abs().sum()) > 0, "renderC: black image")
    require(its.valid.float().mean().item() > 0.5,
            "picking: most pixel rays missed the box")

    img_plain = render_plain(sd, scene.opts, SEED, DEPTH, CHUNK_LANES)
    f_rel = rel_l1(img, img_plain)
    rows = torch.arange(H // 4 * W, (H // 4 + 1) * W, device=dev)
    crop_img = integrator.renderC(scene, 0, seed=SEED, pix_id=rows)
    crop_exact = torch.equal(crop_img, img[rows])
    render_ms = wall_ms(lambda: integrator.renderC(scene, 0, seed=SEED), 5)
    plain_ms = wall_ms(lambda: render_plain(
        sd, scene.opts, SEED, DEPTH, CHUNK_LANES), 3)
    rays = n_pix * SPP * (1 + 2 * DEPTH)
    log("frame", mean=f"{img.mean().item():.6f}", rel_l1_vs_plain=f"{f_rel:.3e}",
        crop_bitwise=crop_exact, ms=f"{render_ms:.2f}",
        plain_ms=f"{plain_ms:.2f}",
        mrays_per_s=f"{rays / render_ms / 1e3:.1f}",
        plain_mrays_per_s=f"{rays / plain_ms / 1e3:.1f}")
    require(f_rel < 1e-3, "frame: rel L1 vs the plain path >= 1e-3")
    require(crop_exact, "frame: crop rows differ from the full frame")

    # ---- 6. a 64x64 training step: the kernels against the plain path -------
    steps = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        small = pt.Scene.from_arrays(arrays, device=device)
        small.opts = pt.RenderOption(64, 64, 8, 8, 0)
        step = train_step_fn(integrator, small)
        t0 = time.perf_counter()
        steps[name] = [x if isinstance(x, dict) else x.cpu()
                       for x in step()]
        steps[name][1] = {k: v.cpu() for k, v in steps[name][1].items()}
        steps[name].append((time.perf_counter() - t0) * 1e3)
    (loss_k, g_k, img_k, ms_k), (loss_p, g_p, img_p, ms_p) = (
        steps["kernels"], steps["plain"])
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    img_rel = rel_l1(img_k, img_p)
    g_rel = {k: rel_l1(g_k[k], g_p[k]) for k in g_p}
    log("train-64", spp=8, sppe=8, depth=DEPTH, loss_rel=f"{loss_rel:.3e}",
        image_rel_l1=f"{img_rel:.3e}",
        grad_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in g_rel.items()),
        ms=f"{ms_k:.1f}", plain_cpu_ms=f"{ms_p:.1f}")
    require(loss_rel < 1e-4 and img_rel < 1e-4,
            "train-64: loss or image differs from the plain path")
    require(all(v < 1e-3 for v in g_rel.values()),
            "train-64: a gradient differs from the plain path by >= 1e-3")
    require(all(float(g.abs().sum()) > 0 for g in g_p.values()),
            "train-64: a parameter got no gradient")

    # ---- 7. the training main path at full size -----------------------------
    train_scene = pt.Scene.from_arrays(arrays, device=dev)
    train_scene.opts.sppe = SPPE
    step = train_step_fn(integrator, train_scene)
    train_frame_phase(step, kernels)
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        loss, grads, img_t = step()
        torch.cuda.synchronize()
        launches_t = dict(_cuda.LAUNCHES)
    log("main-path-train", **{f"{k}_LAUNCHES": v for k, v in
                              launches_t.items()},
        plain_calls=plain.count)
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        require(launches_t[k] > 0, f"training main path: {k} not launched")
    require(plain.count == 0, "training main path: a plain version ran")
    require(launches_t["K2-stash"] == launches_t["K3"] == launches_t["K4"],
            "training main path: stash, K3 and K4 launches differ")
    require(tuple(img_t.shape) == (n_pix, 3), "train: wrong image shape")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values()),
        "train: non-finite loss or gradient")
    require(all(float(g.abs().sum()) > 0 for g in grads.values()),
            "train: a parameter got no gradient")
    # the step's image is the attached Li (K3 over K2-stash's hits): the
    # frame's radiance up to the stash's bilinear bounce origins
    t_rel = rel_l1(img_t, img)
    require(t_rel < 1e-3, "train: image differs from renderC's frame")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log("train", size=f"{W}x{H}", spp=SPP, sppe=SPPE, depth=DEPTH,
        loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        image_rel_l1_vs_frame=f"{t_rel:.3e}", step_ms=f"{step_ms:.2f}",
        peak_gb=f"{peak_gb:.3f}")

    # ---- 8. the large-scene path --------------------------------------------
    launches_l = large_scene_phases(kernels, dev, gen)

    record = {"kernels": (
        [{**kernels[k], "launches": launches[k]} for k in ("K1", "K2")]
        + [{**kernels[k], "launches": launches_t[k]}
           for k in ("K2-pair", "K2-stash", "K3", "K4")]
        + [{**kernels[k], "launches": launches_l[k]} for k in ("K5", "K6")])}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
