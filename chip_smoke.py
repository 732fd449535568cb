#!/usr/bin/env python3
"""On-card smoke run of psdr_jit_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Builds the port's kernels from ``psdr_jit_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (K1, the
tree walk on a tree split by surface area, on each of its ray families at
32 and 492 triangles, with and without dead lanes, and on exact ties; K2 in
its single, pair and stash modes, also at the 172 triangles of a small
gallery and on exact ties through both of its sweeps; K3, the attached
shade; K4, its adjoint; K5, the same walk at 513 to 4,096 triangles, also
at the top of its range and on exact ties; K6, the same walk on a tree
split at the middle; K7, the hit rebuilt from K1's payload in path and
solid mode, bit for bit, with its tangent and adjoint), checks a
32x32 render against ``tests/golden_cbox32.npy``, then drives the main
paths at full size as a user would, each with the launch counts set to 0
just before it and read just after:

* serving the Cornell box of ``tests/data/cbox_scene.npz``: a picking
  query (``Scene.unit_ray_intersect``, K1) and a frame (``renderC``, K2)
  at 512x512, spp 32, ``PathTracer(3)``;
* training on it: one step of ``PathTracer(3).loss_and_grad`` at 512x512,
  spp 32, sppe 32, sppse 32 (interior term through K2 stash, K3 and K4;
  primary-edge term through K2 pair; secondary-edge term with its
  visibility, receiver and camera rays through K1), with gradients to a
  light translation, the tall block's vertex offsets, a reflectance and
  the radiance; then the same step guided by a table that
  ``preprocess_secondary_edges`` builds on the card;
* differentiating a render of it: ``PathTracer(3).renderD`` at the same
  size (the interior term through the attached general Li and K1; the
  primary-edge term through K2 pair; the secondary-edge term through K1)
  in forward mode along the light's translation and the radiance's scale,
  and in reverse mode for the four parameters, held to the forward
  tangent (the adjoint identity), to renderC's frame and to
  ``loss_and_grad``; and a renderD of the 1,292-triangle gallery through
  K5;
* serving a large scene, the procedural gallery of ``gallery_arrays``
  (102,412 triangles): a picking query and a frame at 256x256, spp 4,
  ``PathTracer(2)``, through the general Li and K6; and the same frame of
  the 1,292-triangle gallery through K5 and of the 492-triangle gallery
  through K1;
* BASELINE config #3, a Microfacet mesh under a lat-long environment map,
  on the stand-in assets of ``envmap_arrays`` (5,132 triangles with the
  map's bounding box, a 512x1024 map whose 2,091,012-cell importance
  table samples by alias rows): a frame at 128x128, spp 32,
  ``PathTracer(1)``; a training step at spp, sppe and sppse 32, guided,
  with gradients to the vertex offsets and the radiance texture; and the
  three per-term forward-mode renderDs along the mesh's translation,
  every intersection through K6;
* BASELINE config #5, the room of ``room_arrays`` (14 meshes, 108
  triangles, diffuse, Microfacet and rough-conductor materials): a frame,
  a target, four Adam steps on a box's pose and the light's gain, a
  training step with a pose, vertex and radiance gradients, and renderD
  in both modes, at 512x512, spp, sppe and sppse 32, ``PathTracer(2)``,
  every intersection through K1; and K1 alone on the frame's and the
  secondary-edge pass's rays;
* scenes loaded from files: the port's host library built and its EXR
  (ZIP, PIZ) and OBJ readers held bitwise; BASELINE config #2 written as
  ``cbox.xml`` and eight OBJ files and loaded with ``pt.load_file``, and
  config #3's stand-in as XML, OBJ and a PIZ EXR: their frames, steps
  (and the box's renderD) with the in-memory scenes' launches, frames and
  losses bitwise; and the box seen by an intrinsic camera;
* the other integrators: ``Direct(2)`` on the box training cell (a frame,
  a step, a forward renderD), the collocated light (a frame, a reverse
  renderD) and the eight fields of ``FieldExtractionIntegrator`` on the
  two galleries and the room, through K1, K5 and K6; reverse renderD of
  the box and the room without the checkpoint policy, with it and under
  path replay (``PSDR_REMAT=prb``), no hit kernel in the backward sweep
  of the last two; and the room's guided training step sharded over two
  gloo ranks spawned on the one card and over one NCCL rank
  (``parallel.make_fused_train_step``, ``render_sharded``), against the
  unsharded step;
* the reference-compatible surface: the smoke checks (``optix_jit_test``
  through K1), ``unit_ray_intersectAD``, renderD along a
  ``set_transform`` translation, ``configure(active_sensors)`` on
  BASELINE config #4's four-sensor box; then every example of
  ``examples/torch_*.py`` at its default size, the two multi-process ones
  as gloo ranks sharing the card.

64x64 training steps of the box (sppse 0, sppse 8, and sppse 8 guided by
one table on both sides), a 64x64 renderD of the box (forward and reverse
mode) and of the 1,292-triangle gallery (forward mode), a 64x64 frame
of the 5,132-triangle gallery, and a 64x64 frame, guided step and renderD
of the envmap stand-in, 64x64 frames and steps of the Cornell box with
each of the rough conductor, rough dielectric, per-vertex Microfacet and
normal-map BSDFs (``bsdf_cbox_arrays``) and of the room, and 64x64
frames of every new integrator (with a step and a reverse renderD of
``Direct(2)`` and the collocated light), run through the
kernels and, on the CPU, through the plain versions, and the two must
agree. One training step of the box
and of the envmap stand-in and one gallery frame run with every launch
recorded, and each launch is held against its plain version on the
inputs it was given; so do K1's launches in the first chunk of the box
step's secondary-edge pass. Kernels,
frames and step are timed against their plain versions, and each
kernel's least possible time on an H100 (its bound) is computed from its
inputs.

Every phase prints one line; any failure exits non-zero without the final
line. The last two lines are the card (``nvidia-smi`` name and power limit)
and ``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record. Exits non-zero when no CUDA card is visible. Imports no JAX.
"""

from __future__ import annotations

import functools
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
SPPSE = 32  # secondary-edge samples per pixel of the training step
# [train-guided]: the guiding grid (3 axes, samples a cell); 4,096 cells,
# above the 2,048 of a searched table, so its cells sample by alias rows
GUIDE_RESO = (16, 16, 16, 4)
# [train]: the least rel L1 by which the secondary-edge term must move the
# translation and vertex-offset gradients against the sppse-0 step. On an
# H100 (700 W) the term moves them by 7.2e-3 and 0.292; the float atomics
# of the step's backward move them from one run to the next by the
# run-to-run spread that [train] logs beside them (PERF.md)
SE_MOVED_MIN = {"tx": 1e-4, "dv": 0.05}
# [renderD]: the bound on each reverse gradient of sum(w * renderD)
# against loss_and_grad's of the same linear loss (rel L1). Their interior
# routes differ (K3 over K2-stash's hits, whose bounce origins are o + t d,
# against the attached general Li's bilinear hit points), which flips a few
# grazing lanes: at 64x64 spp 8 sppe 8 sppse 8 on the CPU the two differed
# by at most 4.3e-3 (tx), 6.9e-3 (dv), 1.8e-3 (alb), 2.4e-4 (rad) over
# seeds 0 and 1 (PERF.md)
RENDERD_FUSED_RTOL = {"tx": 1e-2, "dv": 2e-2, "alb": 1e-2, "rad": 1e-3}
SEED = 0
DEPTH = 3
# the large-scene path: gallery_arrays() at 256x256, spp 4, PathTracer(2)
LARGE = (256, 256, 4)
LARGE_DEPTH = 2
WIDE = (512, 512, 8)  # the same scene's larger frame, timed only
CHECK_RAYS = 1 << 18  # rays of the [K5] and [K6] checks
# the envmap path, BASELINE config #3 (bench.py _time_envmap) on the
# stand-in of envmap_arrays(): width, height and spp = sppe = sppse of the
# frame and the step, PathTracer(1), the guiding grid, and the three
# per-term renderDs (spp, sppe, sppse) of the tutorial's gradient images
ENVMAP = (128, 128, 32)
ENVMAP_DEPTH = 1
ENVMAP_GUIDE = (2000, 5, 5, 32)
ENVMAP_TERMS = ((128, 0, 0), (0, 128, 0), (0, 0, 128))
# [envmap-64]: the guiding grid (8,192 cells, so alias rows and their coin)
ENVMAP_GUIDE_64 = (128, 4, 4, 4)
# the textured path, BASELINE config #4 (texture and radiance recovery) on
# the UV-mapped box of textured_cbox_arrays(): width, height and spp =
# sppe = sppse, PathTracer(3), the albedo and block texture sizes, the
# Adam steps (one sensor each, in turn) and their learning rate
TEXTURED = (512, 512, 32)
TEXTURED_DEPTH = 3
TEXTURED_TEX = (1024, 512)
TEXTURED_STEPS = 4
TEXTURED_LR = 0.05
# the gallery training step (bench.py _time_bvh_grad): 80 spheres at
# subdivision 3 (102,412 triangles) at 256x256, spp = sppe = sppse 4,
# PathTracer(2), gradients to the first sphere's vertices and the radiance
GALLERY_STEP = (256, 256, 4, 80, 3)
GALLERY_STEP_DEPTH = 2
# cycles the card spins in cuda_ms while the host queues the timed calls
# (~5 ms on an H100)
HOLD_CYCLES = 10_000_000
PLAIN_RAYS = 1 << 16  # of them, the rays [K6] holds against the plain K6


def log(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up.
    The card first spins (``torch.cuda._sleep``) while the host queues the
    calls, so that they run back to back: a call shorter than its host
    overhead (a Python wrapper's tens of microseconds) is timed on the
    card, not on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
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


def edge_rays(sd, n: int, gen, device, dead: float = 0.43):
    """``(o, d, active)``: a stand-in for the rays of the secondary-edge
    term (K1's family (e), held beside the real rays in ``[SE-K1]``).
    ``n // 2`` points, each drawn
    uniformly on a uniformly chosen edge of a uniformly chosen triangle,
    each with a uniform direction, laid out as the JAX package's
    double-width call (``integrator/edge.py``): the rays ``(p, d)``, then
    ``(p, -d)``; each point's two rays are inactive with probability
    ``dead`` (43%: 57% of the Cornell box's boundary samples are valid,
    ``edge.py``)."""
    import torch

    q = n // 2
    tri = sd.tri
    j = torch.randint(0, tri.p0.shape[0], (q,), generator=gen, device=device)
    k = torch.randint(0, 3, (q,), generator=gen, device=device)
    p0 = tri.p0[j]
    v = torch.stack([p0, p0 + tri.e1[j], p0 + tri.e2[j]], 1)  # (q, 3, 3)
    rows = torch.arange(q, device=device)
    a, b = v[rows, k], v[rows, (k + 1) % 3]
    s = torch.rand((q, 1), generator=gen, device=device)
    p = a + (b - a) * s
    dirs = torch.nn.functional.normalize(
        torch.randn((q, 3), generator=gen, device=device), dim=-1)
    valid = torch.rand(q, generator=gen, device=device) >= dead
    return (torch.cat([p, p]).contiguous(), torch.cat([dirs, -dirs]),
            torch.cat([valid, valid]))


# K1's ray families: (a)-(d) make the 1,179,648-ray check set of [K1]; (e)
# stands in for the secondary-edge rays ([SE-K1] times the real ones)
K1_FAMILIES = ("picks", "camera", "on_plane", "random", "edge")
# the largest gallery K1 takes (492 triangles), routed through the general Li
K1_GALLERY = dict(width=256, height=256, spp=4, n_spheres=6, subdiv=1)


def k1_families(sd, gen, device) -> dict:
    """``{name: (o, d, active)}`` of K1's ray families (``K1_FAMILIES``) at
    the scene data ``sd``: (a) the 262,144 pixel-centre picks of a 512x512
    frame, (b) its 524,288 spp-2 camera rays, (c) 262,144 axis-aligned rays
    on cluster-box planes (``on_plane_rays``), (d) 131,072 random rays in
    the scene's box, all active; (e) 262,144 secondary-edge stand-ins
    (``edge_rays``), 43% inactive."""
    import torch
    from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
    from psdr_jit_tpu_torch.ops import intersect as ix

    w = h = 512
    picks = pixel_center_rays(sd, w, h, device)
    _, _, samples = interior_lane_setup(
        w, h, 2, SEED, torch.arange(w * h, device=device))
    cam = sd.sensors[0].sample_primary_ray(samples)
    _, box = ix.pack_triangles(sd.tri.p0, sd.tri.e1, sd.tri.e2)
    po, pd = on_plane_rays(box, 1 << 18, gen, device)
    lo, hi = sd.lower, sd.upper
    ro = lo + (hi - lo) * torch.rand((1 << 17, 3), generator=gen,
                                     device=device)
    rd = torch.nn.functional.normalize(
        torch.randn((1 << 17, 3), generator=gen, device=device), dim=-1)
    out = {}
    for name, o, d in (("picks", picks.o, picks.d), ("camera", cam.o, cam.d),
                       ("on_plane", po, pd), ("random", ro, rd)):
        out[name] = (o.reshape(-1, 3).contiguous(),
                     d.reshape(-1, 3).contiguous(),
                     torch.ones(o.shape[0], dtype=torch.bool, device=device))
    out["edge"] = edge_rays(sd, 1 << 18, gen, device)
    return out


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
    ``ptxas.txt``), as ``"<template arguments>:<registers>r/<stack>B/<spill
    stores>+<spill loads>B"`` joined by commas (the arguments joined by
    ``-``, ``-`` alone for none)."""
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
            args = re.search(kernel + r"I((?:L\w\d+E)+)E", name)
            args = ("-".join(re.findall(r"L\w(\d+)E", args.group(1)))
                    if args else "-")
            out.append(f"{args}:{m.group(1)}r/"
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


def triangle_box_tests(p0, e1, e2, o, d, t, active=None,
                       cluster: int = 64) -> int:
    """The (ray, triangle) tests any hierarchy of boxes over these
    triangles must make: for each ray, the triangles whose own widened box
    (``widen_boxes``) its slab test enters before its closest hit ``t``.
    Counted exactly, but only inside the ``cluster``-triangle runs of
    consecutive ids whose box (the union of theirs) the ray enters, which
    contain those triangle boxes. It depends on the rays, their hits and
    the triangles, not on the kernel's hierarchy. Rays go in chunks of
    about 2**21 ray-cluster pairs (at least 4,096 rays)."""
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
    chunk = max(1 << 12, (1 << 21) // nc)
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


def hit_bound_terms(p0, e1, e2, o, d, t, active=None):
    """``(bytes, operations, tests)`` of one closest-hit launch for its
    bound, whatever kernel computes it (K1, K5, K6): the rays in and the
    hits out (``RAY_BYTES``, and a byte for the active flag where the
    launch reads one: K5 and K6, not K1) and ``TRI_BYTES`` a triangle,
    each once, and ``TEST_FLOPS`` for each test that any hierarchy of
    boxes must make (``triangle_box_tests``)."""
    tests = triangle_box_tests(p0, e1, e2, o, d, t, active)
    ray_bytes = RAY_BYTES + (active is not None)
    return (o.shape[0] * ray_bytes + TRI_BYTES * p0.shape[0],
            tests * TEST_FLOPS, tests)


def k2_bound_terms(args, record, pair: bool, stash: bool):
    """``(bytes, operations, tests)`` of one K2 launch for its bound: the
    lanes' inputs and outputs (rays, active, lane, Li, in stash mode the hits)
    and the tables, each once; the tests that any hierarchy of boxes needs
    (``triangle_box_tests``) for every sweep the launch outputs (``record``,
    the plain version's ``Sweep`` list of the same launch: every lane in
    stash mode, the lanes whose result is used in single and pair mode,
    both rays in pair mode); and ``SHADE_FLOPS`` a depth for each path
    that sweeps at that depth by the same rule (every lane in stash mode,
    whose hits at every depth are output; else the lanes whose NEE or
    bounce sweep of the depth is used). ``tests``, the needed tests, are
    those of ``len(record)`` sweeps of ``n`` lanes each; K2's own tests
    come from its counting build (``scripts/torch_kernel_variants.py``)."""
    tri = args[0]
    n = args[5].shape[0]
    per_path = len(record) // (2 if pair else 1)
    depth = (per_path - 1) // 2
    nbytes = (n * ((48 if pair else 24) + 1 + 4 + 12
                   + (12 * (1 + 2 * depth) if stash else 0))
              + 4 * sum(int(t.numel()) for t in args[:5]))
    p0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    tests = sum(triangle_box_tests(p0, e1, e2, s.o, s.d, s.t,
                                   None if stash else s.active)
                for s in record)
    shaded = 0
    for first in range(0, len(record), per_path):
        for k in range(depth):
            nee, bounce = record[first + 1 + 2 * k], record[first + 2 + 2 * k]
            shaded += n if stash else int((nee.active | bounce.active).sum())
    return nbytes, tests * TEST_FLOPS + shaded * SHADE_FLOPS, tests


def stash_agreement(tri, hits, hits_p, record) -> dict:
    """K2's stashed hits ``(ids, u, v)`` against its plain version's:
    ``ids_off``, the hits on another triangle; ``ties``, those of them that
    are exact f32 ties (the kernel's triangle hit by the same ray at
    exactly the plain version's t, so that the lowest id decides);
    ``uv_off``, barycentrics that differ where the ids agree."""
    from psdr_jit_tpu_torch.ops import intersect as ix

    (ids, us, vs), (ids_p, us_p, vs_p) = hits, hits_p
    same = ids == ids_p
    out = dict(ids_off=int((~same).sum()), ties=0,
               uv_off=int((us[same] != us_p[same]).sum()
                          + (vs[same] != vs_p[same]).sum()))
    for k, s in enumerate(record):
        off = ~same[k]
        if not bool(off.any()):
            continue
        j = ids[k][off].long()
        o, d, tp = s.o[off], s.d[off], s.t[off]
        tab = tri[:, j.clamp(min=0)]
        t, _, _ = ix.hit_test(*tab, *o.unbind(-1), *d.unbind(-1))
        out["ties"] += int(((j >= 0) & (ids_p[k][off] >= 0)
                            & (t == tp)).sum())
    return out


def k2_top_phase(dev) -> dict:
    """[K2-top]: K2 at the top of its scope, the 172-triangle gallery
    (``gallery_arrays(n_spheres=2, subdiv=1)``, eleven 16-triangle
    clusters), in its three modes against their plain versions on 131,072
    camera lanes (64x64, spp 32, depth 3, every seventh lane inactive; pair
    mode's second rays from another seed), timed, so that the design is
    not held to the Cornell box alone. Returns each mode's largest error."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
    from psdr_jit_tpu_torch.ops import megakernel as mk

    w = 64
    sc = pt.Scene.from_arrays(gallery_arrays(w, w, 32, n_spheres=2, subdiv=1),
                              device=dev)
    sd = sc.configure()
    f = sd.tri.p0.shape[0]
    require(mk.applicable(sd) and f > 128, "K2-top: scene outside K2's scope")
    tables = mk.build_tables(sd)
    pix = torch.arange(w * w, device=dev)
    rays = []
    for seed in (SEED, SEED + 1):
        _, sampler, samples = interior_lane_setup(w, w, 32, seed, pix)
        ray = sd.sensors[0].sample_primary_ray(samples)
        rays += [ray.o.contiguous(), ray.d.contiguous()]
    _, sampler, _ = interior_lane_setup(w, w, 32, SEED, pix)
    act = torch.ones(rays[0].shape[0], dtype=torch.bool, device=dev)
    act[::7] = False
    tail = (act, sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
    single = (*tables, *rays[:2], *tail)
    pair = (*tables, *rays, *tail)
    out = {}
    res = {}
    for mode, kernel, plain, args in (
            ("K2", mk.li_mega_cuda, mk.li_mega_plain, single),
            ("K2-pair", mk.li_mega_pair_cuda, mk.li_mega_pair_plain, pair),
            ("K2-stash", mk.li_mega_stash_cuda, mk.li_mega_stash_plain,
             single)):
        record = []
        got, want = kernel(*args), plain(*args, record=record)
        if mode == "K2-stash":
            agree = stash_agreement(tables[0], got[1], want[1], record)
            res.update(agree)
            got, want = got[0], want[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = rel_l1(got, want)
        out[mode] = err
        res[mode] = (f"rel_l1:{rel:.3e},max_abs_err:{err:.3e},"
                     f"ms:{cuda_ms(lambda: kernel(*args), 10):.4f},"
                     f"plain_ms:{cuda_ms(lambda: plain(*args), 1):.1f}")
        require(bool(torch.isfinite(got).all()) and rel < 1e-3,
                f"K2-top: {mode} rel L1 vs plain >= 1e-3")
    agree = {k: res.pop(k) for k in ("ids_off", "ties", "uv_off")}
    log("K2-top", triangles=f, lanes=act.shape[0], depth=DEPTH,
        **{f"stash_{k}": v for k, v in agree.items()}, **res)
    require(agree["ids_off"] == agree["ties"] and agree["uv_off"] == 0,
            "K2-top: stash hits differ beyond f32 ties")
    return out


def k2_tie_phase(dev):
    """[K2-tie]: K2 in stash mode at depth 0, used as a closest hit, on the
    tie case cut to 180 triangles (60 duplicated pairs hit at exactly equal
    distances), through each of its two sweeps (the warp-decided and the
    compacted), against the unculled plain sweep, bit for bit."""
    import torch
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import megakernel as mk

    p0, e1, e2, ro, rd, low = (torch.from_numpy(x).to(dev) for x in
                               tie_case(n_tri=180, n_pairs=60, seed=3))
    tri, box = ix.pack_triangles(p0, e1, e2)
    want = ix.sweep_plain(tri, ro.unbind(-1), rd.unbind(-1))
    n = ro.shape[0]
    args = (tri, box, torch.zeros((mk.ATTR_ROWS, tri.shape[1]), device=dev),
            torch.zeros((mk.LIGHT_ROWS, 1), device=dev),
            torch.zeros(2, device=dev), ro.contiguous(), rd.contiguous(), None,
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.arange(n, device=dev), 0, 0, 0, False)
    ok = {}
    for name, coherent in (("warp_decided", 1), ("compacted", 0)):
        _, (ids, us, vs) = mk._launch_k2("K2-stash", *args,
                                         coherent_sweeps=coherent)
        ok[name] = all(torch.equal(x[0], y)
                       for x, y in zip((ids, us, vs), want[1:]))
    on_low = int((want[1] == low.to(torch.int32)).sum())
    log("K2-tie", rays=n, triangles=p0.shape[0],
        **{f"{k}_bitwise": v for k, v in ok.items()},
        rays_on_lowest_id=on_low)
    require(all(ok.values()), "K2-tie: hits differ from the unculled sweep")
    require(on_low > n // 2, "K2-tie: the tie case has few ties")


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
        scene.bsdfs[1].reflectance.data = p["alb"].reshape(1, 1, 3)
        scene.emitters[0].radiance = p["rad"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"tx": torch.zeros(()), "dv": torch.zeros_like(verts),
              "alb": scene.bsdfs[1].reflectance.data.reshape(3).clone(),
              "rad": scene.emitters[0].radiance.clone()}
    return params, apply_params, pixel_loss


def forward_mode(integrator, scene, set_param, value, direction,
                 seed: int = SEED, **kwargs):
    """``(primal, tangent)`` of ``integrator.renderD(scene)`` in forward
    mode: ``set_param`` puts a dual tensor of ``value`` along
    ``direction`` on the scene objects inside
    ``torch.autograd.forward_ad.dual_level()``, and ``value`` back after.
    An image without a tangent does not depend on the parameter: its
    tangent is zeros."""
    import torch
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        set_param(fwAD.make_dual(value, torch.as_tensor(
            direction, dtype=torch.float32).to(value.device)))
        primal, tangent = fwAD.unpack_dual(integrator.renderD(
            scene, 0, seed=seed, **kwargs))
        primal = primal.clone()
        tangent = (torch.zeros_like(primal) if tangent is None
                   else tangent.clone())
    set_param(value)
    return primal, tangent


def func_jvp(integrator, scene, set_param, value, direction,
             seed: int = SEED, **kwargs):
    """``(primal, tangent)`` of ``integrator.renderD(scene)`` by
    ``torch.func.jvp`` of the render as a function of ``value``, which
    ``set_param`` puts on the scene objects (``value`` back after)."""
    import torch

    def render(v):
        set_param(v)
        return integrator.renderD(scene, 0, seed=seed, **kwargs)

    try:
        return torch.func.jvp(render, (value,), (torch.as_tensor(
            direction, dtype=torch.float32).to(value.device),))
    finally:
        set_param(value)


def renderd_tangent(integrator, scene, setup, name, direction,
                    seed: int = SEED, **kwargs):
    """``forward_mode`` along ``direction`` of the ``train_setup``
    parameter ``name`` (``setup`` is ``train_setup(scene)``)."""
    params, apply_params, _ = setup
    return forward_mode(integrator, scene,
                        lambda v: apply_params({**params, name: v}),
                        params[name], direction, seed, **kwargs)


def reverse_grads(integ, scene, params, apply_params, weight,
                  seed: int = SEED):
    """``(renderD, {name: gradient})`` of ``sum(weight * renderD)`` with
    respect to ``params``, which ``apply_params`` sets, in reverse mode."""
    import torch

    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    apply_params(p)
    try:
        img = integ.renderD(scene, 0, seed=seed)
        grads = torch.autograd.grad((img * weight).sum(), list(p.values()))
    finally:
        apply_params(params)
    return img.detach(), dict(zip(p, grads))


def renderd_grads(integrator, scene, setup, weight, seed: int = SEED):
    """``{name: gradient}`` of ``sum(weight * renderD)`` with respect to
    the ``train_setup`` parameters (``setup``), in reverse mode."""
    return reverse_grads(integrator, scene, *setup[:2], weight, seed)[1]


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
                   seed=0, sppe=0, sppse=0, edge_spheres=0) -> dict:
    """The large-scene gallery of ``tests/scenes.py`` ``make_gallery`` as
    the dict ``interop.scene_to_arrays`` makes of it, built with numpy: a
    lit box room [0, 10]^3 (open front) holding a jittered grid of
    ``n_spheres`` smooth icospheres, ``n_spheres * 20 * 4^subdiv + 12``
    triangles (102,412 by default), the first ``edge_spheres`` of them
    with their edges on. The card's machine has no JAX."""
    import numpy as np

    out = {"opts": np.asarray([width, height, spp, sppe, sppse], np.int64),
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
                               False, placed < edge_spheres,
                               f"m{placed % 6}"))
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


def envmap_standin(subdiv: int = 4, map_hw=(512, 1024), seed: int = 0):
    """``(vertices, faces, radiance)``, numpy, of the stand-in for BASELINE
    config #3's assets (the tutorial's bunny and 1k ballroom map, which the
    repository does not hold): a unit icosphere subdivided ``subdiv`` times
    (5,120 triangles at 4, within 3% of the bunny's 4,968), each vertex
    pushed along itself by ``1 + 0.2 s(v)``, ``s`` the mean of 4 plane waves
    of seeded directions, frequencies and phases, then scaled to radius 40;
    and an ``map_hw + (3,)`` lat-long HDR map: a sky of 0.2 to 1.0 by
    elevation plus 12 warm Gaussian lamps (sigma 4 texels at 1,024 wide,
    peaks 50 to 200) above the horizon, so that its importance table is
    sharply non-uniform."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v, f = _icosphere(subdiv)
    dirs = rng.standard_normal((4, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freq = rng.uniform(2.0, 5.0, 4)
    phase = rng.uniform(0.0, 2.0 * np.pi, 4)
    s = np.sin(v.astype(np.float64) @ dirs.T * freq + phase).mean(1)
    verts = (v * (40.0 * (1.0 + 0.2 * s))[:, None]).astype(np.float32)
    h, w = map_hw
    row = (np.arange(h) + 0.5) / h
    sky = 1.0 - 0.8 * row  # 1.0 at the zenith, 0.2 at the nadir
    tex = np.broadcast_to((sky[:, None, None]
                           * np.asarray([0.8, 0.9, 1.0])[None, None, :]),
                          (h, w, 3)).copy()
    sigma = max(4.0 * w / 1024.0, 1.0)
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                         indexing="ij")
    for _ in range(12):
        cy, cx = rng.uniform(0.1, 0.5) * h, rng.uniform(0.0, 1.0) * w
        dx = np.abs(xx - cx)
        dx = np.minimum(dx, w - dx)  # the map wraps in longitude
        g = np.exp(-((yy - cy) ** 2 + dx ** 2) / (2.0 * sigma ** 2))
        tex += (rng.uniform(50.0, 200.0) * g)[..., None] * np.asarray(
            [1.0, 0.75, 0.45])
    return verts, f, tex.astype(np.float32)


def envmap_arrays(width=128, height=128, spp=32, sppe=32, sppse=32,
                  subdiv=4, map_hw=(512, 1024), seed=0) -> dict:
    """BASELINE config #3's scene (``tests/scenes.py`` ``make_bunny_envmap``)
    on the stand-in assets of :func:`envmap_standin`, as the dict
    ``interop.scene_to_arrays`` makes of it: a ``MicrofacetBSDF([0.2, 0.9,
    0.9], [0.01] * 3, 0.3)`` mesh, smooth-shaded with edges on, moved to
    z = -100 by its ``to_world_raw``, under the map, seen by a
    ``PerspectiveCamera(80, 1e-6, 1e7)`` whose ``to_world`` is diag(-1, 1,
    -1, 1). With the bounding mesh the scene holds 5,132 triangles at
    ``subdiv`` 4, so every intersection on the card goes through K6."""
    import numpy as np

    verts, faces, tex = envmap_standin(subdiv, map_hw, seed)
    eye = np.asarray(_EYE4, np.float32)
    out = {"opts": np.asarray([width, height, spp, sppe, sppse], np.int64),
           "seed": np.asarray(0, np.int64),
           "counts": np.asarray([1, 1, 1, 1], np.int64),
           "bsdf_ids": np.asarray(["bunny"]),
           "bsdf.0.twoSide": np.asarray(False),
           "bsdf.0.type": np.asarray("MicrofacetBSDF")}
    uv = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    for name, value in (("specularReflectance", [0.2, 0.9, 0.9]),
                        ("diffuseReflectance", [0.01] * 3),
                        ("roughness", [0.3])):
        out[f"bsdf.0.{name}.data"] = np.asarray(value, np.float32).reshape(
            1, 1, -1)
        out[f"bsdf.0.{name}.uv"] = uv
    out["emitter.0.type"] = np.asarray("EnvironmentMap")
    out["emitter.0.radiance.data"] = tex
    out["emitter.0.radiance.uv"] = uv
    out["emitter.0.scale"] = np.asarray(1.0, np.float32)
    out["emitter.0.to_world_raw"] = eye
    out["emitter.0.to_world_left"] = eye
    out["mesh.0.vertex_positions_raw"] = verts
    out["mesh.0.face_indices"] = faces
    out["mesh.0.to_world_left"] = eye
    out["mesh.0.to_world_raw"] = np.asarray(
        [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, -100.0],
         [0, 0, 0, 1.0]], np.float32)
    out["mesh.0.to_world_right"] = eye
    out["mesh.0.use_face_normals"] = np.asarray(False)
    out["mesh.0.enable_edges"] = np.asarray(True)
    out["mesh.0.bsdf_id"] = np.asarray(0, np.int64)
    out["mesh.0.emitter_id"] = np.asarray(-1, np.int64)
    out["sensor.0.fov_near_far"] = np.asarray([80.0, 1e-6, 1e7], np.float64)
    out["sensor.0.to_world_left"] = eye
    out["sensor.0.to_world_raw"] = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(
        np.float32)
    out["sensor.0.to_world_right"] = eye
    return out


# the Cornell box's centre, which the textured box's other cameras face
CBOX_CENTRE = (278.0, 274.4, 279.6)
QUAD_UV = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))


def texture_map(h: int, w: int, channels: int, lo: float, hi: float,
                seed: int):
    """A seeded (h, w, channels) float32 texture in [lo, hi]: an 8x8
    checker (weight 0.6) plus value noise (0.4), a 9x9 grid of uniform
    values a channel, bilinearly interpolated across the texture."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    checker = ((yy * 8 // h + xx * 8 // w) % 2).astype(np.float64)
    grid = rng.random((9, 9, channels))
    fy, fx = yy * (8.0 / max(h - 1, 1)), xx * (8.0 / max(w - 1, 1))
    y0, x0 = np.minimum(fy.astype(int), 7), np.minimum(fx.astype(int), 7)
    ty, tx = (fy - y0)[..., None], (fx - x0)[..., None]
    noise = ((1 - ty) * ((1 - tx) * grid[y0, x0] + tx * grid[y0, x0 + 1])
             + ty * ((1 - tx) * grid[y0 + 1, x0] + tx * grid[y0 + 1, x0 + 1]))
    val = 0.6 * checker[..., None] + 0.4 * noise
    return (lo + (hi - lo) * val).astype(np.float32)


def _look_at(origin, target):
    """Camera-to-world of a camera at ``origin`` facing ``target``, y up
    (the reference's look_at: columns left, up, direction, origin)."""
    import numpy as np

    o, t = np.asarray(origin, np.float64), np.asarray(target, np.float64)
    d = (t - o) / np.linalg.norm(t - o)
    left = np.cross([0.0, 1.0, 0.0], d)
    left /= np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(d, left), d, o
    return m.astype(np.float32)


def textured_cameras():
    """The to_world of the textured box's four sensors: the README camera
    at (278, 273, -800) facing +z, then three facing the box's centre:
    the README camera's eye yawed by +20 and -20 degrees about the
    centre's vertical, and raised by 150."""
    import numpy as np

    eye = np.asarray([278.0, 273.0, -800.0])
    c = np.asarray(CBOX_CENTRE)
    mats = [np.asarray([[1.0, 0, 0, 278.0], [0, 1, 0, 273.0],
                        [0, 0, 1, -800.0], [0, 0, 0, 1.0]], np.float32)]
    for deg in (20.0, -20.0):
        a = np.radians(deg)
        rot = np.asarray([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                          [-np.sin(a), 0.0, np.cos(a)]])
        mats.append(_look_at(c + rot @ (eye - c), c))
    mats.append(_look_at(eye + [0.0, 150.0, 0.0], c))
    return mats


def textured_textures(tex=TEXTURED_TEX, seed: int = 0) -> dict:
    """The textured box's seeded textures: the white walls' albedo
    (``tex[0]``² x 3 in 0.05-0.95), the tall block's diffuse albedo
    (``tex[1]``² x 3, same range) and roughness (``tex[1]``² x 1 in
    0.1-0.6)."""
    a, b = tex
    return {"albedo": texture_map(a, a, 3, 0.05, 0.95, seed),
            "block": texture_map(b, b, 3, 0.05, 0.95, seed + 1),
            "roughness": texture_map(b, b, 1, 0.1, 0.6, seed + 2)}


def textured_cbox_arrays(width=512, height=512, spp=32, sppe=32, sppse=32,
                         tex=TEXTURED_TEX, seed: int = 0) -> dict:
    """BASELINE config #4's scene on the Cornell box, as the dict
    ``interop.scene_to_arrays`` makes of it: ``make_cbox``'s geometry
    (``tests/data/cbox_scene.npz``) with every quad UV-mapped (0, 0), (1,
    0), (1, 1), (0, 1); the white walls (``bsdfs[2]``) a ``DiffuseBSDF``
    of the seeded albedo texture of :func:`textured_textures`; the tall
    block (mesh 2) a ``MicrofacetBSDF`` of a constant 0.04 specular and
    the seeded diffuse and roughness textures (``bsdfs[5]``, id "tall");
    the other materials and the area light as in ``make_cbox``; four
    field-of-view 39 cameras (:func:`textured_cameras`)."""
    import numpy as np

    base = np.load(SCENE_NPZ)
    out = {k: base[k] for k in base.files}
    out["opts"] = np.asarray([width, height, spp, sppe, sppse], np.int64)
    n_meshes = int(out["counts"][0])
    out["counts"] = np.asarray([n_meshes, 6, 1, 4], np.int64)
    out["bsdf_ids"] = np.asarray([*out["bsdf_ids"].tolist(), "tall"])
    maps = textured_textures(tex, seed)
    ident = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    del out["bsdf.2.reflectance"]
    out["bsdf.2.reflectance.data"] = maps["albedo"]
    out["bsdf.2.reflectance.uv"] = ident
    out["bsdf.5.twoSide"] = np.asarray(False)
    out["bsdf.5.type"] = np.asarray("MicrofacetBSDF")
    for name, value in (("specularReflectance",
                         np.full((1, 1, 3), 0.04, np.float32)),
                        ("diffuseReflectance", maps["block"]),
                        ("roughness", maps["roughness"])):
        out[f"bsdf.5.{name}.data"] = value
        out[f"bsdf.5.{name}.uv"] = ident
    for i in range(n_meshes):
        faces = out[f"mesh.{i}.face_indices"]
        n_quads = out[f"mesh.{i}.vertex_positions_raw"].shape[0] // 4
        out[f"mesh.{i}.vertex_uv"] = np.tile(np.asarray(QUAD_UV, np.float32),
                                             (n_quads, 1))
        out[f"mesh.{i}.face_uv_indices"] = faces.copy()
    out["mesh.2.bsdf_id"] = np.asarray(5, np.int64)
    eye = np.asarray(_EYE4, np.float32)
    for s, m in enumerate(textured_cameras()):
        out[f"sensor.{s}.fov_near_far"] = out["sensor.0.fov_near_far"]
        out[f"sensor.{s}.to_world_left"] = eye
        out[f"sensor.{s}.to_world_raw"] = m
        out[f"sensor.{s}.to_world_right"] = eye
    return out


# the Cornell box with each of the other four BSDFs ([bsdf-64])
BSDF_CASES = ("conductor", "dielectric", "pv", "normalmap")
BSDF_DEPTH = {"conductor": 2, "dielectric": 4, "pv": 2, "normalmap": 2}
BSDF_SMALL = (64, 64, 4)  # width, height, spp (= sppe = sppse) of [bsdf-64]


def bsdf_nmap():
    """The 8x8 normal map of ``tests/test_bsdf_render.py``'s normal-map
    case: x and y uniform in [0.35, 0.65] from seed 0, z 1."""
    import numpy as np

    nm = np.random.default_rng(0).uniform(0.35, 0.65, (8, 8, 3)).astype(
        np.float32)
    nm[..., 2] = 1.0
    return nm


def bsdf_cbox_arrays(case, width=64, height=64, spp=4, sppe=4, sppse=4,
                     tex=TEXTURED_TEX) -> dict:
    """The Cornell box of ``tests/test_bsdf_render.py _cbox_with`` with one
    of the four BSDFs of ``BSDF_CASES``, as the dict
    ``interop.scene_to_arrays`` makes of it: an anisotropic rough
    conductor (alpha 0.2 and 0.08, the default gold-like index), a rough
    dielectric (alpha 0.2, index 1.5) or a per-vertex Microfacet (diffuse
    from 0.1 to 0.9 over the vertices) on the short block (mesh 1, 20
    vertices, as ``bsdfs[5]``, id "test_mat"); or a normal map
    (:func:`bsdf_nmap`) over a Microfacet (0.1, 0.4, roughness 0.3) on the
    UV-mapped tall block of :func:`textured_cbox_arrays` (as ``bsdfs[6]``,
    id "nmap"), so that the map is read at real texture coordinates."""
    import numpy as np

    ident = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)

    def bitmap(key, value):
        out[f"{key}.data"] = np.asarray(value, np.float32).reshape(
            (1, 1, -1) if np.ndim(value) < 3 else np.shape(value))
        out[f"{key}.uv"] = ident

    if case == "normalmap":
        out = textured_cbox_arrays(width, height, spp, sppe, sppse, tex)
        j, mesh, bid = 6, 2, "nmap"
        out[f"bsdf.{j}.type"] = np.asarray("NormalMapBSDF")
        bitmap(f"bsdf.{j}.nmap", bsdf_nmap())
        out[f"bsdf.{j}.nested.twoSide"] = np.asarray(False)
        out[f"bsdf.{j}.nested.type"] = np.asarray("MicrofacetBSDF")
        for name, value in (("specularReflectance", (0.1,) * 3),
                            ("diffuseReflectance", (0.4,) * 3),
                            ("roughness", 0.3)):
            bitmap(f"bsdf.{j}.nested.{name}", value)
    else:
        base = np.load(SCENE_NPZ)
        out = {k: base[k] for k in base.files}
        out["opts"] = np.asarray([width, height, spp, sppe, sppse], np.int64)
        j, mesh, bid = 5, 1, "test_mat"
        if case == "conductor":
            out[f"bsdf.{j}.type"] = np.asarray("RoughConductorBSDF")
            for name, value in (("alpha_u", 0.2), ("alpha_v", 0.08),
                                ("eta", (0.2004, 0.9228, 1.102)),
                                ("k", (3.913, 2.448, 2.1765)),
                                ("specular_reflectance", (1.0,) * 3)):
                bitmap(f"bsdf.{j}.{name}", value)
        elif case == "dielectric":
            out[f"bsdf.{j}.type"] = np.asarray("RoughDielectricBSDF")
            bitmap(f"bsdf.{j}.alpha_u", 0.2)
            bitmap(f"bsdf.{j}.alpha_v", 0.2)
            out[f"bsdf.{j}.eta_value"] = np.asarray(1.5, np.float32)
        elif case == "pv":
            nv = out[f"mesh.{mesh}.vertex_positions_raw"].shape[0]
            out[f"bsdf.{j}.type"] = np.asarray("MicrofacetBSDFPerVertex")
            out[f"bsdf.{j}.specularReflectance"] = np.full((nv, 3), 0.05,
                                                           np.float32)
            out[f"bsdf.{j}.diffuseReflectance"] = np.tile(np.linspace(
                0.1, 0.9, nv)[:, None], (1, 3)).astype(np.float32)
            out[f"bsdf.{j}.roughness"] = np.full((nv, 1), 0.4, np.float32)
        else:
            raise ValueError(f"BSDF case {case!r}: one of {BSDF_CASES}")
    out[f"bsdf.{j}.twoSide"] = np.asarray(False)
    counts = out["counts"].copy()
    counts[1] = j + 1
    out["counts"] = counts
    out["bsdf_ids"] = np.asarray([*out["bsdf_ids"].tolist(), bid])
    out[f"mesh.{mesh}.bsdf_id"] = np.asarray(j, np.int64)
    return out


# BASELINE config #5, the room (``tests/scenes.py make_room``)
ROOM = (512, 512, 32)  # width, height, spp (= sppe = sppse) of [room]
ROOM_DEPTH = 2  # examples/room_optimization.py:44
ROOM_SMALL = (64, 64, 4)  # examples/room_optimization.py:43
ROOM_STEPS = 4
ROOM_LR = 0.01  # examples/room_optimization.py:83
ROOM_TRUTH = {"tx": 0.12, "log_gain": -0.3}  # room_optimization.py:59
ROOM_BSDFS = (  # (id, type, parameters) in make_room's order
    ("light", "DiffuseBSDF", {"reflectance": (0.0, 0.0, 0.0)}),
    ("plaster", "DiffuseBSDF", {"reflectance": (0.72, 0.70, 0.66)}),
    ("wood_d", "DiffuseBSDF", {"reflectance": (0.45, 0.30, 0.18)}),
    ("wood", "MicrofacetBSDF", {
        "specularReflectance": (0.04, 0.04, 0.04),
        "diffuseReflectance": (0.50, 0.33, 0.20), "roughness": (0.25,)}),
    ("brass", "RoughConductorBSDF", {
        "alpha_u": (0.15,), "alpha_v": (0.15,), "eta": (0.2, 0.92, 1.1),
        "k": (3.9, 2.45, 2.14), "specular_reflectance": (1.0, 0.78, 0.42)}),
    ("blue", "DiffuseBSDF", {"reflectance": (0.20, 0.35, 0.70)}),
    ("red", "DiffuseBSDF", {"reflectance": (0.75, 0.25, 0.20)}),
)
# mesh indices of the room's parameters (tests/test_room.py:42-44,
# examples/room_optimization.py:51)
ROOM_BRASS, ROOM_RED_BOX, ROOM_PRISM = 11, 12, 13


def box_quads(cx, cy, cz, sx, sy, sz, ry=0.0):
    """An axis-aligned box's six outward-facing quads centred at (cx, cy,
    cz), turned ``ry`` radians about +y; numpy copy of ``tests/scenes.py
    _box_quads``."""
    import numpy as np

    hx, hy, hz = sx / 2.0, sy / 2.0, sz / 2.0
    c, s = np.cos(ry), np.sin(ry)

    def pt(x, y, z):
        return (cx + (c * x + s * z), cy + y, cz + (-s * x + c * z))

    return [
        [pt(-hx, hy, -hz), pt(-hx, hy, hz), pt(hx, hy, hz), pt(hx, hy, -hz)],
        [pt(-hx, -hy, -hz), pt(hx, -hy, -hz), pt(hx, -hy, hz),
         pt(-hx, -hy, hz)],
        [pt(hx, -hy, -hz), pt(hx, hy, -hz), pt(hx, hy, hz), pt(hx, -hy, hz)],
        [pt(-hx, -hy, -hz), pt(-hx, -hy, hz), pt(-hx, hy, hz),
         pt(-hx, hy, -hz)],
        [pt(-hx, -hy, hz), pt(hx, -hy, hz), pt(hx, hy, hz), pt(-hx, hy, hz)],
        [pt(-hx, -hy, -hz), pt(-hx, hy, -hz), pt(hx, hy, -hz),
         pt(hx, -hy, -hz)],
    ]


def quads_mesh(quads):
    """``(vertices (4q, 3) float32, faces (2q, 3) int32)`` of quads, each
    split into a fan; numpy copy of ``tests/scenes.py _quads_to_mesh``."""
    import numpy as np

    verts, faces = [], []
    for q in quads:
        base = len(verts)
        verts.extend(q)
        faces += [[base, base + k, base + k + 1] for k in range(1, len(q) - 1)]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def room_arrays(width=512, height=512, spp=32, sppe=32, sppse=32) -> dict:
    """BASELINE config #5's room (``tests/scenes.py make_room``) as the dict
    ``interop.scene_to_arrays`` makes of it, built with numpy: a 5 x 3 x 5
    m room open at the front, a ceiling light panel, a Microfacet table
    on four diffuse legs, a rough-conductor brass block, a red box and a
    blue prism: 14 meshes, 108 triangles, every mesh with its edges on."""
    import numpy as np

    eye = np.asarray(_EYE4, np.float32)
    out = {"opts": np.asarray([width, height, spp, sppe, sppse], np.int64),
           "seed": np.asarray(0, np.int64),
           "bsdf_ids": np.asarray([b[0] for b in ROOM_BSDFS])}
    ident = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    for j, (_, kind, params) in enumerate(ROOM_BSDFS):
        out[f"bsdf.{j}.twoSide"] = np.asarray(False)
        if kind == "DiffuseBSDF":
            out[f"bsdf.{j}.reflectance"] = np.asarray(params["reflectance"],
                                                      np.float32)
            continue
        out[f"bsdf.{j}.type"] = np.asarray(kind)
        for name, value in params.items():
            out[f"bsdf.{j}.{name}.data"] = np.asarray(
                value, np.float32).reshape(1, 1, -1)
            out[f"bsdf.{j}.{name}.uv"] = ident
    out["emitter.0.radiance"] = np.asarray((30.0, 28.0, 24.0), np.float32)
    out["emitter.0.mesh_index"] = np.asarray(0, np.int64)
    ids = [b[0] for b in ROOM_BSDFS]
    meshes = [
        ([[(2.0, 2.98, 2.0), (3.0, 2.98, 2.0), (3.0, 2.98, 3.0),
           (2.0, 2.98, 3.0)]], "light"),
        ([[(0, 0, 0), (0, 0, 5), (5, 0, 5), (5, 0, 0)]], "plaster"),
        ([[(0, 3, 0), (5, 3, 0), (5, 3, 5), (0, 3, 5)]], "plaster"),
        ([[(0, 0, 5), (0, 3, 5), (5, 3, 5), (5, 0, 5)]], "plaster"),
        ([[(0, 0, 0), (0, 3, 0), (0, 3, 5), (0, 0, 5)]], "red"),
        ([[(5, 0, 0), (5, 0, 5), (5, 3, 5), (5, 3, 0)]], "blue"),
        (box_quads(2.5, 0.78, 2.5, 1.6, 0.06, 1.0), "wood")]
    meshes += [(box_quads(2.5 + dx, 0.375, 2.5 + dz, 0.08, 0.75, 0.08),
                "wood_d")
               for dx, dz in [(-0.7, -0.4), (0.7, -0.4), (-0.7, 0.4),
                              (0.7, 0.4)]]
    meshes += [(box_quads(2.15, 0.96, 2.45, 0.3, 0.3, 0.3, ry=0.5), "brass"),
               (box_quads(2.95, 0.91, 2.3, 0.22, 0.2, 0.22, ry=-0.3), "red"),
               (box_quads(2.6, 1.11, 2.75, 0.16, 0.6, 0.16, ry=0.9), "blue")]
    for i, (quads, bsdf) in enumerate(meshes):
        v, f = quads_mesh(quads)
        out[f"mesh.{i}.vertex_positions_raw"] = v
        out[f"mesh.{i}.face_indices"] = f
        for name in ("to_world_left", "to_world_raw", "to_world_right"):
            out[f"mesh.{i}.{name}"] = eye
        out[f"mesh.{i}.use_face_normals"] = np.asarray(True)
        out[f"mesh.{i}.enable_edges"] = np.asarray(True)
        out[f"mesh.{i}.bsdf_id"] = np.asarray(ids.index(bsdf), np.int64)
        out[f"mesh.{i}.emitter_id"] = np.asarray(0 if i == 0 else -1,
                                                 np.int64)
    out["counts"] = np.asarray([len(meshes), len(ids), 1, 1], np.int64)
    out["sensor.0.fov_near_far"] = np.asarray([55.0, 1e-4, 1e5], np.float64)
    out["sensor.0.to_world_left"] = eye
    out["sensor.0.to_world_raw"] = np.asarray(
        [[1.0, 0, 0, 2.5], [0, 1.0, 0, 1.5], [0, 0, 1.0, -4.2],
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
    reached none of them; and, as ``hits``, the closest hits rebuilt on the
    card (``SceneData.ray_intersect`` calls), each of which K7 must
    rebuild once (:func:`rebuilds`)."""

    def __init__(self):
        from psdr_jit_tpu_torch.ops import intersect as ix
        from psdr_jit_tpu_torch.ops import megakernel as mk
        from psdr_jit_tpu_torch.ops import shade_mega as sm

        from psdr_jit_tpu_torch.ops import bvh
        from psdr_jit_tpu_torch.scene.scene import SceneData

        self.sites = [(ix, "ray_intersect_brute"), (mk, "_li_plain"),
                      (sm, "li_attached_plain"),
                      (bvh, "ray_intersect_bvh_plain"),
                      (SceneData, "_rebuild_plain")]
        self.scene_data = SceneData
        self.count = 0
        self.hits = 0

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.sites]
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, self._counted(fn))
        hit = self.hit = self.scene_data.ray_intersect

        def counted_hit(*args, **kwargs):
            its = hit(*args, **kwargs)
            self.hits += int(its.tri_id.is_cuda)
            return its

        self.scene_data.ray_intersect = counted_hit
        return self

    def _counted(self, fn):
        def wrapper(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return wrapper

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)
        self.scene_data.ray_intersect = self.hit


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
    version on exactly the inputs the run gave it. A recorded function
    keeps the keyword arguments of its call (the tree walk's
    ``kernel``)."""

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

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            # a copy: autograd may add into a cotangent the kernel returned
            kept = torch.utils._pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
            self.calls[kernel].append(
                (functools.partial(fn, **kwargs) if kwargs else fn, args,
                 kept))
            return out
        return wrapper

    def __exit__(self, *exc):
        for k, (m, n) in self.sites.items():
            setattr(m, n, self.saved[k])


def se_pass_ms(step, reps: int) -> float:
    """Median span of the step's secondary-edge pass on the card's stream
    (the program's span ``secondary_edge``) over ``reps`` steps."""
    return step_split(step, reps)["secondary_edges"]


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
        record = []
        (li_p, hits_p), plain_ms = _synced_ms(
            lambda: mk.li_mega_stash_plain(*args, record=record))
        agree = stash_agreement(args[0], hits, hits_p, record)
        diff = (li - li_p).abs()
        nbytes, flops, tests = k2_bound_terms(args, record, False, True)
        note("K2-stash", float(diff.max()), float(diff.sum()),
             float(li_p.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=li.shape[0], hits=hits[0].numel(), nbytes=nbytes,
             flops=flops, tests=tests, sweeps=len(record) * li.shape[0],
             **agree)
        stats["K2-stash"].setdefault("per_launch", []).append(
            f"{agree['ids_off']}/{agree['ties']}/{agree['uv_off']}")
        del record
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
        record = []
        ref, plain_ms = _synced_ms(
            lambda: mk.li_mega_pair_plain(*args, record=record))
        diff = (out - ref).abs()
        n, valid = out.shape[0], args[9]
        nbytes, flops, tests = k2_bound_terms(args, record, True, False)
        lanes_off = int((out != ref).any(-1).sum())
        note("K2-pair", float(diff.max()), float(diff.sum()),
             float(ref.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=n, valid=int(valid.sum()), nbytes=nbytes, flops=flops,
             tests=tests, sweeps=len(record) * n, lanes_off=lanes_off)
        stats["K2-pair"].setdefault("per_launch", []).append(str(lanes_off))
        del record
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        require(k in stats, f"train-frame: the step launched no {k}")

    rels = {}
    for k in ("K2-stash", "K3", "K2-pair"):
        s = stats[k]
        rels[k] = s["diff"] / max(s["ref"], 1e-30)
    k4_rel = {g: (d / r if r > 0 else d) for g, (d, r) in k4.items()}
    s = stats["K2-stash"]
    id_match = 1.0 - s["ids_off"] / s["hits"]
    bounds = {k: bound(stats[k]["nbytes"], stats[k]["flops"])
              for k in ("K2-stash", "K2-pair")}
    log("train-frame", **{
        f"{k}": (f"launches:{v['launches']},lanes:{v['lanes']},"
                 f"max_abs_err:{v['err']:.3e},ms:{v['ms']:.4f},"
                 f"plain_ms:{v['plain_ms']:.1f}")
        for k, v in stats.items()},
        stash_id_match=f"{id_match:.6f}",
        stash_ids_off_ties_uv_off_per_launch=",".join(s["per_launch"]),
        pair_lanes_off_per_launch=",".join(stats["K2-pair"]["per_launch"]),
        K2_bound_ms=",".join(f"{k}:{b[0]:.4f}({b[1]})"
                             for k, b in bounds.items()),
        K2_needed_tests_per_lane_sweep=",".join(
            f"{k}:{stats[k]['tests'] / stats[k]['sweeps']:.2f}"
            for k in ("K2-stash", "K2-pair")),
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        K4_rel_l1=",".join(f"{g}:{v:.3e}" for g, v in k4_rel.items()),
        K4_run_to_run_rel=f"{stats['K4']['spread']:.3e}",
        pair_valid=stats["K2-pair"]["valid"])
    require(rels["K2-stash"] < 1e-3 and rels["K2-pair"] < 1e-3,
            "train-frame: a K2 mode's rel L1 vs plain >= 1e-3")
    require(id_match >= 0.999 and s["uv_off"] == 0
            and s["ids_off"] == s["ties"],
            "train-frame: K2-stash hits differ beyond f32 ties")
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


# [K7]: the lanes of each timed set (the secondary-edge pass's and the
# general Li's sets are 2^22 lanes a chunk) and the rows of its checks
K7_LANES = 1 << 22
K7_TABLE = ("p0", "e1", "e2", "n0", "n1", "n2", "face_normal", "face_area")
K7_KEYS = ("K7", "K7-jvp", "K7-vjp")
# K7's launches summed over the main paths that :func:`rebuilds` checked
K7_MAIN_PATHS = dict.fromkeys(K7_KEYS, 0)


def rebuilds(what: str, launches: dict, hits, jvp=None, vjp=None) -> dict:
    """Check and log K7's launches in the launches of main path ``what``:
    one K7 for each ``SceneData.ray_intersect`` on the card (``hits``,
    :class:`PlainCalls`; None where the calls ran in other processes), and
    ``jvp`` K7-jvp and ``vjp`` K7-vjp where the path fixes them. Adds them
    to :data:`K7_MAIN_PATHS` and returns the other kernels' launches."""
    k7 = {k: launches.get(k, 0) for k in K7_KEYS}
    log("rebuilds", path=what, hits="-" if hits is None else hits,
        **{f"{k.replace('-', '_')}_LAUNCHES": v for k, v in k7.items()},
        jvp_expected="-" if jvp is None else jvp,
        vjp_expected="-" if vjp is None else vjp)
    require(hits is None or k7["K7"] == hits,
            f"{what}: K7 launches != the hits rebuilt")
    require(jvp is None or k7["K7-jvp"] == jvp,
            f"{what}: K7-jvp launches != the tangent hit sets")
    require(vjp is None or k7["K7-vjp"] == vjp,
            f"{what}: K7-vjp launches != the attached hit sets")
    for k, v in k7.items():
        K7_MAIN_PATHS[k] += v
    return {k: v for k, v in launches.items() if k not in K7_KEYS}


def table_scene(sd, table, uvt=None):
    """``sd`` with its triangle tables the column views of K7's (R, 22)
    float ``table`` (``ops/hit_rebuild.py face_table``) and, where given,
    its corner UVs the (R, 6) ``uvt``, so that the plain rebuild's
    derivatives flow to them."""
    import dataclasses

    cols = {k: table[:, 3 * j:3 * j + 3] for j, k in enumerate(K7_TABLE[:7])}
    tri = dataclasses.replace(sd.tri, **cols, face_area=table[:, 21])
    if uvt is None:
        return dataclasses.replace(sd, tri=tri)
    return dataclasses.replace(sd, tri=tri,
                               tri_uv=uvt.reshape(sd.tri_uv.shape))


def k7_fields(its, solid: bool, has_uv: bool):
    """The 12 fields of ``ops.hit_rebuild.FIELDS`` of an Intersection in
    K7's layout: lanes flattened, ``bc`` empty in path mode, the texture
    fields empty without UVs."""
    t = its.t.reshape(-1)
    n = t.shape[0]
    out = [t, its.p, its.n, its.sh_frame.s, its.sh_frame.t, its.sh_frame.n,
           its.wi, its.J, its.bc, its.uv, its.dp_du, its.dp_dv]
    keep = [True] * 8 + [solid] + [has_uv] * 3
    return tuple(x.reshape(n, -1).squeeze(-1) if k else
                 x.reshape(n, -1)[:0] for x, k in zip(out, keep))


def k7_case(sd, n: int, gen, device):
    """``(ray, active, payload)`` of ``n`` of :func:`mixed_rays` (every
    seventh lane inactive, so dead lanes) on ``sd``: the closest-hit
    payload ``(tri_id, valid, uv)`` the rebuild starts from."""
    from psdr_jit_tpu_torch.core.types import Ray
    from psdr_jit_tpu_torch.ops import intersect as ix

    o, d, active = mixed_rays(sd, n, gen, device)
    ray = Ray(o, d)
    tri = sd.tri
    tree = sd.bvh if ix.needs_tree(tri.p0.shape[0], device) else None
    tri_id, valid, uv, _ = ix.ray_intersect_detached(tri.p0, tri.e1, tri.e2,
                                                     ray, active, tree)
    return ray, active, (tri_id, valid, uv)


def k7_plain_vjp(sd, table, ray, payload, solid: bool, cts, uv_diff=False,
                 dtype=None):
    """Autograd of the plain rebuild for the cotangents ``cts`` of its 12
    fields: ``(d_table (R, 22), d_o, d_d, d_uvt)``, K7-vjp's outputs
    (``d_uvt``, the corner UVs', with ``uv_diff``); in ``dtype`` (float64:
    the exact adjoint to which K7-vjp's and autograd's reordered float32
    row sums are both held)."""
    import torch
    from psdr_jit_tpu_torch.core.types import Ray

    dtype = dtype or table.dtype
    uvt = sd.hit_rows[1]
    leaves = [x.detach().to(dtype).clone().requires_grad_(k < 3 or uv_diff)
              for k, x in enumerate((table, ray.o, ray.d, uvt))]
    its = table_scene(sd, leaves[0], leaves[3] if uv_diff else None
                      )._rebuild_plain(Ray(leaves[1], leaves[2]), *payload,
                                       "solid" if solid else "path")
    outs, gs = [], []
    for x, g in zip(k7_fields(its, solid, sd.has_uv), cts):
        if x.requires_grad and g.numel():
            outs.append(x)
            gs.append(g.to(dtype))
    wrt = leaves[:4 if uv_diff else 3]
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        wrt, torch.autograd.grad(outs, wrt, gs, allow_unused=True))]
    return (grads[0], grads[1], grads[2] if solid else grads[2][:0],
            grads[3] if uv_diff else leaves[3].detach()[:0])


def k7_adjoint_errors(got, sd, table, ray, payload, solid: bool, cts,
                      uv_diff=False) -> dict:
    """K7-vjp's outputs ``got`` against autograd of the plain rebuild:
    ``rays``, the worst rel L1 of the rays' cotangents from autograd's in
    float32 (one per lane, no sums); ``table`` and ``autograd``, the worst
    rel L1 of K7's and of autograd's table cotangents (and the corner UVs'
    with ``uv_diff``) from the float64 adjoint, since the float32 row sums
    of both are reordered; ``sum_floor``, the rounding of a float32 sum of
    the lanes a row takes on average (2^-23 sqrt(lanes / rows))."""
    import torch

    exact = k7_plain_vjp(sd, table, ray, payload, solid, cts, uv_diff,
                         torch.float64)
    plain = k7_plain_vjp(sd, table, ray, payload, solid, cts, uv_diff)
    rows = [0, 3] if uv_diff else [0]
    return {"rays": max(rel_l1(got[k], plain[k]) for k in (1, 2)
                        if plain[k].numel()),
            "table": max(rel_l1(got[k].double(), exact[k]) for k in rows),
            "autograd": max(rel_l1(plain[k].double(), exact[k])
                            for k in rows),
            "sum_floor": 2.0 ** -23 * (ray.o.shape[0]
                                       / table.shape[0]) ** 0.5}


def k7_adjoint_ok(err: dict) -> bool:
    """:func:`k7_adjoint_errors` within K7-vjp's limits: the rays'
    cotangents 1e-5 from autograd's; the tables' no further from the
    float64 adjoint than twice autograd's or, where both lie at the
    rounding of their float32 sums, than ``sum_floor``."""
    return err["rays"] < 1e-5 and err["table"] <= max(2 * err["autograd"],
                                                      err["sum_floor"])


def k7_plain_jvp(sd, table, table_t, ray, ray_t, payload, solid: bool,
                 uvt_t=None):
    """Forward-mode AD of the plain rebuild along ``table_t``, the rays'
    tangents ``ray_t`` (o_t, d_t) and, where given, the corner UVs'
    ``uvt_t`` (R, 6): the tangents of its 12 fields, empty where a field
    has none (K7-jvp's layout)."""
    import torch.autograd.forward_ad as fwAD
    from psdr_jit_tpu_torch.core.types import Ray

    with fwAD.dual_level():
        uvt = (None if uvt_t is None else
               fwAD.make_dual(sd.hit_rows[1], uvt_t))
        its = table_scene(sd, fwAD.make_dual(table, table_t), uvt
                          )._rebuild_plain(
            Ray(fwAD.make_dual(ray.o, ray_t[0]),
                fwAD.make_dual(ray.d, ray_t[1])),
            *payload, "solid" if solid else "path")
        out = []
        for x in k7_fields(its, solid, sd.has_uv):
            t = fwAD.unpack_dual(x).tangent
            out.append(x.detach()[:0] if t is None else t.clone())
    return tuple(out)


def k7_args(sd, ray, payload, solid: bool):
    """K7's inputs (``ops/hit_rebuild.py rebuild_cuda``) for ``ray`` and its
    ``payload`` on ``sd``: the tables, the flat payload and rays."""
    from psdr_jit_tpu_torch.ops import hit_rebuild

    ints, uvt = sd.hit_rows
    tri_id, _, uv = payload
    table = hit_rebuild.face_table(sd.tri).detach().contiguous()
    d = ray.d if solid else ray.o[:0]
    return (table, ints, uvt, tri_id.reshape(-1).contiguous(),
            uv.reshape(-1, 2).contiguous(), ray.o.contiguous(),
            d.contiguous(), solid, sd.has_uv, sd.has_pv)


def k7_jvp_args(args, table_t, ray_t, uvt_t=None):
    """K7-jvp's inputs (``rebuild_tangent_cuda``) from K7's (:func:`k7_args`)
    and the tangents of the face table, the rays (o_t, d_t; d_t read in
    solid mode) and, where given, the corner UVs."""
    table, ints, uvt, tri_id, uv, o, d, solid, has_uv, _ = args
    return (table, table_t, ints, uvt, uvt_t, tri_id, uv, o, ray_t[0], d,
            ray_t[1] if solid else None, solid, has_uv, uvt_t is not None)


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None and nested tuples and lists
    allowed)."""
    total = 0
    for x in tensors:
        if isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def k7_phase(dev) -> dict:
    """[K7]: the hit rebuilt from K1's payload on the box's 2^22
    :func:`mixed_rays` (every seventh lane dead) in path and solid mode,
    K7 against the plain rebuild bitwise; K7-jvp against forward-mode AD
    of the plain rebuild (rel L1) and K7-vjp against autograd of it
    (:func:`k7_adjoint_ok`), tangents and cotangents dense; each timed on
    the card beside its plain version, with its bytes bound: the bytes of
    every tensor it reads (payload, rays, tables, tangents or cotangents)
    and writes."""
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import hit_rebuild

    sc = pt.Scene.from_arrays(np.load(SCENE_NPZ), device=dev)
    sd = sc.configure()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ray, _, payload = k7_case(sd, K7_LANES, gen, dev)
    n = K7_LANES
    out = {"lanes": n}
    for solid in (False, True):
        mode = "solid" if solid else "path"
        args = k7_args(sd, ray, payload, solid)
        table = args[0]
        got = hit_rebuild.rebuild_cuda(*args)
        with torch.no_grad():
            want = k7_fields(sd._rebuild_plain(ray, *payload, mode), solid,
                             False)
        bitwise = all(torch.equal(a, b) for a, b in zip(got[:12], want))
        require(bitwise, f"K7 {mode}: not the plain rebuild bit for bit")
        table_t = torch.randn(table.shape, generator=gen, device=dev)
        ray_t = (torch.randn(ray.o.shape, generator=gen, device=dev),
                 torch.randn(ray.d.shape, generator=gen, device=dev))
        jvp_args = k7_jvp_args(args, table_t, ray_t)
        tan = hit_rebuild.rebuild_tangent_cuda(*jvp_args)
        tan_p = k7_plain_jvp(sd, table, table_t, ray, ray_t, payload, solid)
        jvp_err = max(rel_l1(a, b) for a, b in zip(tan, tan_p) if b.numel())
        cts = [torch.randn(x.shape, generator=gen, device=dev)
               for x in got[:12]]
        vjp = hit_rebuild.rebuild_adjoint_cuda(*args[:9], cts)
        err = k7_adjoint_errors(vjp, sd, table, ray, payload, solid, cts)
        require(jvp_err < 1e-5 and k7_adjoint_ok(err),
                f"K7 {mode}: tangent {jvp_err:.3g}, adjoint rays "
                f"{err['rays']:.3g}, table {err['table']:.3g} (autograd's "
                f"{err['autograd']:.3g})")
        reads = args[:7]
        moved = {"fwd": nbytes(reads, got),
                 "jvp": nbytes(reads, jvp_args[1], jvp_args[8],
                               jvp_args[10], tan),
                 "vjp": nbytes(reads, cts, vjp)}

        def plain_fwd():
            with torch.no_grad():
                sd._rebuild_plain(ray, *payload, mode)

        times = {
            "fwd": (cuda_ms(lambda: hit_rebuild.rebuild_cuda(*args), 20),
                    cuda_ms(plain_fwd, 5)),
            "jvp": (cuda_ms(lambda: hit_rebuild.rebuild_tangent_cuda(
                *jvp_args), 20), cuda_ms(lambda: k7_plain_jvp(
                    sd, table, table_t, ray, ray_t, payload, solid), 5)),
            "vjp": (cuda_ms(lambda: hit_rebuild.rebuild_adjoint_cuda(
                *args[:9], cts), 20), cuda_ms(lambda: k7_plain_vjp(
                    sd, table, ray, payload, solid, cts), 5)),
        }
        for k, (card, plain) in times.items():
            bound_ms, _ = bound(moved[k], 0.0)
            out[f"{mode}_{k}"] = {"card_ms": round(card, 4),
                                  "plain_ms": round(plain, 4),
                                  "bound_ms": round(bound_ms, 4),
                                  "bytes_per_lane": round(moved[k] / n, 2)}
        log("K7", mode=mode, lanes=n, bitwise=bitwise,
            jvp_rel_l1=f"{jvp_err:.3g}",
            vjp_rays_rel_l1=f"{err['rays']:.3g}",
            vjp_table_rel_l1=f"{err['table']:.3g}",
            autograd_table_rel_l1=f"{err['autograd']:.3g}",
            sum_floor=f"{err['sum_floor']:.3g}",
            **{f"{k}_bytes_per_lane": f"{moved[k] / n:.2f}" for k in moved},
            **{f"{k}_ms": f"{c:.4f}/{p:.4f}(bound {bound(moved[k], 0)[0]:.4f})"
               for k, (c, p) in times.items()})
    return out


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


def k5_plain(tree, o, d, active):
    """K1's and K5's plain version with the walk's signature: the unculled
    sweep of the tree's triangles."""
    from psdr_jit_tpu_torch.ops import intersect as ix

    tri = tree.tri4
    ids, _, uv, t = ix.ray_intersect_brute(tri[:, 0:3], tri[:, 3:6],
                                           tri[:, 6:9], o, d, active)
    return t, ids, uv


def k6_plain(h, o, d, active, stats=None):
    """K6's plain version with the walk's signature."""
    from psdr_jit_tpu_torch.ops import bvh

    ids, _, uv, t = bvh.ray_intersect_bvh_plain(h, o, d, active, stats)
    return t, ids, uv


class PlainRoute:
    """Sends K1's, K5's and K6's launches to their plain versions, on the
    card's tensors, while active (by replacing the module global the
    routing calls, ``bvh.walk_cuda``), so a render can be repeated with
    only the kernels swapped."""

    def __enter__(self):
        from psdr_jit_tpu_torch.ops import bvh

        self.saved = bvh.walk_cuda

        def plain(tree, o, d, active, kernel="K6"):
            return (k6_plain if kernel == "K6" else k5_plain)(tree, o, d,
                                                              active)
        bvh.walk_cuda = plain
        return self

    def __exit__(self, *exc):
        from psdr_jit_tpu_torch.ops import bvh

        bvh.walk_cuda = self.saved


def intersect_record(name, source, replaces, calls, plain, tri=None):
    """Hold each recorded launch ``(fn, args, (t, id, uv))`` of a closest
    hit (``args`` ending in ``o, d, active``: K1's sweep or a walk's
    ``(tree, o, d, active)``) against its plain version on the same inputs
    and time both: ``(record for the kernels' JSON, agreement, needed
    tests, each launch's ms)``, the bound from ``hit_bound_terms`` over the
    triangles ``tri = (p0, e1, e2)`` (by default the tree's)."""
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
        tris = tri or (args[0].tri4[:, 0:3], args[0].tri4[:, 3:6],
                       args[0].tri4[:, 6:9])
        b, f, _ = hit_bound_terms(*tris, *args[-3:-1], out[0], args[-1])
        nbytes += b
        flops += f
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
    k5_src = k6_src = "psdr_jit_tpu_torch/csrc/bvh.cu"
    k5_rep, k6_rep = ("psdr_jit_tpu/ops/intersect_pallas.py:234",
                      "psdr_jit_tpu/ops/bvh.py:309")

    def cluster_tests(tree, o, d, t, act):
        """The tests of the parent K5's shape: the 16-triangle clusters a
        ray enters before its hit, times 16 (``needed_tests``)."""
        _, box = ix.pack_triangles(tree.tri4[:, 0:3], tree.tri4[:, 3:6],
                                   tree.tri4[:, 6:9])
        lo, hi = ix.widen_boxes(box[:3].T, box[3:].T)
        return needed_tests(lo, hi, ix.CLUSTER, o, d, t, act)

    k5_walk = functools.partial(bvh.walk_cuda, kernel="K5")

    def k5_check(phase, sd, ties: bool):
        """[K5] and [K5-top]: K5 on ``CHECK_RAYS`` mixed rays against the
        scene data ``sd``, bit for bit against its plain version (and, with
        ``ties``, on the tie case in two visit orders). Returns the K5
        record for the kernels' JSON."""
        f = sd.tri.p0.shape[0]
        require(ix.K1_MAX_TRIS < f <= ix.K5_MAX_TRIS,
                f"{phase}: scene out of K5's range")
        o, d, act = mixed_rays(sd, CHECK_RAYS, gen, dev)
        args = (sd.bvh, o, d, act)
        rec, a, tests, _ = intersect_record(
            "K5", k5_src, k5_rep,
            [(k5_walk, args, k5_walk(*args))], k5_plain)
        own_tests, visits = walk_counted(args, "K5")
        out = k5_walk(*args)
        extra = {}
        if ties:
            tp0, te1, te2, tro, trd, low = (torch.from_numpy(x).to(dev)
                                            for x in tie_case(3000))
            tie_tree = ix.routing_tree(tp0, te1, te2)
            tie_act = torch.ones(tro.shape[0], dtype=torch.bool, device=dev)
            tie_ref = k5_plain(tie_tree, tro, trd, tie_act)
            tie_ok = all(hit_agreement(
                k5_walk(tr, tro, trd, tie_act), tie_ref)["bitwise"]
                for tr in (tie_tree, swapped_children(tie_tree)))
            tie_hits = int((tie_ref[1] == low.to(torch.int32)).sum())
            extra = dict(tie_case_bitwise=tie_ok,
                         tie_rays_on_lowest_id=tie_hits)
            require(tie_ok, f"{phase}: the tie case differs from the plain "
                    "version")
            require(tie_hits > tro.shape[0] // 2,
                    f"{phase}: the tie case has few ties")
        log(phase, rays=o.shape[0], triangles=f, leaf=ix.SAH_LEAF,
            depth=sd.bvh.depth, nodes=sd.bvh.node.shape[0],
            ptxas=ptxas_report("walk_kernel"),
            bitwise_equal_to_plain=a["bitwise"],
            id_match=f"{a['id_match']:.6f}", mismatches=a["mismatches"],
            mismatches_are_ties=a["ties_ok"],
            t_max_rel=f"{a['t_max_rel']:.3e}", **extra, ms=f"{rec['ms']:.4f}",
            plain_ms=f"{rec['plain_ms']:.4f}",
            tests_per_ray=f"{own_tests / o.shape[0]:.1f}",
            node_visits_per_ray=f"{visits / o.shape[0]:.1f}",
            parent_shape_tests_per_ray=(
                f"{cluster_tests(sd.bvh, o, d, out[0], act) / o.shape[0]:.1f}"),
            needed_tests_per_ray=f"{tests / o.shape[0]:.1f}",
            bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"])
        require(a["bitwise"], f"{phase}: not bitwise equal to the plain "
                "version")
        require(sd.bvh.depth <= bvh.STACK, f"{phase}: the tree does not fit "
                "the walk's stack")
        return rec

    # ---- [K5]: the 1,292-triangle gallery; [K5-top]: 3,852 triangles -------
    mid = pt.Scene.from_arrays(gallery_arrays(W, H, SPP, 4, 2), device=dev)
    sd5 = mid.configure()
    f5 = sd5.tri.p0.shape[0]
    k5_check("K5", sd5, True)
    top = pt.Scene.from_arrays(gallery_arrays(64, 64, 32, 12, 2), device=dev)
    k5_top = k5_check("K5-top", top.configure(), False)

    # ---- [K6]: the 102,412-triangle gallery ----------------------------------
    big = pt.Scene.from_arrays(gallery_arrays(W, H, SPP), device=dev)
    sd6 = big.configure()
    f6 = sd6.tri.p0.shape[0]
    require(f6 > ix.K5_MAX_TRIS, "K6 scene out of range")
    o, d, act = mixed_rays(sd6, CHECK_RAYS, gen, dev)
    torch.cuda.synchronize()
    h, tree_ms = _synced_ms(lambda: sd6.bvh)
    out = bvh.walk_cuda(h, o, d, act)
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
    tie_ok = all(hit_agreement(bvh.walk_cuda(tr, tro, trd, tie_act),
                               tie_ref)["bitwise"]
                 for tr in (tie_tree, swapped_children(tie_tree)))
    tie_hits = int((tie_ref[1] == low.to(torch.int32)).sum())
    k6_ms = cuda_ms(lambda: bvh.walk_cuda(h, o, d, act), 10)
    k6_sub_ms = cuda_ms(lambda: bvh.walk_cuda(*sub_args), 10)
    tests = hit_bound_terms(h.tri4[:, 0:3], h.tri4[:, 3:6], h.tri4[:, 6:9],
                            o, d, out[0], act)[2]
    own_tests, visits = walk_counted((h, o, d, act), "K6")
    log("K6", rays=o.shape[0], triangles=f6, leaf=bvh.LEAF, depth=h.depth,
        ptxas=ptxas_report("walk_kernel"),
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
        launches = rebuilds("main-path-large", _cuda.LAUNCHES, plain.hits,
                            0, 0)
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
    with KernelCalls({"K6": (bvh, "walk_cuda")}) as rec_calls:
        integ.renderC(big, 0, seed=SEED)
        torch.cuda.synchronize()
    calls = rec_calls.calls["K6"]
    require(len(calls) == (1 + 2 * LARGE_DEPTH) * chunks,
            "large-frame: K6 launches != 5 a chunk")
    k6, a, tests, k6_launch_ms = intersect_record(
        "K6 tree traversal", k6_src, k6_rep, calls, k6_plain)
    require_agreement("large-frame", a)
    require(a["bitwise"], "large-frame: K6 not bitwise equal to its plain "
            "traversal")
    own = [sum(x) for x in zip(*(walk_counted(c[1], "K6")
                                 for c in calls))]
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
            {"K5": (bvh, "walk_cuda")}) as rec_calls:
        _cuda.reset_launches()
        img5 = integ.renderC(mid, 0, seed=SEED)
        torch.cuda.synchronize()
        launches5 = rebuilds("K5-frame", _cuda.LAUNCHES, plain.hits, 0, 0)
    with PlainRoute():
        img5_plain = integ.renderC(mid, 0, seed=SEED)
    k5_calls = rec_calls.calls["K5"]
    k5, a, tests, _ = intersect_record(
        "K5 tree walk, surface-area tree", k5_src, k5_rep, k5_calls,
        k5_plain)
    own5 = [sum(x) for x in zip(*(walk_counted(c[1], "K5")
                                  for c in k5_calls))]
    n_rays5 = sum(c[2][0].shape[0] for c in k5_calls)
    k5_frame_ms = wall_ms(lambda: integ.renderC(mid, 0, seed=SEED), 3)
    log("K5-frame", triangles=f5, K5_LAUNCHES=launches5["K5"],
        chunks=chunks, plain_calls=plain.count,
        bitwise_equal_to_plain_render=torch.equal(img5, img5_plain),
        image_rel_l1_vs_plain=f"{rel_l1(img5, img5_plain):.3e}",
        launches_bitwise=a["bitwise"], K5_ms=f"{k5['ms']:.3f}",
        K5_plain_ms=f"{k5['plain_ms']:.1f}",
        K5_bound_ms=f"{k5['bound_ms']:.4f}", K5_bound_by=k5["bound_by"],
        tests_per_ray=f"{own5[0] / n_rays5:.1f}",
        node_visits_per_ray=f"{own5[1] / n_rays5:.1f}",
        needed_tests_per_ray=f"{tests / n_rays5:.1f}",
        K5_top_ms=f"{k5_top['ms']:.4f}", ms=f"{k5_frame_ms:.2f}")
    require(launches5["K5"] == (1 + 2 * LARGE_DEPTH) * chunks,
            "K5-frame: K5 launches != 5 a chunk")
    require(all(v == 0 for k, v in launches5.items() if k != "K5"),
            "K5-frame: another kernel ran")
    require(plain.count == 0, "K5-frame: a plain version ran")
    require(bool(torch.isfinite(img5).all()) and float(img5.sum()) > 0,
            "K5-frame: non-finite or black image")
    require(rel_l1(img5, img5_plain) < 1e-6,
            "K5-frame: the render differs from its plain-version render")
    require(a["bitwise"], "K5-frame: K5 not bitwise equal to its plain "
            "version")
    kernels["K5"] = k5
    return {"K5": launches5["K5"], "K6": launches["K6"]}


def walk_counted(args, kernel):
    """A walk's own (triangle tests, node visits) for a launch's inputs
    ``args = (tree, o, d, active)``, from its counting build, outside any
    counted run."""
    import torch
    from psdr_jit_tpu_torch.ops import bvh

    c = torch.zeros((args[1].shape[0], 2), dtype=torch.int32,
                    device=args[1].device)
    bvh.walk_cuda(*args, counts=c, kernel=kernel)
    return c.sum(0).tolist()


def k1_launcher(p0, e1, e2):
    """``(K1's kernel as fn(o, d, active) -> (t, id, uv), its table or tree,
    its name)`` for these triangles, as the routing takes it: the sweep of a
    packed table up to ``SWEEP_MAX_TRIS`` triangles, above the walk of the
    area-split tree."""
    import functools

    from psdr_jit_tpu_torch.ops import bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    if p0.shape[0] <= ix.SWEEP_MAX_TRIS:
        tab, box = ix.pack_triangles(p0, e1, e2)
        return functools.partial(ix.sweep_cuda, tab, box), (tab, box), "sweep"
    tree = ix.routing_tree(p0, e1, e2)
    return (functools.partial(bvh.walk_cuda, tree, kernel="K1"), tree,
            "walk")


def k1_phase(phase, sd, dev, gen, ties: bool) -> dict:
    """[K1] (the Cornell box, 32 triangles, swept) and [K1-492]
    (``K1_GALLERY``, walked): K1 on each of its ray families
    (``k1_families``), alone, bit for bit against its plain version, with
    and without the dead lanes of (e); the check set (a)-(d) in one launch;
    with ``ties``, exact ties through the sweep and the walk. Returns the
    check set's record for the kernels' JSON."""
    import torch
    from psdr_jit_tpu_torch.ops import bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    tri = sd.tri
    p0, e1, e2 = tri.p0, tri.e1, tri.e2
    (k1, table, route), build_ms = _synced_ms(lambda: k1_launcher(p0, e1,
                                                                  e2))

    def plain(o, d, act):
        ids, _, uv, t = ix.ray_intersect_brute(p0, e1, e2, o, d, act)
        return t, ids, uv

    fams = k1_families(sd, gen, dev)
    fams["edge_all_active"] = (*fams["edge"][:2],
                               torch.ones_like(fams["edge"][2]))
    fams["check_set"] = tuple(torch.cat([fams[k][j] for k in (
        "picks", "camera", "on_plane", "random")]).contiguous()
        for j in range(3))
    ms, bitwise = {}, True
    for name, (o, d, act) in fams.items():
        a = hit_agreement(k1(o, d, act), plain(o, d, act))
        bitwise = bitwise and a["bitwise"]
        ms[name] = cuda_ms(lambda: k1(o, d, act), 20)
    o, d, act = fams["check_set"]
    src = ("psdr_jit_tpu_torch/csrc/intersect.cu" if route == "sweep"
           else "psdr_jit_tpu_torch/csrc/bvh.cu")
    rec, a, tests, _ = intersect_record(
        f"K1 closest hit ({route})", src,
        "psdr_jit_tpu/ops/intersect_pallas.py:267",
        [(k1, (o, d, act), k1(o, d, act))], plain, (p0, e1, e2))
    rec["ms"] = ms["check_set"]
    n = o.shape[0]
    if route == "sweep":  # the queued sweep's plain model
        stats = {}
        ix.sweep_grouped_plain(table[0], o.unbind(-1), d.unbind(-1), 2,
                               stats, live=act, compact=True)
        own = dict(tests_per_ray=f"{stats['tri_tests'] / n:.2f}",
                   warp_tests_per_ray=f"{32 * stats['warp_tri_tests'] / n:.2f}",
                   box_tests_per_ray=f"{stats['box_tests'] / n:.2f}",
                   ptxas=ptxas_report("sweep_kernel"))
    else:
        own_tests, visits = walk_counted((table, o, d, act), "K1")
        own = dict(tests_per_ray=f"{own_tests / n:.2f}",
                   node_visits_per_ray=f"{visits / n:.2f}",
                   depth=table.depth, nodes=table.node.shape[0],
                   ptxas=ptxas_report("walk_kernel"))
    if ties:  # exact ties: equal distances, lowest id
        for n_tri, n_pairs in ((160, 16), (496, 40)):
            tp0, te1, te2, tro, trd, low = (
                torch.from_numpy(x).to(dev)
                for x in tie_case(n_tri=n_tri, n_pairs=n_pairs))
            fn, tab, how = k1_launcher(tp0, te1, te2)
            tie_act = torch.ones(tro.shape[0], dtype=torch.bool, device=dev)
            tie_ref = ix.ray_intersect_brute(tp0, te1, te2, tro, trd)
            tie_ref = (tie_ref[3], tie_ref[0], tie_ref[2])
            outs = [fn(tro, trd, tie_act)]
            if how == "walk":  # and in the other visit order
                outs.append(bvh.walk_cuda(swapped_children(tab), tro, trd,
                                          tie_act, kernel="K1"))
            tie_ok = all(hit_agreement(x, tie_ref)["bitwise"] for x in outs)
            tie_hits = int((tie_ref[1] == low.to(torch.int32)).sum())
            own[f"tie_case_{n_tri}_{how}_bitwise"] = tie_ok
            own[f"tie_case_{n_tri}_rays_on_lowest_id"] = tie_hits
            require(tie_ok, f"{phase}: the tie case of {n_tri} triangles "
                    "differs from the plain version")
            require(tie_hits > tro.shape[0] // 2,
                    f"{phase}: the tie case has few ties")
    dead_share = ms["edge"] / ms["edge_all_active"]
    log(phase, triangles=p0.shape[0], route=route,
        table_or_tree_ms=f"{build_ms:.3f}",
        bitwise_equal_to_plain=bitwise and a["bitwise"],
        **{f"ms_{k}": f"{v:.4f}" for k, v in ms.items()},
        edge_dead_over_all_active=f"{dead_share:.3f}",
        plain_ms=f"{rec['plain_ms']:.4f}", **own,
        needed_tests_per_ray=f"{tests / n:.2f}",
        bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"])
    require(bitwise and a["bitwise"], f"{phase}: not bitwise equal to the "
            "plain version")
    rec["standin_e_ms"] = ms["edge"]
    return rec


def k1_frame_phase(dev) -> int:
    """[K1-frame]: ``PathTracer(2).renderC`` of the 492-triangle gallery
    (``K1_GALLERY``, routed through the general Li) with K1's launches
    recorded, each held against its plain version bit for bit; K1 must
    launch five times a chunk and nothing else run, and the image must
    equal the render with K1 replaced by its plain version. Returns K1's
    launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    g = K1_GALLERY
    sc = pt.Scene.from_arrays(gallery_arrays(**g), device=dev)
    sd = sc.configure()
    f = sd.tri.p0.shape[0]
    require(f <= ix.K1_MAX_TRIS, "K1-frame: scene out of K1's range")
    _, build_ms = _synced_ms(lambda: sd.bvh)
    integ = pt.PathTracer(LARGE_DEPTH)
    n_pix = g["width"] * g["height"]
    chunks = -(-n_pix // max(base.GENERAL_CHUNK_LANES // g["spp"], 1))
    torch.cuda.synchronize()
    with PlainCalls() as plain, KernelCalls(
            {"K1": (bvh, "walk_cuda")}) as rec_calls:
        _cuda.reset_launches()
        img = integ.renderC(sc, 0, seed=SEED)
        torch.cuda.synchronize()
        launches = rebuilds("K1-frame", _cuda.LAUNCHES, plain.hits, 0, 0)
    with PlainRoute():
        img_plain = integ.renderC(sc, 0, seed=SEED)
    calls = rec_calls.calls["K1"]
    k1, a, tests, launch_ms = intersect_record(
        "K1 tree walk, surface-area tree", "psdr_jit_tpu_torch/csrc/bvh.cu",
        "psdr_jit_tpu/ops/intersect_pallas.py:267", calls, k5_plain)
    own = [sum(x) for x in zip(*(walk_counted(c[1], "K1") for c in calls))]
    n_rays = sum(c[2][0].shape[0] for c in calls)
    live = sum(int(c[1][3].sum()) for c in calls)
    frame_ms = wall_ms(lambda: integ.renderC(sc, 0, seed=SEED), 3)
    log("K1-frame", triangles=f, size=f"{g['width']}x{g['height']}",
        spp=g["spp"], depth=LARGE_DEPTH, K1_LAUNCHES=launches["K1"],
        chunks=chunks, plain_calls=plain.count,
        tree_build_ms=f"{build_ms:.3f}",
        bitwise_equal_to_plain_render=torch.equal(img, img_plain),
        launches_bitwise=a["bitwise"], K1_ms=f"{k1['ms']:.4f}",
        K1_launch_ms=",".join(f"{x:.4f}" for x in launch_ms),
        K1_plain_ms=f"{k1['plain_ms']:.1f}",
        K1_bound_ms=f"{k1['bound_ms']:.4f}", K1_bound_by=k1["bound_by"],
        active_share=f"{live / n_rays:.3f}",
        tests_per_ray=f"{own[0] / n_rays:.2f}",
        node_visits_per_ray=f"{own[1] / n_rays:.2f}",
        needed_tests_per_ray=f"{tests / n_rays:.2f}", ms=f"{frame_ms:.2f}")
    require(launches["K1"] == (1 + 2 * LARGE_DEPTH) * chunks,
            "K1-frame: K1 launches != 5 a chunk")
    require(all(v == 0 for k, v in launches.items() if k != "K1"),
            "K1-frame: another kernel ran")
    require(plain.count == 0, "K1-frame: a plain version ran")
    require(bool(torch.isfinite(img).all()) and float(img.sum()) > 0,
            "K1-frame: non-finite or black image")
    require(torch.equal(img, img_plain),
            "K1-frame: the render differs from its plain-version render")
    require(a["bitwise"], "K1-frame: K1 not bitwise equal to its plain "
            "version")
    return launches["K1"]


def train_step_fn(integrator, scene, **kwargs):
    """A closure that takes one training step on ``scene`` (``kwargs``:
    ``warp=``, the secondary-edge guiding table)."""
    params, apply_params, pixel_loss = train_setup(scene)
    return lambda: integrator.loss_and_grad(scene, params, apply_params,
                                            pixel_loss, 0, SEED, **kwargs)


def se_k1_launches(n_pix: int, sppse: int) -> int:
    """K1's launches in the secondary-edge pass of a step: its chunks
    times the three launches of a chunk (the visibility, receiver and
    camera rays)."""
    from psdr_jit_tpu_torch.integrator import base

    chunks = -(-n_pix * sppse // base.SE_CHUNK_LANES)
    return chunks * 3


def se_k1_phase(arrays, dev, gen, kernels):
    """[SE-K1]: the first chunk of the secondary-edge pass of the 512x512
    sppse-32 step on the box with each K1 launch recorded (the visibility
    and receiver rays, the camera rays), each held against its plain
    version bit for bit and timed as it ran and with every finite ray
    active; each ray set's dead share; K1's bound for the chunk; the
    stand-in (e) (``edge_rays``, 43% dead) at the same ray count."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.core.sampler import Sampler
    from psdr_jit_tpu_torch.integrator import base, edge
    from psdr_jit_tpu_torch.ops import intersect as ix

    sc = pt.Scene.from_arrays(arrays, device=dev)
    sc.opts.sppse = SPPSE
    sd = sc.configure()
    n = min(base.SE_CHUNK_LANES, sc.opts.num_pixels * SPPSE)
    sampler = Sampler(SEED + base.STREAM_SECONDARY,
                      torch.arange(n, device=dev))
    sample3 = sampler.next_nd(3)
    with KernelCalls({"K1": (ix, "sweep_cuda")}) as rec:
        idx, value = edge.eval_secondary_edge(sd, sd.sensors[0], sample3,
                                              diff=True)
        torch.cuda.synchronize()
    calls = rec.calls["K1"]
    require(len(calls) == se_k1_launches(n, 1),
            "SE-K1: K1 launches of a chunk != the routing's")
    tri = tuple(getattr(sd.tri, k).detach() for k in ("p0", "e1", "e2"))

    def plain(tab, box, o, d, act):
        ids, _, uv, t = ix.ray_intersect_brute(*tri, o, d, act)
        return t, ids, uv

    k1, a, tests, launch_ms = intersect_record(
        "K1 closest hit (sweep), secondary-edge rays",
        "psdr_jit_tpu_torch/csrc/intersect.cu",
        "psdr_jit_tpu/ops/intersect_pallas.py:267", calls, plain, tri)
    acts = [c[1][4] for c in calls]
    sets = dict(zip(("visibility", "receiver", "camera"), acts))
    all_ms = []
    for fn, args, _ in calls:
        o, d = args[2], args[3]
        finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
        all_ms.append(cuda_ms(lambda: fn(*args[:4], finite), 3))
    n_rays = sum(c[1][2].shape[0] for c in calls)
    so, sdir, sact = edge_rays(sd, n_rays, gen, dev)
    tab, box = calls[0][1][:2]
    stand_ms = cuda_ms(lambda: ix.sweep_cuda(tab, box, so, sdir, sact), 3)
    stand_all_ms = cuda_ms(lambda: ix.sweep_cuda(
        tab, box, so, sdir, torch.ones_like(sact)), 3)
    live = sum(int(x.sum()) for x in acts)
    log("SE-K1", lanes=n, launches=len(calls), rays=n_rays,
        bitwise_equal_to_plain=a["bitwise"],
        **{f"dead_share_{k}": f"{1 - float(v.float().mean()):.4f}"
           for k, v in sets.items()},
        valid_lanes=int((idx >= 0).sum()),
        launch_ms=",".join(f"{x:.4f}" for x in launch_ms),
        all_active_ms=",".join(f"{x:.4f}" for x in all_ms),
        ms=f"{k1['ms']:.4f}", plain_ms=f"{k1['plain_ms']:.1f}",
        bound_ms=f"{k1['bound_ms']:.4f}", bound_by=k1["bound_by"],
        needed_tests_per_live_ray=f"{tests / max(live, 1):.2f}",
        ns_per_ray=f"{k1['ms'] * 1e6 / n_rays:.4f}",
        standin_e_ms=f"{stand_ms:.4f}",
        standin_e_all_active_ms=f"{stand_all_ms:.4f}",
        standin_ns_per_ray=f"{stand_ms * 1e6 / n_rays:.4f}")
    require(a["bitwise"], "SE-K1: K1 not bitwise equal to its plain "
            "version on the secondary-edge rays")
    require(bool(torch.isfinite(value).all()), "SE-K1: non-finite values")
    require(int((idx >= 0).sum()) > 0, "SE-K1: no valid boundary sample")
    kernels["K1"].update(
        se_chunk_ms=k1["ms"], se_chunk_plain_ms=k1["plain_ms"],
        se_chunk_bound_ms=k1["bound_ms"], se_chunk_rays=n_rays,
        max_abs_err=max(kernels["K1"]["max_abs_err"], k1["max_abs_err"]))


def compare_steps(phase, arrays, dev, opts, **kwargs) -> dict:
    """One training step at ``opts`` through the kernels and, on the CPU,
    through the plain versions (``kwargs`` to both): loss and image within
    1e-4, each gradient within 1e-3 rel L1, every parameter moved. Returns
    the kernels' gradients."""
    import torch
    import psdr_jit_tpu_torch as pt

    steps = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        small = pt.Scene.from_arrays(arrays, device=device)
        small.opts = opts
        kw = {k: v(device) for k, v in kwargs.items()}
        step = train_step_fn(pt.PathTracer(DEPTH), small, **kw)
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
    log(phase, spp=opts.spp, sppe=opts.sppe, sppse=opts.sppse, depth=DEPTH,
        loss_rel=f"{loss_rel:.3e}", image_rel_l1=f"{img_rel:.3e}",
        grad_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in g_rel.items()),
        ms=f"{ms_k:.1f}", plain_cpu_ms=f"{ms_p:.1f}")
    require(loss_rel < 1e-4 and img_rel < 1e-4,
            f"{phase}: loss or image differs from the plain path")
    require(all(v < 1e-3 for v in g_rel.values()),
            f"{phase}: a gradient differs from the plain path by >= 1e-3")
    require(all(float(g.abs().sum()) > 0 for g in g_p.values()),
            f"{phase}: a parameter got no gradient")
    return g_k


def renderd_64_phase(arrays, dev):
    """[renderD-64]: renderD of the box at 64x64, spp 8, sppe 8, sppse 8,
    ``PathTracer(3)``, through the kernels and, on the CPU, through the
    plain versions: the primal within 1e-4 rel L1; the forward tangents
    along the light's translation ``tx`` and a fixed direction of the
    block's vertex offsets ``dv`` within 1e-3; the reverse gradients of
    ``sum(w * renderD)`` for the four parameters within 1e-3."""
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt

    out = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        sc = pt.Scene.from_arrays(arrays, device=device)
        sc.opts = pt.RenderOption(64, 64, 8, 8, 8)
        setup = train_setup(sc)
        integ = pt.PathTracer(DEPTH)
        n_v = sc.meshes[2].num_vertices
        dv = np.random.default_rng(2).standard_normal((n_v, 3)).astype(
            np.float32)
        w = renderd_weight(sc.opts.num_pixels, device)
        t0 = time.perf_counter()
        primal, t_tx = renderd_tangent(integ, sc, setup, "tx", 1.0)
        _, t_dv = renderd_tangent(integ, sc, setup, "dv", dv)
        grads = renderd_grads(integ, sc, setup, w)
        out[name] = dict(primal=primal.cpu(), tx=t_tx.cpu(), dv=t_dv.cpu(),
                         grads={k: v.cpu() for k, v in grads.items()},
                         ms=(time.perf_counter() - t0) * 1e3)
    k, p = out["kernels"], out["plain"]
    rels = {"primal": rel_l1(k["primal"], p["primal"]),
            "tangent_tx": rel_l1(k["tx"], p["tx"]),
            "tangent_dv": rel_l1(k["dv"], p["dv"]),
            **{f"grad_{n}": rel_l1(k["grads"][n], p["grads"][n])
               for n in p["grads"]}}
    log("renderD-64", spp=8, sppe=8, sppse=8, depth=DEPTH,
        rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
        ms=f"{k['ms']:.1f}", plain_cpu_ms=f"{p['ms']:.1f}")
    require(rels["primal"] < 1e-4, "renderD-64: the primal differs from "
            "the plain path")
    require(all(v < 1e-3 for n, v in rels.items() if n != "primal"),
            "renderD-64: a tangent or gradient differs from the plain path "
            "by >= 1e-3")
    require(all(float(x.abs().sum()) > 0 for x in
                [p["tx"], p["dv"], *p["grads"].values()]),
            "renderD-64: a tangent or gradient is zero")


def renderd_weight(n_pix: int, device):
    """The fixed random pixel weights ``w`` of ``sum(w * renderD)``."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(1).uniform(
        0.25, 1.0, (n_pix, 3)).astype(np.float32)).to(device)


def renderd_phase(arrays, dev, frame) -> dict:
    """[main-path-renderD] and [renderD]: ``PathTracer(3).renderD`` of the
    box at 512x512, spp 32, sppe 32, sppse 32. Forward mode along the
    light's translation ``tx`` with the launch counts set to 0 just
    before it and read just after (K1: 7 a chunk of the interior, the
    attached general Li, and 3 a secondary-edge chunk; K2 pair: one a
    primary-edge chunk; nothing else, no plain version); along the
    radiance scaled by a dual scalar ``s`` at 1, whose tangent is the
    primal (every interior path is linear in the one light's radiance,
    and the edge terms' radiance is detached); reverse mode of ``sum(w *
    renderD)`` for the four parameters, held to the forward tangent by the
    adjoint identity and to ``loss_and_grad`` of the same linear loss.
    ``frame`` is the main path's renderC image. Returns the launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda

    sc = pt.Scene.from_arrays(arrays, device=dev)
    sc.opts.sppe, sc.opts.sppse = SPPE, SPPSE
    sc.configure()
    W, H, spp = sc.opts.width, sc.opts.height, sc.opts.spp
    n_pix = W * H
    integ = pt.PathTracer(DEPTH)
    setup = train_setup(sc)
    w = renderd_weight(n_pix, dev)
    n_int = -(-n_pix // max(base.DIFF_CHUNK_LANES // spp, 1))
    n_pe = -(-n_pix * SPPE // base.TRAIN_CHUNK_LANES)
    n_se = -(-n_pix * SPPSE // base.SE_CHUNK_LANES)
    k1_want = n_int * (1 + 2 * DEPTH) + n_se * 3
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        primal, t_tx = renderd_tangent(integ, sc, setup, "tx", 1.0)
        torch.cuda.synchronize()
        # every hit set has a tangent but the secondary-edge pass's two
        # detached ones
        launches = rebuilds("main-path-renderD", _cuda.LAUNCHES, plain.hits,
                            n_int * (1 + 2 * DEPTH) + n_se, 0)
    require(plain.hits == k1_want, "renderD: hit sets rebuilt != 7 an "
            "interior chunk + 3 a secondary-edge chunk")
    log("main-path-renderD", **{f"{k}_LAUNCHES": v for k, v in
                                launches.items()},
        K1_expected=k1_want, K2_pair_expected=n_pe, interior_chunks=n_int,
        primary_edge_chunks=n_pe, secondary_edge_chunks=n_se,
        plain_calls=plain.count)
    require(launches["K1"] == k1_want, "renderD: K1 launches != 7 an "
            "interior chunk + 3 a secondary-edge chunk")
    require(launches["K2-pair"] == n_pe,
            "renderD: K2-pair launches != primary-edge chunks")
    require(all(v == 0 for k, v in launches.items()
                if k not in ("K1", "K2-pair")),
            "renderD: another kernel ran (K2, K2-stash, K3, K4, K5 or K6)")
    require(plain.count == 0, "renderD: a plain version ran")
    require(tuple(primal.shape) == (n_pix, 3)
            and bool(torch.isfinite(primal).all()),
            "renderD: non-finite or misshapen image")
    require(bool(torch.isfinite(t_tx).all()) and float(t_tx.abs().sum()) > 0,
            "renderD: the tx tangent is non-finite or zero")
    rel = (primal - frame).abs() / (frame.abs() + 1e-4)
    close = float((rel < 1e-3).float().mean())
    mean_rel = abs(float(primal.mean()) / float(frame.mean()) - 1.0)
    require(close > 0.9 and mean_rel < 1e-2,
            "renderD: the primal differs from renderC's frame")
    rad = setup[0]["rad"]
    _, t_s = renderd_tangent(integ, sc, setup, "rad", rad)  # rad * s
    s_rel = rel_l1(t_s, primal)
    require(s_rel < 1e-5, "renderD: the tangent along the radiance's scale "
            "is not the primal")

    # reverse mode, and the run-to-run spread of both modes (float atomics)
    grads = renderd_grads(integ, sc, setup, w)
    grads2 = renderd_grads(integ, sc, setup, w)
    _, t_tx2 = renderd_tangent(integ, sc, setup, "tx", 1.0)
    lhs = float((w.double() * t_tx.double()).sum())
    lhs2 = float((w.double() * t_tx2.double()).sum())
    rhs = float(grads["tx"])
    spread = max(abs(lhs2 - lhs) / abs(lhs),
                 abs(float(grads2["tx"]) - rhs) / abs(rhs),
                 *(rel_l1(grads2[k], grads[k]) for k in grads))
    adj = abs(lhs - rhs) / abs(rhs)
    require(adj <= 1e-4 + spread, "renderD: sum(w * tangent_tx) != d/dtx "
            "of sum(w * renderD) beyond 1e-4 + the run-to-run spread")
    require(all(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
                for g in grads.values()),
            "renderD: a reverse gradient is non-finite or zero")
    params, apply_params, _ = setup
    _, g_f, _ = integ.loss_and_grad(
        sc, params, apply_params, lambda rows, pix: (rows * w[pix]).sum(-1),
        0, SEED)
    fused = {k: rel_l1(grads[k], g_f[k]) for k in grads}
    require(all(fused[k] < RENDERD_FUSED_RTOL[k] for k in fused),
            "renderD: a reverse gradient differs from loss_and_grad's "
            "beyond RENDERD_FUSED_RTOL")

    # times and peak memory
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_ms = wall_ms(lambda: renderd_tangent(integ, sc, setup, "tx", 1.0), 3)
    fwd_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    rev_ms = wall_ms(lambda: renderd_grads(integ, sc, setup, w), 3)
    rev_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rays = n_pix * (spp * (1 + 2 * DEPTH) + SPPE * 2 * (1 + 2 * DEPTH)
                    + SPPSE * 3)
    log("renderD", size=f"{W}x{H}", spp=spp, sppe=SPPE, sppse=SPPSE,
        depth=DEPTH, primal_mean=f"{float(primal.mean()):.6f}",
        frac_pixels_rel_below_1e3_vs_renderC=f"{close:.4f}",
        mean_rel_vs_renderC=f"{mean_rel:.3e}",
        tangent_tx_l1=f"{float(t_tx.abs().sum()):.4e}",
        radiance_scale_tangent_rel_l1_vs_primal=f"{s_rel:.3e}",
        adjoint_rel=f"{adj:.3e}", run_to_run_rel=f"{spread:.3e}",
        grad_rel_l1_vs_loss_and_grad=",".join(
            f"{k}:{v:.3e}" for k, v in fused.items()),
        forward_ms=f"{fwd_ms:.2f}", forward_peak_gb=f"{fwd_gb:.3f}",
        reverse_ms=f"{rev_ms:.2f}", reverse_peak_gb=f"{rev_gb:.3f}",
        rays=rays, forward_mrays_per_s=f"{rays / fwd_ms / 1e3:.1f}",
        reverse_mrays_per_s=f"{rays / rev_ms / 1e3:.1f}")
    return launches


def renderd_k5_phase(dev) -> dict:
    """[renderD-K5]: renderD of the 1,292-triangle gallery (outside K2's
    and K3's scope: the interior, the primary edges' two sequential Li
    and the secondary edges all trace through K5) at 64x64, spp 4, sppe
    4, sppse 4, ``PathTracer(2)``: the forward tangent along a sphere's
    translation against the CPU's plain path, with the launch counts
    read around the card's render; then timed at 256x256, spp 4."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda

    def sphere_tangent(device, size, sppe):
        sc = pt.Scene.from_arrays(gallery_arrays(size, size, 4, 4, 2),
                                  device=device)
        sc.opts = pt.RenderOption(size, size, 4, sppe, sppe)
        sc.configure()
        mesh = sc.meshes[6]  # the first sphere
        base_m = mesh.to_world_raw.clone()

        def set_tx(v):
            mesh.to_world_raw = base_m + torch.nn.functional.pad(
                v.reshape(1, 1), (3, 0, 0, 3))

        integ = pt.PathTracer(LARGE_DEPTH)
        return sc, lambda: forward_mode(integ, sc, set_tx, torch.zeros(()),
                                        1.0)

    sc, run = sphere_tangent(dev, 64, 4)
    f = sc.data.tri.p0.shape[0]
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        primal, tangent = run()
        torch.cuda.synchronize()
        launches = rebuilds("renderD-K5", _cuda.LAUNCHES, plain.hits,
                            vjp=0)
    _, run_cpu = sphere_tangent(torch.device("cpu"), 64, 4)
    p_cpu, t_cpu = run_cpu()
    n_lanes = 64 * 64 * 4
    per_li = 1 + 2 * LARGE_DEPTH
    k5_want = (-(-n_lanes // base.DIFF_CHUNK_LANES) * per_li
               + -(-n_lanes // base.TRAIN_CHUNK_LANES) * 2 * per_li
               + -(-n_lanes // base.SE_CHUNK_LANES) * 3)
    p_rel, t_rel = rel_l1(primal.cpu(), p_cpu), rel_l1(tangent.cpu(), t_cpu)
    _, run_256 = sphere_tangent(dev, 256, 4)
    ms = wall_ms(run_256, 3)
    log("renderD-K5", triangles=f, size="64x64", spp=4, sppe=4, sppse=4,
        depth=LARGE_DEPTH, **{f"{k}_LAUNCHES": v for k, v in
                              launches.items()},
        K5_expected=k5_want, plain_calls=plain.count,
        primal_rel_l1_vs_plain=f"{p_rel:.3e}",
        tangent_rel_l1_vs_plain=f"{t_rel:.3e}",
        tangent_l1=f"{float(t_cpu.abs().sum()):.4e}",
        ms_256x256_spp4=f"{ms:.2f}")
    require(launches["K5"] == k5_want and launches["K5"] > 0,
            "renderD-K5: K5 launches != 5 an interior chunk + 10 a "
            "primary-edge chunk + 3 a secondary-edge chunk")
    require(all(v == 0 for k, v in launches.items() if k != "K5"),
            "renderD-K5: another kernel ran (K2-pair among them)")
    require(plain.count == 0, "renderD-K5: a plain version ran")
    require(float(t_cpu.abs().sum()) > 0, "renderD-K5: zero tangent")
    require(p_rel < 1e-4 and t_rel < 1e-3,
            "renderD-K5: the render differs from the plain path")
    return launches


def envmap_setup(scene, seed: int = SEED):
    """``(params, apply_params, pixel_loss)`` of the envmap training step
    (``bench.py _time_envmap``): offsets of the mesh's raw vertices
    ``dv`` and of the map's radiance texture ``dr``, an L2 loss against a
    seeded random target."""
    import numpy as np
    import torch

    mesh, env = scene.meshes[0], scene.emitter_env
    verts = mesh.vertex_positions_raw.clone()
    tex = env.radiance.data.clone()
    target = torch.from_numpy(np.random.default_rng(seed).random(
        (scene.opts.num_pixels, 3)).astype(np.float32)).to(scene.device)

    def apply_params(p):
        mesh.vertex_positions_raw = verts + p["dv"]
        env.radiance.data = tex + p["dr"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"dv": torch.zeros_like(verts), "dr": torch.zeros_like(tex)}
    return params, apply_params, pixel_loss


def gallery_step_setup(scene, seed: int = SEED):
    """``(params, apply_params, pixel_loss)`` of the gallery's training step
    (``bench.py _time_bvh_grad``): offsets of the first sphere's (mesh 6,
    edges on) raw vertices ``dv`` and of the light's radiance ``dr``, an
    L2 loss against a seeded random target."""
    import numpy as np
    import torch

    mesh, em = scene.meshes[6], scene.emitters[0]
    verts = mesh.vertex_positions_raw.clone()
    rad = em.radiance.clone()
    target = torch.from_numpy(np.random.default_rng(seed).random(
        (scene.opts.num_pixels, 3)).astype(np.float32)).to(scene.device)

    def apply_params(p):
        mesh.vertex_positions_raw = verts + p["dv"]
        em.radiance = rad + p["dr"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"dv": torch.zeros_like(verts), "dr": torch.zeros_like(rad)}
    return params, apply_params, pixel_loss


def mesh_tx_tangent(integrator, scene, seed: int = SEED):
    """``forward_mode`` of renderD along the x translation of mesh 0."""
    import torch

    mesh = scene.meshes[0]
    base = mesh.to_world_raw.clone()

    def set_tx(v):
        mesh.to_world_raw = base + torch.nn.functional.pad(
            v.reshape(1, 1).to(base.device), (3, 0, 0, 3))

    return forward_mode(integrator, scene, set_tx, torch.zeros(()), 1.0,
                        seed)


def device_busy_ms(fn) -> float:
    """The summed device time of the operations one call of ``fn``
    issues (``torch.profiler``); ``fn`` is warm (every caller has just
    timed it with ``wall_ms``). Only the device's activity is recorded:
    the host's adds nothing to the sum and took 2-2.5 times as long to
    read back (8.7 s for a 512x512 frame of the room, 19.6 s for its
    step, on an H100)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def measured(fn, n_rays, dev) -> dict:
    """Median ms of 3 after a warm-up, Mrays/s (where ``n_rays``), peak GB,
    busy ms and idle share of ``fn``."""
    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    ms = wall_ms(fn, 3)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    busy = device_busy_ms(fn)
    out = {"ms": f"{ms:.2f}", "peak_gb": f"{peak:.3f}",
           "busy_ms": f"{busy:.2f}", "idle_share": f"{1 - busy / ms:.3f}"}
    if n_rays:
        out["mrays_per_s"] = f"{n_rays / ms / 1e3:.1f}"
    return out


def step_split(step, reps: int = 3) -> dict:
    """Median spans of the training step's parts over ``reps`` steps, from
    the program's own recorder (CUDA events on the card's stream): the
    scene compile, the interior pass, the primary-edge pass and the
    secondary-edge pass."""
    from psdr_jit_tpu_torch.utils import profiling

    spans = {"compile": "compile", "interior": "interior",
             "primary_edges": "primary_edge",
             "secondary_edges": "secondary_edge"}
    ms = {k: [] for k in spans}
    for _ in range(reps):
        with profiling.recorder() as rec:
            step()
            found = rec.totals()["spans"]
        for k, name in spans.items():
            if name in found:
                ms[k].append(found[name]["device_ms"])
    return {k: statistics.median(v) for k, v in ms.items() if v}


def _compare_paths(phase, arrays, run, dev):
    """``run(scene, device, target)`` on the scene ``arrays`` through the
    kernels on ``dev`` and through the plain versions on the CPU, with a
    seeded target image; ``run`` returns a frame ``img`` and may add a
    training step's ``loss``, ``img_t`` and ``grads`` and a renderD
    ``primal`` and ``tangent``. Returns their rel L1s (loss, images and
    primal within 1e-4, gradients and tangent within 1e-3, every gradient
    and tangent nonzero and finite) and the two sides' ms."""
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt

    w, h = (int(v) for v in arrays["opts"][:2])
    target = np.random.default_rng(SEED).random((w * h, 3)).astype(
        np.float32)
    out = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        sc = pt.Scene.from_arrays(arrays, device=device)
        sc.configure()
        t0 = time.perf_counter()
        r = run(sc, device, torch.from_numpy(target).to(device))
        out[name] = {k: ({n: g.cpu() for n, g in v.items()} if k == "grads"
                         else float(v) if k == "loss" else v.cpu())
                     for k, v in r.items()}
        out[name]["ms"] = (time.perf_counter() - t0) * 1e3
    k, p = out["kernels"], out["plain"]
    grads = p.get("grads", {})
    rels = {"frame": rel_l1(k["img"], p["img"]),
            **({"loss": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
                "step_image": rel_l1(k["img_t"], p["img_t"])}
               if "loss" in p else {}),
            **{f"grad_{n}": rel_l1(k["grads"][n], g)
               for n, g in grads.items()},
            **{n: rel_l1(k[n], p[n]) for n in ("primal", "tangent")
               if n in p}}
    first = [k[n] for n in ("img", "img_t") if n in k] + [
        *k.get("grads", {}).values()]
    derivs = [*grads.values(), *([p["tangent"]] if "tangent" in p
                                 else [])]
    require(all(bool(torch.isfinite(x).all()) for x in first),
            f"{phase}: non-finite image or gradient")
    require(all(rels[n] < 1e-4 for n in ("frame", "loss", "step_image",
                                         "primal") if n in rels),
            f"{phase}: an image or the loss differs from the plain path")
    require(all(v < 1e-3 for n, v in rels.items()
                if n.startswith("grad_") or n == "tangent"),
            f"{phase}: a gradient or the tangent differs from the plain "
            "path by >= 1e-3")
    require(all(float(g.abs().sum()) > 0 for g in derivs),
            f"{phase}: a gradient or the tangent is zero")
    return rels, k["ms"], p["ms"]


def _frame_and_step(depth, setup):
    """The ``run`` of :func:`_compare_paths` for a frame and a training
    step from sensor 0 with ``setup(scene)``'s parameters."""
    import psdr_jit_tpu_torch as pt

    def run(sc, device, target):
        integ = pt.PathTracer(depth)
        params, apply_params = setup(sc)
        img = integ.renderC(sc, 0, seed=SEED)
        loss, grads, img_t = integ.loss_and_grad(
            sc, params, apply_params, l2_loss(target), 0, SEED)
        return dict(img=img, loss=loss, img_t=img_t, grads=grads)

    return run


def envmap_64_phase(dev):
    """[envmap-64]: the 5,132-triangle stand-in of ``envmap_arrays`` at
    64x64, spp 8, sppe 8, sppse 8, ``PathTracer(1)``, through the kernels
    and, on the CPU, through the plain versions (``_compare_paths``): a
    frame, a training step guided by one table built on the card (the
    same table on both sides: the card's mass table sums with float
    atomics) and the forward-mode renderD tangent along the mesh's x
    translation."""
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.scene.scene import tree_map

    guider = pt.PathTracer(ENVMAP_DEPTH)

    def run(sc, device, _target):
        if device.type != "cpu":
            guider.preprocess_secondary_edges(sc, 0, ENVMAP_GUIDE_64, 1)
        table = tree_map(lambda x: x.to(device), guider.warpper[0])
        integ = pt.PathTracer(ENVMAP_DEPTH)
        img = integ.renderC(sc, 0, seed=SEED)
        params, apply_params, pixel_loss = envmap_setup(sc)
        loss, grads, img_t = integ.loss_and_grad(
            sc, params, apply_params, pixel_loss, 0, SEED, warp=table)
        primal, tangent = mesh_tx_tangent(integ, sc)
        return dict(img=img, loss=loss, img_t=img_t, grads=grads,
                    primal=primal, tangent=tangent)

    rels, ms, plain_ms = _compare_paths(
        "envmap-64", envmap_arrays(64, 64, 8, 8, 8), run, dev)
    log("envmap-64", triangles=20 * 4 ** 4 + 12, spp=8, sppe=8, sppse=8,
        depth=ENVMAP_DEPTH, guide=",".join(map(str, ENVMAP_GUIDE_64)),
        rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
        ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")


def envmap_phases(dev, kernels) -> dict:
    """[envmap-table], [main-path-envmap], [envmap], [envmap-K6]: BASELINE
    config #3's path on the stand-in at full size (``ENVMAP``): the
    importance table's host build, then with the launch counts set to 0
    before each part and read after it, the frame (renderC), the guided
    training step (loss_and_grad after ``preprocess_secondary_edges``
    with ``ENVMAP_GUIDE``) and the three per-term forward-mode renderDs
    along the mesh's x translation: K6 only, its launches as the routing
    says, no plain version; their times, the step's rays, peak memory,
    split and device busy share; then every K6 launch of one step held
    bit for bit against its plain version on its own inputs, with each
    ray set's dead share. Returns the main path's launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.emitter.envmap import build_envmap_distribution
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.scene.scene import tree_map

    W, H, S = ENVMAP
    n_pix = W * H
    sc = pt.Scene.from_arrays(envmap_arrays(W, H, S, S, S), device=dev)
    t0 = time.perf_counter()
    table = build_envmap_distribution(tree_map(
        lambda x: x.detach().cpu(), sc.emitter_env.radiance)).with_alias()
    table_ms = (time.perf_counter() - t0) * 1e3
    _, configure_ms = _synced_ms(sc.configure)
    sd = sc.data
    cells = sd.emitters[0].cell_distrb
    f = sd.tri.p0.shape[0]
    log("envmap-table", cells=cells.num_cells,
        res=",".join(map(str, cells.res)), build_ms=f"{table_ms:.1f}",
        configure_ms=f"{configure_ms:.1f}", coin=sd.emitter_coin_needed,
        triangles=f, route=ix.walk_name(f))
    require(cells.num_cells == 2 * 1023 * 2 * 511 and table.needs_coin
            and sd.emitter_coin_needed and ix.walk_name(f) == "K6",
            "envmap-table: not the 2,091,012-cell table with alias rows")
    require(torch.equal(cells.distrb.alias_rows.cpu(),
                        table.distrb.alias_rows),
            "envmap-table: configure() built another table")

    integ = pt.PathTracer(ENVMAP_DEPTH)
    _, guide_ms = _synced_ms(lambda: integ.preprocess_secondary_edges(
        sc, 0, ENVMAP_GUIDE, 1))
    params, apply_params, pixel_loss = envmap_setup(sc)

    def step():
        return integ.loss_and_grad(sc, params, apply_params, pixel_loss, 0,
                                   SEED)

    def term(t):
        sc.opts = pt.RenderOption(W, H, *t)
        try:
            return mesh_tx_tangent(integ, sc)
        finally:
            sc.opts = pt.RenderOption(W, H, S, S, S)

    per_li = 1 + 2 * ENVMAP_DEPTH

    def chunks(lanes, size):
        return -(-lanes // size)

    want = {"frame": chunks(n_pix * S, base.GENERAL_CHUNK_LANES) * per_li,
            "step": (chunks(n_pix * S, base.TRAIN_CHUNK_LANES) * per_li
                     + chunks(n_pix * S, base.TRAIN_CHUNK_LANES) * 2 * per_li
                     + chunks(n_pix * S, base.SE_CHUNK_LANES) * 3)}
    for t in ENVMAP_TERMS:
        want[f"renderD_{'_'.join(map(str, t))}"] = (
            chunks(n_pix * t[0], base.DIFF_CHUNK_LANES) * per_li
            + chunks(n_pix * t[1], base.TRAIN_CHUNK_LANES) * 2 * per_li
            + chunks(n_pix * t[2], base.SE_CHUNK_LANES) * 3)
    runs = {"frame": lambda: integ.renderC(sc, 0, seed=SEED), "step": step,
            **{f"renderD_{'_'.join(map(str, t))}": functools.partial(term, t)
               for t in ENVMAP_TERMS}}
    got, outs = {}, {}
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        for name, fn in runs.items():
            _cuda.reset_launches()
            plain.hits = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            got[name] = rebuilds(f"main-path-envmap-{name}", _cuda.LAUNCHES,
                                 plain.hits)
        plain_count = plain.count
    k6 = {n: g["K6"] for n, g in got.items()}
    log("main-path-envmap", triangles=f, K6_LAUNCHES=sum(k6.values()),
        **{f"K6_{n}": v for n, v in k6.items()},
        K6_expected=",".join(f"{n}:{v}" for n, v in want.items()),
        other_launches=sum(v for g in got.values() for k, v in g.items()
                           if k != "K6"), plain_calls=plain_count)
    require(k6 == want, "envmap main path: K6 launches != the routing's")
    require(all(v == 0 for g in got.values() for k, v in g.items()
                if k != "K6"),
            "envmap main path: another kernel ran (K1 to K5)")
    require(plain_count == 0, "envmap main path: a plain version ran")

    img = outs["frame"]
    loss, grads, img_t = outs["step"]
    require(tuple(img.shape) == (n_pix, 3) and bool(
        torch.isfinite(img).all()) and float(img.mean()) > 0,
        "envmap frame: non-finite, misshapen or black")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in grads.values()),
        "envmap step: non-finite or zero loss or gradient")
    # the step's image is the attached Li of the frame's estimator
    t_rel = rel_l1(img_t, img)
    require(t_rel < 1e-3, "envmap step: image differs from renderC's")
    tangents = {n: outs[n][1] for n in outs if n.startswith("renderD")}
    require(all(bool(torch.isfinite(t).all()) and float(t.abs().sum()) > 0
                for t in tangents.values()),
            "envmap renderD: a per-term tangent is non-finite or zero")

    # the float atomics of the texture's and the vertices' adjoints
    _, grads2, _ = step()
    spread = {k: rel_l1(grads2[k], grads[k]) for k in grads}
    frame_ms = wall_ms(runs["frame"], 3)
    frame_busy = device_busy_ms(runs["frame"])
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_busy = device_busy_ms(step)
    split = step_split(step)
    term_ms = {n: wall_ms(runs[n], 3) for n in tangents}
    rays = n_pix * (S * (1 + 2 * ENVMAP_DEPTH)
                    + S * 2 * (1 + 2 * ENVMAP_DEPTH) + S * 3)
    frame_rays = n_pix * S * (1 + 2 * ENVMAP_DEPTH)
    log("envmap", size=f"{W}x{H}", spp=S, sppe=S, sppse=S,
        depth=ENVMAP_DEPTH, guide=",".join(map(str, ENVMAP_GUIDE)),
        guide_ms=f"{guide_ms:.1f}", frame_ms=f"{frame_ms:.2f}",
        frame_mrays_per_s=f"{frame_rays / frame_ms / 1e3:.1f}",
        frame_busy_ms=f"{frame_busy:.2f}",
        frame_idle_share=f"{1 - frame_busy / frame_ms:.3f}",
        loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        run_to_run_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in
                                   spread.items()),
        step_image_rel_l1_vs_frame=f"{t_rel:.3e}", step_ms=f"{step_ms:.2f}",
        rays=rays, mrays_per_s=f"{rays / step_ms / 1e3:.1f}",
        peak_gb=f"{peak_gb:.3f}", step_busy_ms=f"{step_busy:.2f}",
        step_idle_share=f"{1 - step_busy / step_ms:.3f}",
        split_ms=",".join(f"{k}:{v:.2f}" for k, v in split.items()),
        renderD_ms=",".join(f"{n[8:]}:{v:.2f}" for n, v in term_ms.items()),
        tangent_l1=",".join(f"{n[8:]}:{float(t.abs().sum()):.4e}"
                            for n, t in tangents.items()))

    # [envmap-K6]: every K6 launch of one step against its plain version
    with KernelCalls({"K6": (bvh, "walk_cuda")}) as rec:
        step()
        torch.cuda.synchronize()
    calls = rec.calls["K6"]
    require(len(calls) == want["step"], "envmap-K6: launches of a step != "
            "the routing's")
    rec6, a, tests, launch_ms = intersect_record(
        "K6 tree traversal, envmap step", "psdr_jit_tpu_torch/csrc/bvh.cu",
        "psdr_jit_tpu/ops/bvh.py:309", calls, k6_plain)
    names = ([f"interior_{x}" for x in ("camera", "shadow", "bounce")]
             + [f"pe_{s}_{x}" for s in ("n", "p")
                for x in ("camera", "shadow", "bounce")]
             + [f"se_{x}" for x in ("visibility", "receiver", "camera")])
    dead = [1 - float(c[1][3].float().mean()) for c in calls]
    sky = [float(((c[2][1] >= f - 12) & c[1][3]).float().sum()
                 / c[1][3].float().sum().clamp_min(1)) for c in calls]
    # live rays with a zero direction: bounces from hits without a BSDF
    # (the sky box), traced as the JAX package traces them and then masked
    still = [float(((c[1][2] == 0).all(-1) & c[1][3]).float().sum()
                   / c[1][3].float().sum().clamp_min(1)) for c in calls]
    n_rays = sum(c[1][1].shape[0] for c in calls)
    own = [sum(x) for x in zip(*(walk_counted(c[1], "K6") for c in calls))]
    log("envmap-K6", launches=len(calls), rays=n_rays,
        bitwise_equal_to_plain=a["bitwise"], mismatches=a["mismatches"],
        dead_share=",".join(f"{n}:{d:.4f}" for n, d in zip(names, dead)),
        sky_box_share_of_live=",".join(f"{n}:{x:.4f}"
                                       for n, x in zip(names, sky)),
        zero_direction_share_of_live=",".join(
            f"{n}:{x:.4f}" for n, x in zip(names, still)),
        launch_ms=",".join(f"{x:.4f}" for x in launch_ms),
        ms=f"{rec6['ms']:.4f}", plain_ms=f"{rec6['plain_ms']:.1f}",
        bound_ms=f"{rec6['bound_ms']:.4f}", bound_by=rec6["bound_by"],
        tests_per_ray=f"{own[0] / n_rays:.1f}",
        node_visits_per_ray=f"{own[1] / n_rays:.1f}",
        needed_tests_per_ray=f"{tests / n_rays:.2f}")
    require(a["bitwise"], "envmap-K6: K6 not bitwise equal to its plain "
            "traversal on the step's rays")
    kernels["K6"].update(
        envmap_step_ms=rec6["ms"], envmap_step_plain_ms=rec6["plain_ms"],
        envmap_step_bound_ms=rec6["bound_ms"],
        envmap_step_launches=len(calls),
        max_abs_err=max(kernels["K6"]["max_abs_err"], rec6["max_abs_err"]))
    return {"K6": sum(k6.values()), "runs": got}


def func_jvp_phase(arrays, dev):
    """[func-jvp]: ``torch.func.jvp`` of renderD of the box at 64x64, spp
    8, sppe 8, sppse 8, ``PathTracer(3)``, along the light's translation,
    on the card (the kernels are PyTorch operators, so functorch's tensors
    never reach a launch), against ``torch.autograd.forward_ad``: the
    primal and the tangent within 1e-5 rel L1 (the order of the splats'
    float atomics), K1 and K2 pair launched."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda

    sc = pt.Scene.from_arrays(arrays, device=dev)
    sc.opts = pt.RenderOption(64, 64, 8, 8, 8)
    setup = train_setup(sc)
    params, apply_params, _ = setup
    integ = pt.PathTracer(DEPTH)
    p_f, t_f = renderd_tangent(integ, sc, setup, "tx", 1.0)
    _cuda.reset_launches()
    p_j, t_j = func_jvp(integ, sc, lambda v: apply_params(
        {**params, "tx": v}), params["tx"], 1.0)
    torch.cuda.synchronize()
    require(_cuda.LAUNCHES["K7-jvp"] > 0,
            "func-jvp: the hits' tangents did not come from K7-jvp")
    launches = rebuilds("func-jvp", _cuda.LAUNCHES, None, vjp=0)
    rels = {"primal": rel_l1(p_j, p_f), "tangent": rel_l1(t_j, t_f)}
    log("func-jvp", size="64x64", spp=8, sppe=8, sppse=8, depth=DEPTH,
        K1_LAUNCHES=launches["K1"], K2_pair_LAUNCHES=launches["K2-pair"],
        rel_l1_vs_forward_ad=",".join(f"{k}:{v:.3e}"
                                      for k, v in rels.items()),
        tangent_l1=f"{float(t_f.abs().sum()):.4e}")
    require(launches["K1"] > 0 and launches["K2-pair"] > 0,
            "func-jvp: the kernels were not launched")
    require(float(t_f.abs().sum()) > 0, "func-jvp: a zero tangent")
    require(all(v < 1e-5 for v in rels.values()),
            "func-jvp: torch.func.jvp differs from forward_ad")


def textured_setup(scene):
    """``(params, apply_params)`` of the textured box's recovery: the data
    of its three textures (``albedo``, ``block``, ``roughness``) and the
    light's ``radiance``."""
    maps = {"albedo": scene.bsdfs[2].reflectance,
            "block": scene.bsdfs[5].diffuseReflectance,
            "roughness": scene.bsdfs[5].roughness}
    em = scene.emitters[0]

    def apply_params(p):
        for k, bm in maps.items():
            bm.data = p[k]
        em.radiance = p["radiance"]

    params = {k: bm.data.clone() for k, bm in maps.items()}
    params["radiance"] = em.radiance.clone()
    return params, apply_params


def textured_start(params):
    """BASELINE config #4's start: every texture at 0.5, the radiance x
    1.5."""
    import torch

    return {k: 1.5 * v if k == "radiance" else torch.full_like(v, 0.5)
            for k, v in params.items()}


def l2_loss(target):
    return lambda rows, pix: ((rows - target[pix]) ** 2).sum(-1)


def albedo_weight(shape, device, seed: int = 4):
    """A seeded direction in the albedo texture's space (the tangent's)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(device)


def texture_64_phase(dev):
    """[texture-64]: the textured box (``textured_cbox_arrays`` at 64x64,
    spp 4, sppe 4, sppse 4, the full-size textures), ``PathTracer(3)``,
    through the kernels and, on the CPU, through the plain versions
    (``_compare_paths``): a frame from sensor 1, a training step from
    sensor 2 at the recovery's start against a seeded target, with
    gradients to the three textures and the radiance, and the renderD
    tangent along a seeded direction of the albedo texture."""
    import psdr_jit_tpu_torch as pt

    def run(sc, device, target):
        integ = pt.PathTracer(TEXTURED_DEPTH)
        params, apply_params = textured_setup(sc)
        params = {k: v.to(device) for k, v in params.items()}
        img = integ.renderC(sc, 1, seed=SEED)
        loss, grads, img_t = integ.loss_and_grad(
            sc, textured_start(params), apply_params, l2_loss(target), 2,
            SEED)
        apply_params(params)
        primal, tangent = forward_mode(
            integ, sc, lambda v: apply_params({**params, "albedo": v}),
            params["albedo"], albedo_weight(params["albedo"].shape, device))
        return dict(img=img, loss=loss, img_t=img_t, grads=grads,
                    primal=primal, tangent=tangent)

    rels, ms, plain_ms = _compare_paths(
        "texture-64", textured_cbox_arrays(64, 64, 4, 4, 4), run, dev)
    log("texture-64", spp=4, sppe=4, sppse=4, depth=TEXTURED_DEPTH,
        textures=",".join(map(str, TEXTURED_TEX)),
        rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
        ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")


def general_launches(n_pix: int, spp: int, sppe: int, sppse: int,
                     depth: int, interior_chunk: int) -> int:
    """The closest-hit launches of a render or step outside the
    megakernels' scope: ``1 + 2 depth`` a chunk of the interior term
    (``interior_chunk`` lanes) and of each of the primary-edge term's two
    sequential Li, three a chunk of the secondary-edge term."""
    from psdr_jit_tpu_torch.integrator import base

    def chunks(lanes, size):
        return -(-lanes // size)

    per_li = 1 + 2 * depth
    return (chunks(n_pix * spp, interior_chunk) * per_li
            + chunks(n_pix * sppe, base.TRAIN_CHUNK_LANES) * 2 * per_li
            + chunks(n_pix * sppse, base.SE_CHUNK_LANES) * 3)


def textured_phases(dev) -> dict:
    """[main-path-texture], [texture], [texture-recovery]: BASELINE config
    #4 on the textured box at full size (``TEXTURED``: 512x512, spp, sppe
    and sppse 32, ``PathTracer(3)``, 1024x1024 and 512x512 textures).
    With the launch counts set to 0 before each part and read after it:
    a frame, four target frames (renderC from each sensor at seed 1000 +
    k with the true textures), the recovery (from textures 0.5 and the
    radiance x 1.5, ``TEXTURED_STEPS`` steps of ``torch.optim.Adam`` at
    ``TEXTURED_LR``, step i from sensor i mod 4 against its target,
    gradients to the three textures' data and the radiance) and renderD
    along a seeded direction of the albedo texture, forward and reverse:
    K1 only, as the routing says, no plain version. Then their times, the
    step's rays, peak memory, split and device busy share. Returns the
    main path's launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda

    W, H, S = TEXTURED
    n_pix = W * H
    sc = pt.Scene.from_arrays(textured_cbox_arrays(W, H, S, S, S), device=dev)
    sc.configure()
    integ = pt.PathTracer(TEXTURED_DEPTH)
    truth, apply_params = textured_setup(sc)
    truth = {k: v.to(dev) for k, v in truth.items()}
    apply_params(truth)
    weight = albedo_weight(truth["albedo"].shape, dev)
    pix_w = renderd_weight(n_pix, dev)
    state = {}

    def targets():
        return [integ.renderC(sc, k, seed=1000 + k) for k in range(4)]

    def recovery():
        tg = state["targets"]
        p = {k: v.clone().requires_grad_()
             for k, v in textured_start(truth).items()}
        opt = torch.optim.Adam(list(p.values()), lr=TEXTURED_LR)
        losses, step_ms = [], []
        for i in range(TEXTURED_STEPS):
            t0 = time.perf_counter()
            loss, grads, _ = integ.loss_and_grad(
                sc, {k: v.detach() for k, v in p.items()}, apply_params,
                l2_loss(tg[i % 4]), i % 4, SEED + i)
            for k, v in p.items():
                v.grad = grads[k]
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            state["grads"] = grads
        apply_params(truth)
        return p, losses, step_ms

    def forward():
        return forward_mode(integ, sc, lambda v: apply_params(
            {**truth, "albedo": v}), truth["albedo"], weight)

    def reverse():
        p = {k: v.clone().requires_grad_() for k, v in truth.items()}
        apply_params(p)
        try:
            img = integ.renderD(sc, 0, seed=SEED)
            return torch.autograd.grad((img * pix_w).sum(), p["albedo"])[0]
        finally:
            apply_params(truth)

    per_li = 1 + 2 * TEXTURED_DEPTH
    want = {"frame": general_launches(n_pix, S, 0, 0, TEXTURED_DEPTH,
                                      base.GENERAL_CHUNK_LANES),
            "targets": 4 * general_launches(n_pix, S, 0, 0, TEXTURED_DEPTH,
                                            base.GENERAL_CHUNK_LANES),
            "recovery": TEXTURED_STEPS * general_launches(
                n_pix, S, S, S, TEXTURED_DEPTH, base.TRAIN_CHUNK_LANES),
            "renderD_forward": general_launches(
                n_pix, S, S, S, TEXTURED_DEPTH, base.DIFF_CHUNK_LANES)}
    runs = {"frame": lambda: integ.renderC(sc, 0, seed=SEED),
            "targets": targets, "recovery": recovery,
            "renderD_forward": forward, "renderD_reverse": reverse}
    got, outs = {}, {}
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        for name, fn in runs.items():
            _cuda.reset_launches()
            plain.hits = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            got[name] = rebuilds(f"main-path-texture-{name}", _cuda.LAUNCHES,
                                 plain.hits)
            if name == "targets":
                state["targets"] = outs[name]
        plain_count = plain.count
    k1 = {n: g["K1"] for n, g in got.items()}
    others = sum(v for g in got.values() for k, v in g.items() if k != "K1")
    log("main-path-texture", K1_LAUNCHES=sum(k1.values()),
        **{f"K1_{n}": v for n, v in k1.items()},
        K1_expected=",".join(f"{n}:{v}" for n, v in want.items()),
        per_li=per_li, other_launches=others, plain_calls=plain_count)
    require(all(k1[n] == v for n, v in want.items()),
            "textured main path: K1 launches != the routing's")
    require(k1["renderD_reverse"] > 0, "textured renderD: K1 not launched")
    require(others == 0, "textured main path: another kernel ran (K2 to "
            "K6)")
    require(plain_count == 0, "textured main path: a plain version ran")

    img = outs["frame"]
    p, losses, adam_ms = outs["recovery"]
    require(tuple(img.shape) == (n_pix, 3) and bool(
        torch.isfinite(img).all()) and float(img.mean()) > 0,
        "textured frame: non-finite, misshapen or black")
    require(all(bool(torch.isfinite(t).all()) for t in outs["targets"]),
            "textured targets: non-finite")
    require(all(torch.isfinite(torch.tensor(losses))) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in state["grads"].values()),
        "textured recovery: non-finite or zero loss or gradient")
    primal, tangent = outs["renderD_forward"]
    g_rev = outs["renderD_reverse"]
    require(bool(torch.isfinite(tangent).all()) and float(
        tangent.abs().sum()) > 0 and bool(torch.isfinite(g_rev).all())
        and float(g_rev.abs().sum()) > 0,
        "textured renderD: a non-finite or zero tangent or gradient")
    # the adjoint identity: <w, J d> = <J^T w, d>
    fwd_dot = float((tangent * pix_w).sum())
    rev_dot = float((g_rev * weight).sum())
    adjoint = abs(fwd_dot - rev_dot) / abs(rev_dot)
    err = {k: float((p[k].detach() - truth[k]).abs().mean())
           for k in truth}
    err0 = {k: float((v - truth[k]).abs().mean())
            for k, v in textured_start(truth).items()}

    start = textured_start(truth)

    def step():
        return integ.loss_and_grad(sc, start, apply_params,
                                   l2_loss(state["targets"][0]), 0, SEED)

    frame_ms = wall_ms(runs["frame"], 3)
    frame_busy = device_busy_ms(runs["frame"])
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step_busy = device_busy_ms(step)
    split = step_split(step)
    apply_params(truth)
    fwd_ms = wall_ms(forward, 3)
    torch.cuda.reset_peak_memory_stats(dev)
    rev_ms = wall_ms(reverse, 3)
    rev_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rays = n_pix * (S * (1 + 2 * TEXTURED_DEPTH)
                    + S * 2 * (1 + 2 * TEXTURED_DEPTH) + S * 3)
    frame_rays = n_pix * S * (1 + 2 * TEXTURED_DEPTH)
    log("texture", size=f"{W}x{H}", spp=S, sppe=S, sppse=S,
        depth=TEXTURED_DEPTH, textures=",".join(map(str, TEXTURED_TEX)),
        frame_ms=f"{frame_ms:.2f}",
        frame_mrays_per_s=f"{frame_rays / frame_ms / 1e3:.1f}",
        frame_busy_ms=f"{frame_busy:.2f}",
        frame_idle_share=f"{1 - frame_busy / frame_ms:.3f}",
        step_ms=f"{step_ms:.2f}", rays=rays,
        mrays_per_s=f"{rays / step_ms / 1e3:.1f}",
        peak_gb=f"{peak_gb:.3f}", step_busy_ms=f"{step_busy:.2f}",
        step_idle_share=f"{1 - step_busy / step_ms:.3f}",
        split_ms=",".join(f"{k}:{v:.2f}" for k, v in split.items()),
        renderD_forward_ms=f"{fwd_ms:.2f}",
        renderD_reverse_ms=f"{rev_ms:.2f}",
        renderD_reverse_peak_gb=f"{rev_peak_gb:.3f}",
        adjoint_rel=f"{adjoint:.3e}")
    log("texture-recovery", steps=TEXTURED_STEPS, lr=TEXTURED_LR,
        sensors="i mod 4", loss=",".join(f"{x:.6e}" for x in losses),
        step_ms=",".join(f"{x:.1f}" for x in adam_ms),
        mean_abs_err_start=",".join(f"{k}:{v:.4f}" for k, v in err0.items()),
        mean_abs_err_end=",".join(f"{k}:{v:.4f}" for k, v in err.items()))
    require(adjoint < 1e-3, "textured renderD: forward and reverse mode "
            "disagree (adjoint identity)")
    return {"K1": sum(k1.values())}


def gallery_step_phases(dev) -> dict:
    """[gallery-step-64], [main-path-gallery-step], [gallery-step]: the
    gallery's training step (``bench.py _time_bvh_grad``,
    ``gallery_step_setup``): at 64x64 (spp, sppe, sppse 4, the full 80
    spheres) through K6 and through its plain version on the card's
    tensors (``PlainRoute``): loss and image within 1e-4, gradients
    within 1e-3; then at full size (``GALLERY_STEP``, ``PathTracer(2)``)
    with the launch counts set to 0: K6 only, as the routing says, no
    plain version; its time, rays (``bench.py``'s count), peak memory and
    busy share. Returns its K6 launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda

    W, H, S, n_spheres, subdiv = GALLERY_STEP
    integ = pt.PathTracer(GALLERY_STEP_DEPTH)
    small = pt.Scene.from_arrays(gallery_arrays(
        64, 64, S, n_spheres, subdiv, sppe=S, sppse=S, edge_spheres=1),
        device=dev)
    small.configure()

    def small_step():
        return integ.loss_and_grad(small, *gallery_step_setup(small),
                                   seed=SEED)

    loss_k, g_k, img_k = small_step()
    with PlainRoute():
        loss_p, g_p, img_p = small_step()
    rels = {"loss": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            "image": rel_l1(img_k, img_p),
            **{f"grad_{k}": rel_l1(g_k[k], g_p[k]) for k in g_p}}
    log("gallery-step-64", spp=S, sppe=S, sppse=S,
        depth=GALLERY_STEP_DEPTH,
        rel_l1_vs_plain=",".join(f"{k}:{v:.3e}" for k, v in rels.items()))
    require(rels["loss"] < 1e-4 and rels["image"] < 1e-4,
            "gallery-step-64: loss or image differs from the plain path")
    require(all(v < 1e-3 for k, v in rels.items() if k.startswith("grad")),
            "gallery-step-64: a gradient differs from the plain path")
    require(all(float(g.abs().sum()) > 0 for g in g_p.values()),
            "gallery-step-64: a parameter got no gradient")

    sc = pt.Scene.from_arrays(gallery_arrays(
        W, H, S, n_spheres, subdiv, sppe=S, sppse=S, edge_spheres=1),
        device=dev)
    sc.configure()
    f = sc.data.tri.p0.shape[0]
    setup = gallery_step_setup(sc)

    def step():
        return integ.loss_and_grad(sc, *setup, seed=SEED)

    step()
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        loss, grads, img = step()
        torch.cuda.synchronize()
        got = rebuilds("main-path-gallery-step", _cuda.LAUNCHES, plain.hits,
                       0)
        plain_count = plain.count
    want = general_launches(W * H, S, S, S, GALLERY_STEP_DEPTH,
                            base.TRAIN_CHUNK_LANES)
    log("main-path-gallery-step", triangles=f, K6_LAUNCHES=got["K6"],
        K6_expected=want, other_launches=sum(
            v for k, v in got.items() if k != "K6"),
        plain_calls=plain_count)
    require(got["K6"] == want, "gallery step: K6 launches != the routing's")
    require(all(v == 0 for k, v in got.items() if k != "K6"),
            "gallery step: another kernel ran")
    require(plain_count == 0, "gallery step: a plain version ran")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in grads.values()),
        "gallery step: non-finite or zero loss or gradient")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    busy = device_busy_ms(step)
    d = GALLERY_STEP_DEPTH
    rays = W * H * (S * (1 + 2 * d) + S * 2 * (1 + 2 * d) + S * 3)
    log("gallery-step", size=f"{W}x{H}", spp=S, sppe=S, sppse=S, depth=d,
        triangles=f, loss=f"{float(loss):.6e}", step_ms=f"{step_ms:.2f}",
        rays=rays, mrays_per_s=f"{rays / step_ms / 1e3:.1f}",
        peak_gb=f"{peak_gb:.3f}", busy_ms=f"{busy:.2f}",
        idle_share=f"{1 - busy / step_ms:.3f}")
    return {"K6": got["K6"]}


def bsdf_setup(scene, case):
    """``(params, apply_params)`` of a [bsdf-64] step: the vertex offsets
    ``dv`` of the block that wears the BSDF, the light's ``radiance`` and
    one of the BSDF's own parameters (``spec``, the conductor's specular
    tint; ``alpha``, the dielectric's alpha_u; ``diff``, the per-vertex
    diffuse table; ``nmap``, the normal map)."""
    nm = case == "normalmap"
    mesh, b = scene.meshes[2 if nm else 1], scene.bsdfs[6 if nm else 5]
    em = scene.emitters[0]
    base_v = mesh.vertex_positions_raw.clone()
    name = {"conductor": "spec", "dielectric": "alpha", "pv": "diff",
            "normalmap": "nmap"}[case]
    holder = {"conductor": lambda: b.specular_reflectance,
              "dielectric": lambda: b.alpha_u,
              "normalmap": lambda: b.nmap}.get(case)

    def apply_params(p):
        mesh.vertex_positions_raw = base_v + p["dv"]
        em.radiance = p["radiance"]
        if holder is None:
            b.diffuseReflectance = p[name]
        else:
            holder().data = p[name]

    value = b.diffuseReflectance if holder is None else holder().data
    return {"dv": base_v.new_zeros(base_v.shape),
            "radiance": em.radiance.clone(), name: value.clone()}, \
        apply_params


def room_setup(scene):
    """``(params, apply_params)`` of ``tests/test_room.py``'s step: the
    brass block's x translation ``tx``, the prism's vertex offsets ``dv``
    and an offset ``dr`` of the light's radiance, all zero."""
    import torch

    brass, prism = scene.meshes[ROOM_BRASS], scene.meshes[ROOM_PRISM]
    em = scene.emitters[0]
    base_raw = brass.to_world_raw.clone()
    base_v = prism.vertex_positions_raw.clone()
    base_r = em.radiance.clone()
    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0

    def apply_params(p):
        brass.to_world_raw = base_raw + p["tx"] * e03
        prism.vertex_positions_raw = base_v + p["dv"]
        em.radiance = base_r + p["dr"]

    return {"tx": torch.tensor(0.0), "dv": torch.zeros_like(base_v),
            "dr": torch.zeros(3)}, apply_params


def room_adam_setup(scene):
    """``(params, apply_params)`` of ``examples/room_optimization.py``: the
    red box's x translation ``tx`` and the light's ``log_gain``, both
    zero."""
    import torch

    box, em = scene.meshes[ROOM_RED_BOX], scene.emitters[0]
    base_raw, base_r = box.to_world_raw.clone(), em.radiance.clone()
    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0

    def apply_params(p):
        box.to_world_raw = base_raw + p["tx"] * e03
        em.radiance = base_r * torch.exp(p["log_gain"])

    return {"tx": torch.tensor(0.0), "log_gain": torch.tensor(0.0)}, \
        apply_params


def bsdf_64_phase(dev):
    """[bsdf-64]: the Cornell box with each of the other four BSDFs
    (``bsdf_cbox_arrays`` at 64x64, spp, sppe and sppse 4, ``BSDF_DEPTH``)
    through the kernels and, on the CPU, through the plain versions: a
    frame and a training step with gradients to the block's vertex
    offsets, the radiance and one of the BSDF's parameters
    (``bsdf_setup``)."""
    w, h, s = BSDF_SMALL
    for case in BSDF_CASES:
        rels, ms, plain_ms = _compare_paths(
            f"bsdf-64 {case}", bsdf_cbox_arrays(case, w, h, s, s, s),
            _frame_and_step(BSDF_DEPTH[case],
                            lambda sc: bsdf_setup(sc, case)), dev)
        log("bsdf-64", bsdf=case, spp=s, sppe=s, sppse=s,
            depth=BSDF_DEPTH[case],
            rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
            ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")


def room_64_phase(dev):
    """[room-64]: the room at ``examples/room_optimization.py``'s 64x64,
    spp, sppe and sppse 4, ``PathTracer(2)``, through the kernels and, on
    the CPU, through the plain versions: a frame and a training step with
    ``tests/test_room.py``'s three parameters (``room_setup``)."""
    w, h, s = ROOM_SMALL
    rels, ms, plain_ms = _compare_paths(
        "room-64", room_arrays(w, h, s, s, s),
        _frame_and_step(ROOM_DEPTH, room_setup), dev)
    log("room-64", spp=s, sppe=s, sppse=s, depth=ROOM_DEPTH,
        rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
        ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")


def room_phases(dev, kernels) -> dict:
    """[main-path-room], [room], [room-K1]: BASELINE config #5's room at
    full size (``ROOM``: 512x512, spp, sppe and sppse 32, ``PathTracer(2)``,
    108 triangles: K1 only). With the launch counts set to 0 before each
    part and read after it: a frame; the target of
    ``examples/room_optimization.py`` (its truth, red box ``tx`` 0.12 and
    ``log_gain`` -0.3, seed 1); ``ROOM_STEPS`` Adam steps on ``tx`` and
    ``log_gain`` at ``ROOM_LR`` from 0 against it, seed 1; one training step
    with ``tests/test_room.py``'s three parameters against the target; and
    renderD along the brass block's ``tx``, forward and reverse: the
    launches each predicted by ``general_launches``, no other kernel, no
    plain version. Then their times (median of 3 after a warm-up), rays,
    peak memory, device busy share and the step's split, the error to the
    truth before and after the Adam steps, and K1 alone on every launch of
    the frame and of the step's secondary-edge pass, each held bitwise
    against its plain version and timed, with its bound. Returns the main
    path's launches."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda
    from psdr_jit_tpu_torch.ops import intersect as ix

    W, H, S = ROOM
    n_pix, d = W * H, ROOM_DEPTH
    sc = pt.Scene.from_arrays(room_arrays(W, H, S, S, S), device=dev)
    sd = sc.configure()
    integ = pt.PathTracer(d)
    # the parameters live on the CPU beside the scene objects; the scene
    # compile moves what they touch to the card
    adam0, apply_adam = room_adam_setup(sc)
    truth = {k: torch.tensor(v) for k, v in ROOM_TRUTH.items()}
    p3, apply3 = room_setup(sc)
    pix_w = renderd_weight(n_pix, dev)
    state = {}

    def frame():
        return integ.renderC(sc, 0, seed=SEED)

    def target():
        apply_adam(truth)
        sc.configure()
        img = integ.renderC(sc, 0, seed=1)
        apply_adam(adam0)
        sc.configure()
        return img

    def adam():
        p = {k: v.clone().requires_grad_() for k, v in adam0.items()}
        opt = torch.optim.Adam(list(p.values()), lr=ROOM_LR)
        losses, step_ms = [], []
        for _ in range(ROOM_STEPS):
            t0 = time.perf_counter()
            loss, grads, _ = integ.loss_and_grad(
                sc, {k: v.detach() for k, v in p.items()}, apply_adam,
                l2_loss(state["target"]), 0, 1)
            for k, v in p.items():
                v.grad = grads[k]
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        apply_adam(adam0)
        return p, losses, step_ms

    def step():
        return integ.loss_and_grad(sc, p3, apply3, l2_loss(state["target"]),
                                   0, SEED)

    def set_tx(v):
        apply3({**p3, "tx": v})

    def forward():
        return forward_mode(integ, sc, set_tx, p3["tx"], torch.ones(()))

    def reverse():
        tx = p3["tx"].clone().requires_grad_()
        set_tx(tx)
        try:
            img = integ.renderD(sc, 0, seed=SEED)
            return torch.autograd.grad((img * pix_w).sum(), tx)[0]
        finally:
            set_tx(p3["tx"])

    frame_k1 = general_launches(n_pix, S, 0, 0, d, base.GENERAL_CHUNK_LANES)
    step_k1 = general_launches(n_pix, S, S, S, d, base.TRAIN_CHUNK_LANES)
    fwd_k1 = general_launches(n_pix, S, S, S, d, base.DIFF_CHUNK_LANES)
    # reverse mode rebuilds every chunk in the backward sweep from its
    # taped hits (the checkpoint policy): no launch there
    want = {"frame": frame_k1, "target": frame_k1,
            "adam": ROOM_STEPS * step_k1, "step": step_k1,
            "renderD_forward": fwd_k1, "renderD_reverse": fwd_k1}
    runs = {"frame": frame, "target": target, "adam": adam, "step": step,
            "renderD_forward": forward, "renderD_reverse": reverse}
    got, outs = {}, {}
    t_main = time.perf_counter()
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        for name, fn in runs.items():
            _cuda.reset_launches()
            plain.hits = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            got[name] = rebuilds(f"main-path-room-{name}", _cuda.LAUNCHES,
                                 plain.hits)
            if name == "target":
                state["target"] = outs[name]
        plain_count = plain.count
    spans = {"main_path": time.perf_counter() - t_main}
    k1 = {n: g["K1"] for n, g in got.items()}
    others = sum(v for g in got.values() for k, v in g.items() if k != "K1")
    log("main-path-room", triangles=sd.tri.p0.shape[0],
        K1_LAUNCHES=sum(k1.values()), **{f"K1_{n}": v for n, v in k1.items()},
        K1_expected=",".join(f"{n}:{v}" for n, v in want.items()),
        other_launches=others, plain_calls=plain_count)
    require(all(k1[n] == v for n, v in want.items()),
            "room main path: K1 launches != the routing's")
    require(others == 0, "room main path: another kernel ran (K2 to K6)")
    require(plain_count == 0, "room main path: a plain version ran")

    img = outs["frame"]
    require(tuple(img.shape) == (n_pix, 3) and bool(
        torch.isfinite(img).all()) and float(img.mean()) > 0.05,
        "room frame: non-finite, misshapen or black")
    require(bool(torch.isfinite(state["target"]).all()),
            "room target: non-finite")
    p, losses, adam_ms = outs["adam"]
    loss, grads, img_t = outs["step"]
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in grads.values()),
        "room step: non-finite or zero loss or gradient")
    require(all(torch.isfinite(torch.tensor(losses))),
            "room Adam steps: non-finite loss")
    primal, tangent = outs["renderD_forward"]
    g_rev = outs["renderD_reverse"]
    require(bool(torch.isfinite(tangent).all()) and float(
        tangent.abs().sum()) > 0 and bool(torch.isfinite(g_rev)),
        "room renderD: a non-finite or zero tangent or gradient")
    adjoint = abs(float((tangent * pix_w).sum()) - float(g_rev)) / abs(
        float(g_rev))
    err0 = {k: abs(float(adam0[k] - truth[k])) for k in truth}
    err = {k: abs(float(p[k].detach() - truth[k])) for k in truth}

    t_timing = time.perf_counter()
    # bench.py:46-49: spp (1 + 2d) a frame; + sppe 2 (1 + 2d) + sppse 3 a
    # step or a renderD (576 rays a pixel)
    frame_rays = n_pix * S * (1 + 2 * d)
    rays = n_pix * (S * (1 + 2 * d) + S * 2 * (1 + 2 * d) + S * 3)
    parts = {"frame": measured(frame, frame_rays, dev),
             "step": measured(step, rays, dev),
             "renderD_forward": measured(forward, rays, dev),
             "renderD_reverse": measured(reverse, rays, dev)}
    split = step_split(step)
    spans["timing"] = time.perf_counter() - t_timing
    log("room", size=f"{W}x{H}", spp=S, sppe=S, sppse=S, depth=d,
        triangles=sd.tri.p0.shape[0], frame_rays=frame_rays, rays=rays,
        **{f"{n}_{k}": v for n, m in parts.items() for k, v in m.items()},
        split_ms=",".join(f"{k}:{v:.2f}" for k, v in split.items()),
        loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        adjoint_rel=f"{adjoint:.3e}")
    log("room-adam", steps=ROOM_STEPS, lr=ROOM_LR, seed=1,
        loss=",".join(f"{x:.6e}" for x in losses),
        step_ms=",".join(f"{x:.1f}" for x in adam_ms),
        mrays_per_s=",".join(f"{rays / x / 1e3:.1f}" for x in adam_ms),
        abs_err_start=",".join(f"{k}:{v:.4f}" for k, v in err0.items()),
        abs_err_end=",".join(f"{k}:{v:.4f}" for k, v in err.items()))
    require(adjoint < 1e-3, "room renderD: forward and reverse mode "
            "disagree (adjoint identity)")

    # K1 alone on the frame's launches and the step's secondary-edge ones
    t_k1 = time.perf_counter()
    tri = tuple(getattr(sd.tri, k).detach() for k in ("p0", "e1", "e2"))

    def plain_k1(tab, box, o, dirs, act):
        ids, _, uv, t = ix.ray_intersect_brute(*tri, o, dirs, act)
        return t, ids, uv

    sites = {"K1": (ix, "sweep_cuda")}
    with KernelCalls(sites) as rec:
        frame()
        torch.cuda.synchronize()
    frame_calls = rec.calls["K1"]
    with KernelCalls(sites) as rec:
        integ.render_secondary_edges(
            sc.configure_data(), sc.opts, 0, SEED,
            torch.zeros((n_pix, 3), device=dev))
        torch.cuda.synchronize()
    se_calls = rec.calls["K1"]
    recs = {}
    for part, calls in (("frame", frame_calls), ("se", se_calls)):
        r, a, tests, launch_ms = intersect_record(
            f"K1 closest hit (sweep), room {part}",
            "psdr_jit_tpu_torch/csrc/intersect.cu",
            "psdr_jit_tpu/ops/intersect_pallas.py:267", calls, plain_k1, tri)
        n_rays = sum(c[1][2].shape[0] for c in calls)
        live = sum(int(c[1][4].sum()) for c in calls)
        recs[part] = r
        log("room-K1", part=part, launches=len(calls), rays=n_rays,
            live_rays=live, bitwise_equal_to_plain=a["bitwise"],
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.1f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            needed_tests_per_live_ray=f"{tests / max(live, 1):.2f}",
            ns_per_ray=f"{r['ms'] * 1e6 / n_rays:.4f}",
            launch_ms=",".join(f"{x:.4f}" for x in launch_ms))
        require(a["bitwise"], f"room-K1: K1 not bitwise equal to its plain "
                f"version on the room's {part} rays")
    require(len(frame_calls) == frame_k1 and len(se_calls) == se_k1_launches(
        n_pix, S), "room-K1: launches != the routing's")
    spans["K1_checks"] = time.perf_counter() - t_k1
    log("room-seconds", **{k: f"{v:.1f}" for k, v in spans.items()})
    kernels["K1"].update(
        room_frame_ms=recs["frame"]["ms"],
        room_frame_plain_ms=recs["frame"]["plain_ms"],
        room_frame_bound_ms=recs["frame"]["bound_ms"],
        room_se_ms=recs["se"]["ms"], room_se_bound_ms=recs["se"]["bound_ms"],
        max_abs_err=max(kernels["K1"]["max_abs_err"],
                        recs["frame"]["max_abs_err"],
                        recs["se"]["max_abs_err"]))
    return {"K1": sum(k1.values())}


# ---- scene files: the host library, the XML loader, the intrinsic camera ----

INTRINSIC_SMALL = (64, 64, 8)  # width, height, spp (= sppe = sppse)


def obj_text(vertices, faces) -> str:
    """OBJ text of a mesh: ``v`` lines at ``%.9g``, which round-trips
    float32 exactly, and 1-based ``f`` lines."""
    import numpy as np

    v = np.asarray(vertices, np.float32).astype(np.float64)
    f = np.asarray(faces, np.int64) + 1
    return "".join([*(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v),
                    *(f"f {a} {b} {c}\n" for a, b, c in f)])


def _matrix_xml(m) -> str:
    import numpy as np

    vals = " ".join(f"{x:.9g}" for x in np.asarray(m, np.float32).ravel())
    return f'<transform name="toWorld"><matrix value="{vals}"/></transform>'


def _rgb(v) -> str:
    import numpy as np

    return ", ".join(f"{x:.9g}" for x in np.asarray(v, np.float32).ravel())


def _sensor_xml(fov, near, far, to_world, width, height, spp) -> str:
    return (f'<sensor type="perspective"><float name="fov" value="{fov}"/>'
            f'<float name="nearClip" value="{near!r}"/>'
            f'<float name="farClip" value="{far!r}"/>{_matrix_xml(to_world)}'
            f'<film type="hdrfilm"><integer name="width" value="{width}"/>'
            f'<integer name="height" value="{height}"/></film>'
            f'<sampler type="independent"><integer name="sampleCount" '
            f'value="{spp}"/></sampler></sensor>')


def cbox_files(arrays, directory: Path) -> Path:
    """Write the scene of ``arrays`` (``tests/data/cbox_scene.npz``: one
    camera, one-sided constant diffuse BSDFs, area lights on meshes) as
    ``cbox.xml`` and one OBJ file a mesh in ``directory``, the reference's
    README workflow: each transform a ``<matrix>``, ``face_normals`` as the
    mesh has them. Returns the XML's path."""
    import numpy as np

    a = {k: np.asarray(arrays[k]) for k in arrays.keys()}
    n_meshes, n_bsdfs, _, n_sensors = (int(v) for v in a["counts"])
    eye = np.eye(4, dtype=np.float32)
    require(n_sensors == 1 and all(
        np.array_equal(a[f"{o}.{n}"], eye)
        for o in [f"mesh.{i}" for i in range(n_meshes)] + ["sensor.0"]
        for n in ("to_world_left", "to_world_right")),
        "cbox files: one camera, and transforms in to_world_raw only")
    w, h, spp = (int(v) for v in a["opts"][:3])
    fov, near, far = (float(v) for v in a["sensor.0.fov_near_far"])
    parts = ['<scene version="0.5.0">',
             _sensor_xml(f"{fov:g}", near, far, a["sensor.0.to_world_raw"],
                         w, h, spp)]
    for j in range(n_bsdfs):
        require(not bool(a[f"bsdf.{j}.twoSide"])
                and f"bsdf.{j}.type" not in a,
                "cbox files: one-sided constant diffuse BSDFs only")
        parts.append(f'<bsdf type="diffuse" id="{a["bsdf_ids"][j]}"><rgb '
                     f'name="reflectance" value="{_rgb(a[f"bsdf.{j}.reflectance"])}"'
                     '/></bsdf>')
    for i in range(n_meshes):
        name = f"mesh_{i}.obj"
        (directory / name).write_text(obj_text(
            a[f"mesh.{i}.vertex_positions_raw"], a[f"mesh.{i}.face_indices"]))
        fn = str(bool(a[f"mesh.{i}.use_face_normals"])).lower()
        em = int(a[f"mesh.{i}.emitter_id"])
        light = ("" if em < 0 else
                 f'<emitter type="area"><rgb name="radiance" value='
                 f'"{_rgb(a[f"emitter.{em}.radiance"])}"/></emitter>')
        parts.append(
            f'<shape type="obj"><string name="filename" value="{name}"/>'
            f'<boolean name="face_normals" value="{fn}"/>'
            f'<ref id="{a["bsdf_ids"][int(a[f"mesh.{i}.bsdf_id"])]}"/>'
            f'{_matrix_xml(a[f"mesh.{i}.to_world_raw"])}{light}</shape>')
    path = directory / "cbox.xml"
    path.write_text("\n".join(parts + ["</scene>"]) + "\n")
    return path


def envmap_files(directory: Path, width=128, height=128, spp=32) -> Path:
    """Write BASELINE config #3's scene on the stand-in assets as files in
    ``directory``, exactly ``envmap_arrays``' scene: the mesh of
    ``envmap_standin`` as ``mesh.obj`` (at z = -100 by a ``<translate>``),
    its 512x1024 map as a PIZ EXR (the compression of the reference's
    ballroom map) and ``scene.xml``: a ``microfacet`` BSDF of specular
    (0.2, 0.9, 0.9), diffuse 0.01 and roughness 0.3, the fov-80 camera
    mirrored by a ``<matrix>``. Returns the XML's path."""
    import numpy as np
    from psdr_jit_tpu_torch import native

    verts, faces, tex = envmap_standin()
    (directory / "mesh.obj").write_text(obj_text(verts, faces))
    native.write_exr(str(directory / "map.exr"), tex, "piz")
    mirror = np.diag([-1.0, 1.0, -1.0, 1.0])
    (directory / "scene.xml").write_text(
        '<scene version="0.5.0">'
        + _sensor_xml(80, 1e-6, 1e7, mirror, width, height, spp)
        + '<bsdf type="microfacet" id="bunny">'
        '<rgb name="specularReflectance" value="0.2, 0.9, 0.9"/>'
        '<rgb name="diffuseReflectance" value="0.01"/>'
        '<float name="roughness" value="0.3"/></bsdf>'
        '<emitter type="envmap"><string name="filename" value="map.exr"/>'
        '<float name="scale" value="1"/></emitter>'
        '<shape type="obj"><string name="filename" value="mesh.obj"/>'
        '<ref id="bunny"/><transform name="toWorld">'
        '<translate x="0" y="0" z="-100"/></transform></shape></scene>\n')
    return directory / "scene.xml"


def files_phase():
    """[files]: the port's host library builds here (its seconds); EXR
    write and read are bitwise under ZIP and PIZ on the stand-in's
    512x1024x3 map; the library's OBJ parser is bitwise the plain Python
    parser on the stand-in's 5,120-triangle mesh and on the
    102,412-triangle gallery as one OBJ, with their parse times."""
    import tempfile
    import numpy as np
    from psdr_jit_tpu_torch import native
    from psdr_jit_tpu_torch.utils.obj import parse_obj_text

    t0 = time.perf_counter()
    lib = native.build()
    native.library()
    build_s = time.perf_counter() - t0
    verts, faces, tex = envmap_standin()
    exr = {}
    with tempfile.TemporaryDirectory() as d:
        for comp in ("zip", "piz"):
            path = str(Path(d) / f"{comp}.exr")
            t0 = time.perf_counter()
            native.write_exr(path, tex, comp)
            t1 = time.perf_counter()
            back = native.read_exr(path)
            t2 = time.perf_counter()
            exr[comp] = dict(bitwise=bool(np.array_equal(back, tex)),
                             mb=Path(path).stat().st_size / 1e6,
                             write_ms=(t1 - t0) * 1e3,
                             read_ms=(t2 - t1) * 1e3)
    g = gallery_arrays()
    gv, gf, off = [], [], 0
    for i in range(int(g["counts"][0])):
        gv.append(g[f"mesh.{i}.vertex_positions_raw"])
        gf.append(g[f"mesh.{i}.face_indices"] + off)
        off += gv[-1].shape[0]
    obj = {}
    for name, (v, f) in (("standin", (verts, faces)),
                         ("gallery", (np.concatenate(gv),
                                      np.concatenate(gf)))):
        text = obj_text(v, f)
        t0 = time.perf_counter()
        got = native.parse_obj(text.encode())
        t1 = time.perf_counter()
        want = parse_obj_text(text)
        t2 = time.perf_counter()
        obj[name] = dict(
            faces=int(f.shape[0]),
            bitwise=all(np.array_equal(got[k], want[k]) and got[k].dtype
                        == want[k].dtype for k in ("vertices", "faces"))
            and got["uvs"] is None and want["uvs"] is None
            and np.array_equal(want["vertices"], v),
            ms=(t1 - t0) * 1e3, python_ms=(t2 - t1) * 1e3)
    log("files", build_s=f"{build_s:.2f}", lib=lib.relative_to(ROOT),
        **{f"exr_{c}": ",".join(f"{k}:{v:.3f}" if isinstance(v, float)
                                else f"{k}:{v}" for k, v in r.items())
           for c, r in exr.items()},
        **{f"obj_{n}": ",".join(f"{k}:{v:.2f}" if isinstance(v, float)
                                else f"{k}:{v}" for k, v in r.items())
           for n, r in obj.items()})
    require(all(r["bitwise"] for r in exr.values()),
            "files: an EXR round trip is not bitwise")
    require(all(r["bitwise"] for r in obj.values()),
            "files: the OBJ parser differs from the plain Python parser")


def _loaded_runs(phase, scenes, runs_of, expected):
    """Run ``runs_of(scene)``'s parts (name -> call) on each of
    ``scenes`` (side -> scene), the launch counts set to 0 just before
    each part and read just after; each part's launches must equal
    ``expected[name]`` on every side, with no plain version called.
    Returns ``(outputs, launches)`` keyed by ``(side, name)``."""
    import torch
    from psdr_jit_tpu_torch.ops import _cuda

    outs, got = {}, {}
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        for side, scene in scenes.items():
            for name, fn in runs_of(scene).items():
                _cuda.reset_launches()
                plain.hits = 0
                outs[side, name] = fn()
                torch.cuda.synchronize()
                got[side, name] = rebuilds(
                    f"main-path-{phase}-{side}-{name}", _cuda.LAUNCHES,
                    plain.hits)
        plain_count = plain.count
    log(f"main-path-{phase}", **{
        f"{side}_{name}": ",".join(f"{k}:{v}" for k, v in g.items() if v)
        for (side, name), g in got.items()},
        expected=";".join(f"{n}:" + ",".join(f"{k}:{v}" for k, v in
                                             e.items() if v)
                          for n, e in expected.items()),
        plain_calls=plain_count)
    for (side, name), g in got.items():
        require(g == expected[name], f"{phase}: the {side} scene's {name} "
                "launched other kernels than the in-memory main path")
    require(plain_count == 0, f"{phase}: a plain version ran")
    return outs, got


def _box_runs(integ):
    """``runs_of(scene)`` for :func:`_loaded_runs`: the box's main-path
    parts, a frame, a training step (``train_setup``) and a forward-mode
    renderD along the light's translation."""
    def runs_of(scene):
        setup = train_setup(scene)
        params, apply_params, pixel_loss = setup
        return {"frame": lambda: integ.renderC(scene, 0, seed=SEED),
                "step": lambda: integ.loss_and_grad(
                    scene, params, apply_params, pixel_loss, 0, SEED),
                "renderD": lambda: renderd_tangent(integ, scene, setup, "tx",
                                                   1.0)}
    return runs_of


def _same(phase, what, a, b):
    """``a`` and ``b`` bitwise equal."""
    import torch

    require(bool(torch.equal(a, b)), f"{phase}: the loaded scene's {what} "
            "is not bitwise the in-memory scene's")


def _grads_close(phase, grads, ref, rtol=1e-5) -> dict:
    rels = {k: rel_l1(grads[k], ref[k]) for k in ref}
    require(all(bool(g.isfinite().all()) and float(g.abs().sum()) > 0
                for g in grads.values()),
            f"{phase}: a gradient is non-finite or zero")
    require(all(v < rtol for v in rels.values()),
            f"{phase}: a gradient differs from the in-memory scene's "
            f"by >= {rtol}")
    return rels


def loaded_cbox_phase(dev, expected, frame) -> dict:
    """[main-path-loaded] and [loaded-cbox]: BASELINE config #2 by the
    reference's README workflow. ``cbox_files`` writes
    ``tests/data/cbox_scene.npz`` as ``cbox.xml`` and eight OBJ files;
    ``pt.load_file`` builds the scene on the card; at sppe and sppse 32,
    ``PathTracer(3)``'s frame, one ``loss_and_grad`` step and one
    forward-mode renderD along the light's translation run on it and on
    the in-memory scene, with the launches of ``[main-path]`` (less the
    pick), ``[main-path-train]`` and ``[main-path-renderD]``
    (``expected``). The frame (also ``frame``, the main path's) and the
    loss are bitwise the in-memory scene's; the step's image, renderD's
    primal, the gradients and the tangent within 1e-5 (K4's and
    ``index_add_``'s float atomics). Returns the loaded scene's launches."""
    import tempfile
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt

    arrays = np.load(SCENE_NPZ)
    with tempfile.TemporaryDirectory() as d:
        path = cbox_files(arrays, Path(d))
        n_files = len(list(Path(d).iterdir()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = pt.load_file(path)
        load_ms = (time.perf_counter() - t0) * 1e3
    sc.opts.sppe, sc.opts.sppse = SPPE, SPPSE
    _, configure_ms = _synced_ms(sc.configure)
    require(sc.device.type == "cuda" and sc.data.tri.p0.is_cuda,
            "loaded-cbox: load_file did not build the scene on the card")
    held = pt.scene_to_arrays(sc)
    require(sorted(held) == sorted(arrays.files) and all(
        np.array_equal(held[k], arrays[k]) for k in arrays.files
        if k != "opts"), "loaded-cbox: the loaded scene's arrays differ "
            "from cbox_scene.npz")
    mem = pt.Scene.from_arrays(arrays, device=dev)
    mem.opts.sppe, mem.opts.sppse = SPPE, SPPSE
    mem.configure()
    runs_of = _box_runs(pt.PathTracer(DEPTH))
    outs, got = _loaded_runs("loaded", {"memory": mem, "loaded": sc},
                             runs_of, expected)
    img, mem_img = outs["loaded", "frame"], outs["memory", "frame"]
    (loss, grads, img_t), (loss_m, grads_m, img_tm) = (
        outs["loaded", "step"], outs["memory", "step"])
    (primal, tangent), (primal_m, tangent_m) = (outs["loaded", "renderD"],
                                                outs["memory", "renderD"])
    _same("loaded-cbox", "frame", img, mem_img)
    _same("loaded-cbox", "frame", img, frame)
    _same("loaded-cbox", "loss", loss, loss_m)
    rels = _grads_close("loaded-cbox", grads, grads_m)
    rels.update(step_image=rel_l1(img_t, img_tm),
                renderD_primal=rel_l1(primal, primal_m),
                renderD_tangent=rel_l1(tangent, tangent_m))
    require(all(v < 1e-5 for v in rels.values()),
            "loaded-cbox: the step's image, renderD or a gradient differs "
            "from the in-memory scene's by >= 1e-5")
    run = runs_of(sc)
    ms = {n: wall_ms(f, 3) for n, f in run.items()}
    log("loaded-cbox", files=n_files, load_file_ms=f"{load_ms:.1f}",
        configure_ms=f"{configure_ms:.1f}",
        frame_bitwise=True, loss_bitwise=True,
        step_image_bitwise=bool(torch.equal(img_t, img_tm)),
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        **{f"{n}_ms": f"{v:.2f}" for n, v in ms.items()})
    return {k: sum(got["loaded", n][k] for n in run) for k in
            got["loaded", "frame"]}


def loaded_envmap_phase(dev, expected) -> dict:
    """[loaded-envmap]: BASELINE config #3's workflow on files
    (``envmap_files``: the stand-in's mesh as OBJ, its map as a PIZ EXR)
    at sppe and sppse 32, ``PathTracer(1)``: a frame and a step guided by
    one table that ``preprocess_secondary_edges`` builds (the same table
    on both sides), on the loaded scene and on ``envmap_arrays``' in
    memory, with ``[main-path-envmap]``'s K6 launches (``expected``). The
    frame and the loss are bitwise, the step's image and gradients within
    1e-5. Prints the map's EXR read and the importance table's build.
    Returns the loaded scene's launches."""
    import tempfile
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch import native

    W, H, S = ENVMAP
    with tempfile.TemporaryDirectory() as d:
        path = envmap_files(Path(d), W, H, S)
        _, exr_ms = _synced_ms(lambda: native.read_exr(str(Path(d)
                                                           / "map.exr")))
        t0 = time.perf_counter()
        sc = pt.load_file(path)
        load_ms = (time.perf_counter() - t0) * 1e3
    sc.opts.sppe = sc.opts.sppse = S
    _, configure_ms = _synced_ms(sc.configure)  # the importance table
    mem = pt.Scene.from_arrays(envmap_arrays(W, H, S, S, S), device=dev)
    mem.configure()
    guider = pt.PathTracer(ENVMAP_DEPTH)
    guider.preprocess_secondary_edges(mem, 0, ENVMAP_GUIDE, 1)
    table = guider.warpper[0]
    integ = pt.PathTracer(ENVMAP_DEPTH)

    def runs_of(scene):
        params, apply_params, pixel_loss = envmap_setup(scene)
        return {"frame": lambda: integ.renderC(scene, 0, seed=SEED),
                "step": lambda: integ.loss_and_grad(
                    scene, params, apply_params, pixel_loss, 0, SEED,
                    warp=table)}

    outs, got = _loaded_runs("loaded-envmap", {"memory": mem, "loaded": sc},
                             runs_of, expected)
    loss, grads, img_t = outs["loaded", "step"]
    loss_m, grads_m, img_tm = outs["memory", "step"]
    _same("loaded-envmap", "frame", outs["loaded", "frame"],
          outs["memory", "frame"])
    _same("loaded-envmap", "loss", loss, loss_m)
    rels = _grads_close("loaded-envmap", grads, grads_m)
    rels["step_image"] = rel_l1(img_t, img_tm)
    require(rels["step_image"] < 1e-5,
            "loaded-envmap: the step's image differs by >= 1e-5")
    run = runs_of(sc)
    ms = {n: wall_ms(f, 3) for n, f in run.items()}
    log("loaded-envmap", triangles=int(sc.data.tri.p0.shape[0]),
        exr_read_ms=f"{exr_ms:.1f}", load_file_ms=f"{load_ms:.1f}",
        configure_ms_with_table=f"{configure_ms:.1f}",
        frame_bitwise=True, loss_bitwise=True,
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        **{f"{n}_ms": f"{v:.2f}" for n, v in ms.items()})
    return {k: sum(got["loaded", n][k] for n in run) for k in
            got["loaded", "frame"]}


def intrinsic_arrays(arrays, opts=None) -> dict:
    """The scene of ``arrays`` with its camera replaced by the intrinsic
    one that sees what its field-of-view camera sees on a square film:
    ``fx = fy = cot(fov / 2) / 2`` (the float32 cotangent of the
    projection), ``cx = cy = 1/2``; ``opts`` replaces the render
    options."""
    import numpy as np
    from psdr_jit_tpu_torch.core import transform as xf

    a = {k: np.asarray(arrays[k]) for k in arrays.keys()}
    fov, near, far = (float(v) for v in a["sensor.0.fov_near_far"])
    f = 0.5 * float(xf.perspective(fov, near, far)[0, 0])
    a["sensor.0.intrinsic"] = np.asarray([f, f, 0.5, 0.5], np.float64)
    if opts is not None:
        a["opts"] = np.asarray(opts, np.int64)
    return a


def intrinsic_phases(dev, frame, expected) -> dict:
    """[intrinsic-64] and [intrinsic]: the box of ``cbox_scene.npz`` seen
    by ``PerspectiveCamera.from_intrinsic`` (``intrinsic_arrays``). At
    64x64, spp, sppe and sppse 8, a frame, a step and a forward-mode
    renderD through the kernels against the CPU plain path
    (``_compare_paths``: loss and images within 1e-4, gradients and
    tangent within 1e-3). At 512x512, spp 32, sppe and sppse 32, the
    frame (through K2, the megakernels taking the intrinsic camera's
    rays), a step and a forward renderD with the launches of the
    field-of-view camera's main paths (``expected``), the frame within
    1e-4 rel L1 of the field-of-view frame ``frame``. Returns the
    launches."""
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt

    arrays = np.load(SCENE_NPZ)
    w, h, s = INTRINSIC_SMALL

    def run(sc, device, target):
        r = _frame_and_step(DEPTH, lambda x: train_setup(x)[:2])(
            sc, device, target)
        r["primal"], r["tangent"] = renderd_tangent(
            pt.PathTracer(DEPTH), sc, train_setup(sc), "tx", 1.0)
        return r

    rels, ms, plain_ms = _compare_paths(
        "intrinsic-64", intrinsic_arrays(arrays, (w, h, s, s, s)), run, dev)
    log("intrinsic-64", spp=s, sppe=s, sppse=s, depth=DEPTH,
        rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
        ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")

    W, H, S = FRAME
    sc = pt.Scene.from_arrays(intrinsic_arrays(arrays, (W, H, S, SPPE,
                                                        SPPSE)), device=dev)
    cam = sc.sensors[0]
    require(cam.use_intrinsic, "intrinsic: the camera is not intrinsic")
    runs_of = _box_runs(pt.PathTracer(DEPTH))
    outs, got = _loaded_runs("intrinsic", {"intrinsic": sc}, runs_of,
                             expected)
    img = outs["intrinsic", "frame"]
    loss, grads, _ = outs["intrinsic", "step"]
    primal, tangent = outs["intrinsic", "renderD"]
    f_rel = rel_l1(img, frame)
    require(all(bool(x.isfinite().all()) for x in (img, loss, primal,
                                                   tangent, *grads.values()))
            and all(float(g.abs().sum()) > 0 for g in grads.values()),
            "intrinsic: a non-finite output or a zero gradient")
    require(f_rel < 1e-4, "intrinsic: the frame differs from the "
            "field-of-view camera's by >= 1e-4")
    run = runs_of(sc)
    ms = {n: wall_ms(f, 3) for n, f in run.items()}
    log("intrinsic", fx=f"{cam.fx:.9g}", fy=f"{cam.fy:.9g}", cx=cam.cx,
        cy=cam.cy, frame_rel_l1_vs_fov=f"{f_rel:.3e}",
        frame_bitwise_vs_fov=bool(torch.equal(img, frame)),
        loss=f"{float(loss):.6e}",
        **{f"{n}_ms": f"{v:.2f}" for n, v in ms.items()})
    return {k: sum(got["intrinsic", n][k] for n in run) for k in
            got["intrinsic", "frame"]}


# ---- the other integrators, path replay, the sharded step --------------------

INTEGRATORS_SMALL = (64, 64, 8)  # width, height, spp (= sppe = sppse)
COLLOCATED_INTENSITY = 2.0e5
FIELDS = ("bsdf", "segmentation", "silhouette", "position", "depth",
          "geoNormal", "shNormal", "uv")
ROOM_FILTER = f"segmentation obj:{ROOM_BRASS}"  # the brass block's hits
HIT_KERNELS = ("K1", "K2", "K2-pair", "K2-stash", "K5", "K6")
SHARD_TIMEOUT = 600  # seconds a sharded rank may take before it is killed


def box_arrays(width, height, spp, sppe, sppse) -> dict:
    """The Cornell box of ``SCENE_NPZ`` at another size and sample counts."""
    import numpy as np

    a = dict(np.load(SCENE_NPZ))
    a["opts"] = np.asarray([width, height, spp, sppe, sppse], np.int64)
    return a


def colloc_setup(scene):
    """``(params, apply_params)`` of a collocated step: ``train_setup``'s
    vertex offsets and reflectance (the collocated light ignores the
    area light, so its translation and radiance move nothing)."""
    params, apply, _ = train_setup(scene)

    def apply_params(p):
        apply({**params, **p})

    return {k: params[k] for k in ("dv", "alb")}, apply_params


def _integrator_run(make, setup=None):
    """The ``run`` of :func:`_compare_paths` for ``make()``'s frame and,
    with ``setup(scene) -> (params, apply_params)``, its training step and
    its reverse renderD (the gradients as ``renderD_<name>``, its image as
    ``primal``)."""

    def run(sc, device, target):
        integ = make()
        out = {"img": integ.renderC(sc, 0, seed=SEED)}
        if setup is None:
            return out
        params, apply_params = setup(sc)
        loss, grads, img_t = integ.loss_and_grad(
            sc, params, apply_params, l2_loss(target), 0, SEED)
        primal, g_rev = reverse_grads(integ, sc, params, apply_params,
                                      renderd_weight(sc.opts.num_pixels,
                                                     device))
        return dict(out, loss=loss, img_t=img_t, primal=primal,
                    grads={**grads, **{f"renderD_{k}": g
                                       for k, g in g_rev.items()}})

    return run


def integrators_64_phase(dev):
    """[integrators-64]: ``Direct(0|1|2)``, ``CollocatedIntegrator`` and
    every field of ``FieldExtractionIntegrator`` (and one filtered by
    mesh) on the 64x64 box at spp, sppe and sppse 8, the uv field on the
    UV-mapped box, through the kernels and, on the CPU, through the plain
    versions: a frame each; for ``Direct(2)`` and the collocated light a
    training step and a reverse renderD too."""
    import psdr_jit_tpu_torch as pt

    w, h, s = INTEGRATORS_SMALL
    box = box_arrays(w, h, s, s, s)
    uv_box = textured_cbox_arrays(w, h, s, 0, 0)
    cases = [("Direct(0)", box, lambda: pt.Direct(0), None),
             ("Direct(1)", box, lambda: pt.Direct(1), None),
             ("Direct(2)", box, lambda: pt.Direct(2),
              lambda sc: train_setup(sc)[:2]),
             ("Collocated", box,
              lambda: pt.CollocatedIntegrator(COLLOCATED_INTENSITY),
              colloc_setup)]
    cases += [(f, uv_box if f == "uv" else box,
               (lambda f: lambda: pt.FieldExtractionIntegrator(f))(f), None)
              for f in FIELDS + ("silhouette obj:2",)]
    for name, arrays, make, setup in cases:
        rels, ms, plain_ms = _compare_paths(f"integrators-64 {name}", arrays,
                                            _integrator_run(make, setup),
                                            dev)
        log("integrators-64", integrator=name, spp=s, sppe=s, sppse=s,
            rel_l1=",".join(f"{n}:{v:.3e}" for n, v in rels.items()),
            ms=f"{ms:.1f}", plain_cpu_ms=f"{plain_ms:.1f}")


def integrator_phases(dev) -> dict:
    """[main-path-integrators], [direct], [collocated], [field]: the other
    integrators at full size. ``Direct(2)`` on the box training cell
    (512x512, spp, sppe, sppse 32, ``train_setup``'s four parameters): a
    frame, a training step and a forward renderD along the light's
    translation; the collocated light on the 512x512 spp-32 box: a frame
    and a reverse renderD of the reflectance; the eight fields on the
    102,412-triangle gallery (K6) and the 1,292-triangle one (K5) at
    256x256, spp 4, and the room's segmentation filtered to the brass
    block (K1). With the launch counts set to 0 before each run and read
    after it, each against its routing's count (``Direct``: three hits a
    lane and Li, ``general_launches`` at depth 1; the others one), no
    other kernel, no plain version. Then their times. Returns the
    launches by kernel."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import _cuda

    W, H, S = FRAME
    n_pix = W * H
    box = pt.Scene.from_arrays(box_arrays(W, H, S, SPPE, SPPSE), device=dev)
    box_sd = box.configure()
    cbox = pt.Scene.from_arrays(box_arrays(W, H, S, 0, 0), device=dev)
    cbox.configure()
    direct = pt.Direct(2)
    colloc = pt.CollocatedIntegrator(COLLOCATED_INTENSITY)
    setup = train_setup(box)
    params, apply_params, loss_fn = setup
    c_params, c_apply = colloc_setup(cbox)
    c_params = {"alb": c_params["alb"]}
    w = renderd_weight(n_pix, dev)
    lw, lh, ls = LARGE
    galleries = {"K6": pt.Scene.from_arrays(gallery_arrays(lw, lh, ls),
                                            device=dev),
                 "K5": pt.Scene.from_arrays(gallery_arrays(lw, lh, ls, 4, 2),
                                            device=dev)}
    for g in galleries.values():
        g.configure()
    room = pt.Scene.from_arrays(room_arrays(*ROOM, 0, 0), device=dev)
    room.configure()
    fields = {f: pt.FieldExtractionIntegrator(f) for f in FIELDS}
    room_field = pt.FieldExtractionIntegrator(ROOM_FILTER)

    def chunks(lanes, size):
        return -(-lanes // size)

    frame_chunks = chunks(n_pix * S, base.interior_chunk_lanes(box_sd))
    runs = {
        "direct_frame": (lambda: direct.renderC(box, 0, seed=SEED),
                         {"K1": 3 * frame_chunks}),
        "direct_step": (lambda: direct.loss_and_grad(
            box, params, apply_params, loss_fn, 0, SEED),
            {"K1": general_launches(n_pix, S, SPPE, SPPSE, 1,
                                    base.TRAIN_CHUNK_LANES)}),
        "direct_renderD": (lambda: renderd_tangent(direct, box, setup, "tx",
                                                   1.0),
                           {"K1": general_launches(n_pix, S, SPPE, SPPSE, 1,
                                                   base.DIFF_CHUNK_LANES)}),
        "collocated_frame": (lambda: colloc.renderC(cbox, 0, seed=SEED),
                             {"K1": frame_chunks}),
        # the backward sweep replays the chunks' taped hits
        "collocated_renderD": (lambda: reverse_grads(
            colloc, cbox, c_params, c_apply, w),
            {"K1": chunks(n_pix * S, base.DIFF_CHUNK_LANES)}),
        **{f"fields_{k}": ((lambda g: lambda: [
            f.renderC(g, 0, seed=SEED) for f in fields.values()])(g),
            {k: len(FIELDS) * chunks(lw * lh * ls,
                                     base.GENERAL_CHUNK_LANES)})
           for k, g in galleries.items()},
        "field_room": (lambda: room_field.renderC(room, 0, seed=SEED),
                       {"K1": chunks(n_pix * S, base.GENERAL_CHUNK_LANES)}),
    }
    got, outs = {}, {}
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        for name, (fn, _) in runs.items():
            _cuda.reset_launches()
            plain.hits = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            got[name] = {k: v for k, v in rebuilds(
                f"main-path-integrators-{name}", _cuda.LAUNCHES,
                plain.hits).items() if v}
        plain_count = plain.count
    want = {n: e for n, (_, e) in runs.items()}
    log("main-path-integrators",
        **{f"{n}": ",".join(f"{k}:{v}" for k, v in g.items()) or "none"
           for n, g in got.items()},
        expected=";".join(f"{n}:" + ",".join(f"{k}:{v}" for k, v in e.items())
                          for n, e in want.items()),
        plain_calls=plain_count)
    require(all(got[n] == e for n, e in want.items()),
            "integrators main path: launches != the routing's")
    require(plain_count == 0, "integrators main path: a plain version ran")

    img = outs["direct_frame"]
    loss, grads, img_t = outs["direct_step"]
    primal, tangent = outs["direct_renderD"]
    require(tuple(img.shape) == (n_pix, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0, "direct frame: non-finite or black")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in grads.values()), "direct step: non-finite or zero gradient")
    require(bool(torch.isfinite(tangent).all())
            and float(tangent.abs().sum()) > 0,
            "direct renderD: non-finite or zero tangent")
    require(rel_l1(img_t, img) < 1e-2 and rel_l1(primal, img) < 1e-2,
            "direct: the step's image or renderD's primal is not the frame")
    c_img = outs["collocated_frame"]
    c_primal, c_grads = outs["collocated_renderD"]
    require(float(c_img.mean()) > 0 and torch.equal(c_primal, c_primal)
            and rel_l1(c_primal, c_img) < 1e-2
            and float(c_grads["alb"].abs().sum()) > 0,
            "collocated: a black frame, a primal off the frame or a zero "
            "gradient")
    for k in galleries:
        imgs = outs[f"fields_{k}"]
        require(all(bool(torch.isfinite(x).all()) for x in imgs)
                and float(imgs[FIELDS.index("silhouette")].mean()) > 0.05,
                f"fields on the {k} gallery: non-finite or empty")
    # a pixel's mean over its samples: 0 off the block, up to its index
    seg = outs["field_room"][:, 0]
    require(bool(((seg >= 0) & (seg <= ROOM_BRASS)).all())
            and float((seg == ROOM_BRASS).float().mean()) > 0.001,
            "room field: the filter let another mesh through or none")

    # bench.py:46-49 at depth 1: three rays a lane and Li
    frame_rays = n_pix * S * 3
    rays = n_pix * (S * 3 + SPPE * 2 * 3 + SPPSE * 3)
    parts = {n: measured(runs[n][0], r, dev) for n, r in (
        ("direct_frame", frame_rays), ("direct_step", rays),
        ("direct_renderD", rays))}
    log("direct", size=f"{W}x{H}", spp=S, sppe=SPPE, sppse=SPPSE, mis=2,
        frame_rays=frame_rays, rays=rays, loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        **{f"{n[7:]}_{k}": v for n, m in parts.items() for k, v in m.items()})
    cparts = {n: measured(runs[n][0], n_pix * S, dev)
              for n in ("collocated_frame", "collocated_renderD")}
    log("collocated", size=f"{W}x{H}", spp=S, intensity=COLLOCATED_INTENSITY,
        mean=f"{float(c_img.mean()):.6e}",
        grad_alb=",".join(f"{x:.4e}" for x in c_grads["alb"].tolist()),
        **{f"{n[11:]}_{k}": v for n, m in cparts.items()
           for k, v in m.items()})
    for k, g in galleries.items():
        log("field", scene=f"gallery-{k}", triangles=g.data.tri.p0.shape[0],
            size=f"{lw}x{lh}", spp=ls,
            **{f"{f}_ms": f"{wall_ms(lambda: i.renderC(g, 0, seed=SEED)):.2f}"
               for f, i in fields.items()})
    log("field", scene="room", field=ROOM_FILTER, size=f"{W}x{H}", spp=S,
        brass_share=f"{float((seg == ROOM_BRASS).float().mean()):.4f}",
        ms=f"{wall_ms(runs['field_room'][0]):.2f}")
    total = {}
    for g in got.values():
        for k, v in g.items():
            total[k] = total.get(k, 0) + v
    return total


def _reverse_counted(integ, scene, params, apply_params, weight):
    """A reverse renderD with its render and its backward sweep apart:
    ``(image, grads, forward launches, backward launches, forward ms,
    backward ms, taped GB)`` (host clock, each closed by a synchronize;
    the bytes of the payloads and radiances the tapes hold)."""
    import torch
    from psdr_jit_tpu_torch.integrator import prb
    from psdr_jit_tpu_torch.ops import _cuda

    taped = [0]
    append = prb.IntersectTape.append

    def counted(tape, payload):
        taped[0] += sum(t.numel() * t.element_size() for t in payload
                        if isinstance(t, torch.Tensor))
        append(tape, payload)

    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    apply_params(p)
    prb.IntersectTape.append = counted
    try:
        torch.cuda.synchronize()
        with PlainCalls() as plain:
            _cuda.reset_launches()
            t0 = time.perf_counter()
            img = integ.renderD(scene, 0, seed=SEED)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd = rebuilds("prb-forward", _cuda.LAUNCHES, plain.hits, 0)
            _cuda.reset_launches()
            plain.hits = 0
            grads = torch.autograd.grad((img * weight).sum(),
                                        list(p.values()))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bwd = rebuilds("prb-backward", _cuda.LAUNCHES, plain.hits, 0)
    finally:
        prb.IntersectTape.append = append
        apply_params(params)
    return (img.detach(), dict(zip(p, grads)), fwd, bwd, (t1 - t0) * 1e3,
            (t2 - t1) * 1e3, taped[0] / 1e9)


def prb_phase(dev) -> dict:
    """[prb]: reverse renderD of the 512x512 box (``PathTracer(3)``, spp,
    sppe, sppse 32, ``train_setup``'s four parameters) and of the room
    (``PathTracer(2)``, ``room_setup``'s three) under ``REMAT_MODE``
    "chunk" without the checkpoint policy (``base._policy_tape`` patched to
    None: the backward sweep traces every chunk again), "chunk" with it,
    and "prb": the primal bit for bit, the gradients within 1e-5 rel L1 of
    the first, no hit kernel launched in the backward sweep of the last
    two; their ms and peak GB. Returns the launches of the policy's and
    path replay's renders."""
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.integrator import base

    W, H, S = FRAME
    cases = {"box": (box_arrays(W, H, S, SPPE, SPPSE), DEPTH,
                     lambda sc: train_setup(sc)[:2]),
             "room": (room_arrays(*ROOM, ROOM[2], ROOM[2]), ROOM_DEPTH,
                      room_setup)}
    modes = ("chunk_without_policy", "chunk", "prb")
    total = {}
    for name, (arrays, depth, setup) in cases.items():
        sc = pt.Scene.from_arrays(arrays, device=dev)
        sc.configure()
        integ = pt.PathTracer(depth)
        params, apply_params = setup(sc)
        w = renderd_weight(sc.opts.num_pixels, dev)
        res, timing = {}, {}
        for mode in modes:
            old = base.REMAT_MODE, base._policy_tape
            base.REMAT_MODE = "prb" if mode == "prb" else "chunk"
            if mode == "chunk_without_policy":
                base._policy_tape = lambda: None
            try:
                res[mode] = _reverse_counted(integ, sc, params, apply_params,
                                             w)  # also the warm-up
                torch.cuda.reset_peak_memory_stats(dev)
                runs = [_reverse_counted(integ, sc, params, apply_params, w)
                        for _ in range(3)]
                timing[mode] = (
                    statistics.median(r[4] + r[5] for r in runs),
                    statistics.median(r[5] for r in runs),
                    torch.cuda.max_memory_allocated(dev) / 1e9)
            finally:
                base.REMAT_MODE, base._policy_tape = old
        img0, g0, fwd0, bwd0 = res[modes[0]][:4]
        rels = {m: max(rel_l1(res[m][1][k], g0[k]) for k in g0)
                for m in modes[1:]}
        log("prb", scene=name, depth=depth, size=f"{W}x{H}", spp=S,
            **{f"{m}_{k}": v for m in modes for k, v in (
                ("ms", f"{timing[m][0]:.2f}"),
                ("backward_ms", f"{timing[m][1]:.2f}"),
                ("peak_gb", f"{timing[m][2]:.3f}"),
                ("taped_gb", f"{res[m][6]:.4f}"),
                ("forward_launches", ",".join(
                    f"{k}:{v}" for k, v in res[m][2].items() if v)),
                ("backward_launches", ",".join(
                    f"{k}:{v}" for k, v in res[m][3].items() if v)
                 or "none"))},
            primal_bitwise=",".join(
                f"{m}:{torch.equal(res[m][0], img0)}" for m in modes[1:]),
            grad_rel_l1=",".join(f"{m}:{v:.3e}" for m, v in rels.items()))
        require(all(torch.equal(res[m][0], img0) for m in modes[1:]),
                f"prb {name}: a mode's primal differs")
        require(all(v < 1e-5 for v in rels.values()),
                f"prb {name}: a mode's gradients differ by >= 1e-5")
        require(all(float(g.abs().sum()) > 0 and bool(torch.isfinite(g).all())
                    for g in g0.values()), f"prb {name}: a zero gradient")
        require(sum(bwd0[k] for k in HIT_KERNELS) > 0,
                f"prb {name}: the checkpoints without the policy traced "
                "nothing again")
        require(all(res[m][3][k] == 0 for m in modes[1:]
                    for k in HIT_KERNELS),
                f"prb {name}: a hit kernel ran in the backward sweep")
        for m in modes[1:]:
            for k, v in res[m][2].items():
                total[k] = total.get(k, 0) + v
    return total


def _sharded_runs(mesh, dev, reps: int) -> dict:
    """This rank's part of [sharded]: the room's guided training step
    (``make_fused_train_step``) and frame (``render_sharded``), timed;
    everything returned on the CPU. (``dev`` is the card; a CPU device
    rehearses the phase without one.)"""
    import numpy as np
    import torch
    import torch.distributed as dist
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch import parallel
    from psdr_jit_tpu_torch.scene.scene import tree_map

    W, H, S = ROOM
    sc = pt.Scene.from_arrays(room_arrays(W, H, S, S, S), device=dev)
    sc.configure()
    integ = pt.PathTracer(ROOM_DEPTH)
    integ.preprocess_secondary_edges(sc, 0, GUIDE_RESO, 1)
    own = tree_map(lambda t: t.cpu(), integ.warpper[0])
    p3, apply3 = room_setup(sc)
    target = torch.from_numpy(np.random.default_rng(SEED).random(
        (W * H, 3)).astype(np.float32)).to(dev)
    step = parallel.make_fused_train_step(sc, integ, mesh, apply3,
                                          l2_loss(target))
    loss, grads, img = step(p3, SEED)
    frame = parallel.render_sharded(integ, sc, mesh, 0, SEED, "C")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = []
    for _ in range(reps):
        dist.barrier(group=mesh.group)
        sync()
        t0 = time.perf_counter()
        step(p3, SEED)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": loss.cpu(), "grads": {k: g.cpu() for k, g in
                                          grads.items()},
            "image": img.cpu(), "frame": frame.cpu(), "own_table": own,
            "table": tree_map(lambda t: t.cpu(), integ.warpper[0]),
            "step_ms": times,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else 0.0)}


def _sharded_rank(rank: int, world: int, port: int, out: str, reps: int,
                  device: str):
    """A spawned rank of [sharded]: gloo on ``device``."""
    import datetime
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from psdr_jit_tpu_torch import parallel

    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        res = _sharded_runs(parallel.make_device_mesh(dev), dev, reps)
        torch.save(res, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_phase(dev):
    """[sharded]: BASELINE config #5's room (512x512, spp, sppe, sppse 32,
    ``PathTracer(2)``, guided by ``GUIDE_RESO``) through
    ``make_fused_train_step`` and ``render_sharded`` on two gloo ranks
    spawned on the one card, and on one NCCL rank in this process, each
    held against the unsharded step on the card with rank 0's guiding
    table: the step's image (interior rows) and the frame bit for bit, the
    loss within 1e-6 rel, the gradients within 1e-5 rel L1, the two ranks'
    tables bit for bit. The two ranks share one card: their ms a step is
    no scaling figure."""
    import datetime
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch import parallel
    from psdr_jit_tpu_torch.scene.scene import tree_map

    reps = 3
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        outs = [str(Path(tmp) / f"rank{r}.pt") for r in range(2)]
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_sharded_rank,
                             args=(r, 2, port, outs[r], reps, str(dev)))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + SHARD_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.time(), 1))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        require(not hung and all(p.exitcode == 0 for p in procs),
                f"sharded: a gloo rank failed (exit codes "
                f"{[p.exitcode for p in procs]})")
        ranks = [torch.load(o, weights_only=False) for o in outs]
        gloo_s = time.perf_counter() - t0

    cuda = dev.type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT),
                            **({"device_id": dev} if cuda else {}))
    try:
        nccl = _sharded_runs(parallel.make_device_mesh(dev), dev, reps)
    finally:
        dist.destroy_process_group()

    W, H, S = ROOM
    sc = pt.Scene.from_arrays(room_arrays(W, H, S, S, S), device=dev)
    sc.configure()
    integ = pt.PathTracer(ROOM_DEPTH)
    p3, apply3 = room_setup(sc)
    target = torch.from_numpy(np.random.default_rng(SEED).random(
        (W * H, 3)).astype(np.float32)).to(dev)

    def unsharded(table):
        warp = tree_map(lambda t: t.to(dev), table)
        return integ.loss_and_grad(sc, p3, apply3, l2_loss(target), 0, SEED,
                                   warp=warp)

    frame = integ.renderC(sc, 0, seed=SEED).cpu()
    checks = {}
    for name, res in (("gloo2_rank0", ranks[0]), ("gloo2_rank1", ranks[1]),
                      ("nccl1", nccl)):
        loss, grads, img = unsharded(res["table"])
        checks[name] = {
            "image_bitwise": torch.equal(res["image"], img.cpu()),
            "frame_bitwise": torch.equal(res["frame"], frame),
            "loss_rel": abs(float(res["loss"]) - float(loss))
            / abs(float(loss)),
            "grad_rel_l1": max(rel_l1(res["grads"][k], g.cpu())
                               for k, g in grads.items())}
    unsharded_ms = wall_ms(lambda: unsharded(ranks[0]["table"]), reps)

    def table_equal(a, b):
        return all(torch.equal(x, y) for x, y in (
            (a.distrb.pmf, b.distrb.pmf), (a.distrb.cdf, b.distrb.cdf))) and (
            (a.distrb.alias_rows is None and b.distrb.alias_rows is None)
            or torch.equal(a.distrb.alias_rows, b.distrb.alias_rows))

    tables_equal = table_equal(ranks[0]["table"], ranks[1]["table"])
    own_equal = table_equal(ranks[1]["own_table"], ranks[0]["own_table"])
    # each rank pulls the summed leaf gradients back through its own scene
    # compile: the ranks' gradients are logged against each other
    ranks_rel = max(rel_l1(g, ranks[0]["grads"][k])
                    for k, g in ranks[1]["grads"].items())
    log("sharded", scene="room", size=f"{W}x{H}", spp=S, sppe=S, sppse=S,
        depth=ROOM_DEPTH, guide=",".join(map(str, GUIDE_RESO)),
        **{f"{n}_{k}": (f"{v:.3e}" if isinstance(v, float) else v)
           for n, c in checks.items() for k, v in c.items()},
        gloo2_step_ms=",".join(
            f"{max(a, b):.1f}" for a, b in zip(ranks[0]["step_ms"],
                                               ranks[1]["step_ms"])),
        gloo2_peak_gb=",".join(f"{r['peak_gb']:.3f}" for r in ranks),
        nccl1_step_ms=",".join(f"{x:.1f}" for x in nccl["step_ms"]),
        nccl1_peak_gb=f"{nccl['peak_gb']:.3f}",
        unsharded_step_ms=f"{unsharded_ms:.1f}",
        tables_bitwise=tables_equal, own_tables_bitwise=own_equal,
        ranks_loss_bitwise=torch.equal(ranks[0]["loss"], ranks[1]["loss"]),
        ranks_grad_rel_l1=f"{ranks_rel:.3e}", gloo_seconds=f"{gloo_s:.1f}")
    require(tables_equal, "sharded: the two ranks' guiding tables differ")
    for name, c in checks.items():
        require(c["image_bitwise"] and c["frame_bitwise"],
                f"sharded {name}: interior rows differ from the unsharded")
        require(c["loss_rel"] < 1e-6, f"sharded {name}: loss off by >= 1e-6")
        require(c["grad_rel_l1"] < 1e-5,
                f"sharded {name}: gradients off by >= 1e-5 rel L1")


# ---- the reference-compatible surface and the examples ([api], [examples])
API_SMALL = (64, 64, 4)  # width, height, spp (= sppe = sppse) of [api]
# examples/torch_*.py run in-process at their default sizes, then the two
# multi-process ones, each as its own launcher with ranks of their own
EXAMPLES = ("batch_render", "field_aovs", "forward_ad", "forward_ad_envmap",
            "inverse_albedo", "secondary_edge_guiding", "fused_training",
            "checkpointed_optimization", "room_optimization")
MULTI_EXAMPLES = ("sharded_render", "multihost_training")
EXAMPLE_RANK_TIMEOUT = 300  # seconds a rank of an example may take
# the launches each example makes at its default size: chunks of 2^21
# (general) to 2^23 (K2) lanes, each Li 1 + 2 depth hits, a secondary-edge
# chunk 3, a primary-edge chunk 2 Li (K2 pair on the box)
EXAMPLE_LAUNCHES = {
    "batch_render": {"K2": 2},
    "field_aovs": {"K1": 7},
    "forward_ad": {"K1": 10, "K2": 1, "K2-pair": 1},
    "forward_ad_envmap": {"K1": 12},
    "inverse_albedo": {"K1": 500, "K2": 1},
    "secondary_edge_guiding": {"K1": 27},  # 3 of them the guiding pass
    "fused_training": {"K1": 120, "K2": 1, "K2-pair": 40, "K2-stash": 40,
                       "K3": 40, "K4": 40},
    "checkpointed_optimization": {"K1": 120, "K2": 1},
    "room_optimization": {"K1": 1445},
    "sharded_render": {"K2": 3},
    "multihost_training": {"K1": 150, "K2": 2, "K2-pair": 50,
                           "K2-stash": 50, "K3": 50, "K4": 50},
}


def api_phase(dev) -> dict:
    """[api]: the reference-compatible surface on the card. The smoke
    checks ``drjit_test``, ``drjit_memory`` and ``optix_jit_test`` (K1
    once, no plain version); ``unit_ray_intersectAD`` on the box's pixel
    centres (every hit and id as ``unit_ray_intersect``'s, ``t`` within
    1e-4 rel); a forward-mode renderD of the 64x64 box along a
    ``set_transform`` translation of the tall block against the same
    translation on ``to_world_raw`` (the same matrix product: the primal
    bitwise, the tangent within 1e-5, ``index_add_``'s float atomics) and
    against the CPU plain path (1e-4); and ``configure(active_sensors)``
    on BASELINE config #4's four-sensor textured box
    (:func:`textured_cbox_arrays`, 512x512, spp, sppe, sppse 32): primary-
    edge tables for sensor 0 only, and sensor 0's step the same (loss and
    image bitwise, gradients within 1e-5: float atomics), with the ms of
    ``configure`` and of a step with four active sensors and with one.
    Returns the phase's launches."""
    import numpy as np
    import torch
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda

    launches = {k: 0 for k in _cuda.LAUNCHES if k not in K7_KEYS}

    def counted(fn):
        with PlainCalls() as calls:
            _cuda.reset_launches()
            out = fn()
            torch.cuda.synchronize()
        got = rebuilds("api", _cuda.LAUNCHES, calls.hits)
        for k, v in got.items():
            launches[k] += v
        return out, got

    torch.cuda.synchronize()
    with PlainCalls() as plain:
        oks, smoke = counted(lambda: (pt.drjit_test(dev),
                                      pt.drjit_memory(dev),
                                      pt.optix_jit_test(dev)))
    require(all(oks), "api: a smoke check failed")
    require(smoke["K1"] == 1 and sum(smoke.values()) == 1,
            "api: optix_jit_test did not launch K1 (only) once")
    require(plain.count == 0, "api: optix_jit_test ran a plain version")

    arrays = np.load(SCENE_NPZ)
    box = pt.Scene.from_arrays(arrays, device=dev)
    sd = box.configure()
    rays = pixel_center_rays(sd, *FRAME[:2], dev)
    (its, its_ad), picks = counted(lambda: (
        box.unit_ray_intersect(rays.o, rays.d),
        box.unit_ray_intersectAD(rays.o, rays.d)))
    hit = its.valid
    t_rel = float(((its_ad.t - its.t).abs() / its.t.abs())[hit].max())
    require(bool(torch.equal(its.valid, its_ad.valid))
            and bool(torch.equal(its.tri_id, its_ad.tri_id)),
            "api: unit_ray_intersectAD hits differ from unit_ray_intersect")
    require(t_rel < 1e-4, "api: unit_ray_intersectAD t off by >= 1e-4 rel")

    e03 = torch.zeros(4, 4)
    e03[0, 3] = 1.0
    w, h, spp = API_SMALL
    out = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        sc = pt.Scene.from_arrays(arrays, device=device)
        sc.opts = pt.RenderOption(w, h, spp, spp, spp)
        sc.configure()
        block = sc.meshes[2]
        base = block.to_world_raw.clone()
        integ = pt.PathTracer(DEPTH)
        zero = torch.zeros(())

        def via_left(x):
            block.set_transform(torch.eye(4) + e03 * x)

        def via_raw(x):
            block.to_world_raw = base + e03 * x

        out[name, "left"], _ = counted(
            lambda: forward_mode(integ, sc, via_left, zero, 1.0))
        if name == "kernels":
            out[name, "raw"], _ = counted(
                lambda: forward_mode(integ, sc, via_raw, zero, 1.0))
    (p_l, t_l), (p_r, t_r) = out["kernels", "left"], out["kernels", "raw"]
    p_c, t_c = out["plain", "left"]
    rels = {"left_vs_raw_tangent": rel_l1(t_l, t_r),
            "primal_vs_plain": rel_l1(p_l.cpu(), p_c),
            "tangent_vs_plain": rel_l1(t_l.cpu(), t_c)}
    require(bool(torch.equal(p_l, p_r)), "api: renderD's primal along "
            "set_transform differs from the one along to_world_raw")
    require(rels["left_vs_raw_tangent"] < 1e-5, "api: the set_transform "
            "tangent differs from the to_world_raw one by >= 1e-5")
    require(rels["primal_vs_plain"] < 1e-4 and rels["tangent_vs_plain"]
            < 1e-4, "api: set_transform renderD differs from the CPU plain "
            "path by >= 1e-4")
    require(float(t_l.abs().sum()) > 0, "api: the set_transform tangent "
            "is zero")

    tex = pt.Scene.from_arrays(textured_cbox_arrays(), device=dev)
    params, apply_params = textured_setup(tex)
    loss = l2_loss(torch.zeros((tex.opts.num_pixels, 3), device=dev))
    integ = pt.PathTracer(TEXTURED_DEPTH)

    def step():
        return integ.loss_and_grad(tex, params, apply_params, loss, 0, SEED)

    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for name, active in (("all", None), ("one", [0])):
        _, cfg_ms = _synced_ms(lambda: tex.configure(active_sensors=active))
        tables = [s.edge_info is not None for s in tex.data.sensors]
        (res, got), step_ms = _synced_ms(lambda: counted(step))
        runs[name] = dict(res=res, tables=tables, configure_ms=cfg_ms,
                          step_ms=step_ms, launches=got)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    (l_a, g_a, i_a), (l_o, g_o, i_o) = runs["all"]["res"], runs["one"]["res"]
    require(runs["all"]["tables"] == [True] * 4
            and runs["one"]["tables"] == [True, False, False, False],
            "api: configure(active_sensors=[0]) did not build the primary-"
            "edge tables of sensor 0 alone")
    require(bool(torch.equal(l_a, l_o)) and bool(torch.equal(i_a, i_o)),
            "api: sensor 0's loss or image changed with one active sensor")
    g_rel = {k: rel_l1(g_o[k], g_a[k]) for k in g_a}
    require(all(v < 1e-5 for v in g_rel.values()), "api: sensor 0's "
            "gradients changed with one active sensor by >= 1e-5")
    log("api", smoke_launches=",".join(f"{k}:{v}" for k, v in smoke.items()
                                       if v),
        plain_calls=plain.count, picks=int(hit.numel()),
        picks_hit=f"{float(hit.float().mean()):.4f}",
        intersectAD_t_max_rel=f"{t_rel:.3e}",
        set_transform=f"{w}x{h}spp{spp}",
        primal_bitwise_vs_raw=True,
        rel_l1=",".join(f"{k}:{x:.3e}" for k, x in rels.items()),
        textured=f"{tex.opts.width}x{tex.opts.height}spp{tex.opts.spp}",
        configure_ms=",".join(f"{k}:{r['configure_ms']:.1f}"
                              for k, r in runs.items()),
        step_ms=",".join(f"{k}:{r['step_ms']:.1f}" for k, r in runs.items()),
        step_K1=",".join(f"{k}:{r['launches']['K1']}"
                         for k, r in runs.items()),
        grads_bitwise=all(bool(torch.equal(g_o[k], g_a[k])) for k in g_a),
        grad_rel_l1=",".join(f"{k}:{x:.3e}" for k, x in g_rel.items()),
        peak_gb=f"{peak_gb:.3f}")
    return launches


def examples_phase(dev) -> dict:
    """[examples]: every ``examples/torch_*.py`` ``main()`` at its default
    size on the card, each with its own check: the in-process ones with
    the launch counts set to 0 before and read after, the two
    multi-process ones as launchers of rank processes (gloo, the ranks
    sharing the card; each rank prints its launches, which are summed).
    Each example's launches must be :data:`EXAMPLE_LAUNCHES`'s. Returns
    the launches of all."""
    import importlib
    import inspect
    import re
    import tempfile
    import torch
    from psdr_jit_tpu_torch.ops import _cuda

    sys.path.insert(0, str(ROOT / "examples"))
    total = {k: 0 for k in _cuda.LAUNCHES if k not in K7_KEYS}
    with tempfile.TemporaryDirectory() as d:
        for name in EXAMPLES + MULTI_EXAMPLES:
            mod = importlib.import_module(f"torch_{name}")
            kwargs = {"device": "cuda"}
            if "outdir" in inspect.signature(mod.main).parameters:
                kwargs["outdir"] = d
            log_path = Path(d) / f"{name}.log"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _cuda.reset_launches()
            t0 = time.perf_counter()
            if name in MULTI_EXAMPLES:
                with open(log_path, "w") as f:
                    ok = mod.main(timeout=EXAMPLE_RANK_TIMEOUT, stdout=f,
                                  **kwargs)
                text = log_path.read_text()
                print(text, end="")
                require(ok, f"examples: {name} failed")
                ranks = dict.fromkeys(_cuda.LAUNCHES, 0)
                for m in re.finditer(r"kernel launches: (\{.*\})", text):
                    for k, v in json.loads(m.group(1)).items():
                        ranks[k] += v
                got = rebuilds(f"examples-{name}", ranks, None)
            else:
                with PlainCalls() as calls:
                    result = mod.main(**kwargs)
                    torch.cuda.synchronize()
                got = rebuilds(f"examples-{name}", _cuda.LAUNCHES, calls.hits)
                flat = [x for x in (result if isinstance(result, (tuple,
                        list)) else [result]) if isinstance(x, torch.Tensor)]
                require(all(bool(torch.isfinite(x).all()) for x in flat),
                        f"examples: {name} returned non-finite values")
            seconds = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            want = EXAMPLE_LAUNCHES[name]
            log("examples", example=name, seconds=f"{seconds:.2f}",
                peak_gb=f"{peak_gb:.3f}" if name not in MULTI_EXAMPLES
                else "in-ranks",
                **{f"{k}_LAUNCHES": v for k, v in got.items() if v},
                expected=",".join(f"{k}:{v}" for k, v in want.items()))
            require({k: v for k, v in got.items() if v} == want,
                    f"examples: {name}'s launches are not the predicted")
            for k, v in got.items():
                total[k] += v
    return total


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
    from psdr_jit_tpu_torch.scene.scene import tree_map

    t_start = time.perf_counter()
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
    tables = mk.build_tables(sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 2. K1 vs plain ---------------------------------------------------
    picks = pixel_center_rays(sd, W, H, dev)
    kernels["K1"] = k1_phase("K1", sd, dev, gen, True)
    k1_gallery = pt.Scene.from_arrays(gallery_arrays(**K1_GALLERY),
                                      device=dev)
    k1_phase("K1-492", k1_gallery.configure(), dev, gen, False)
    kernels["K7"] = {"kernel": "K7", **k7_phase(dev)}

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
    log("K2", lanes=o2.shape[0], depth=DEPTH,
        ptxas=ptxas_report("li_mega_kernel"), rel_l1=f"{k2_rel:.3e}",
        max_abs_err=f"{k2_err:.3e}", finite=bool(torch.isfinite(li_k).all()),
        ms=f"{k2_crop_ms:.4f}", plain_ms=f"{k2_crop_plain_ms:.4f}")
    require(bool(torch.isfinite(li_k).all()), "K2: non-finite radiance")
    require(k2_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3")

    # K2 alone at the frame's shape, each renderC chunk's launch, against
    # its plain version on the same inputs
    step = CHUNK_LANES // SPP
    k2_frame_ms = k2_frame_plain_ms = 0.0
    frame_err = frame_diff = frame_ref = 0.0
    k2_bytes = k2_flops = k2_tests = k2_sweeps = lanes_off = 0
    for s in range(0, n_pix, step):
        m, sampler, samples = interior_lane_setup(
            W, H, SPP, SEED, torch.arange(s, min(s + step, n_pix),
                                          device=dev))
        ray = sd.sensors[0].sample_primary_ray(samples)
        args = (*tables, ray.o.contiguous(), ray.d.contiguous(),
                torch.ones(m * SPP, dtype=torch.bool, device=dev),
                sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
        record = []
        li_p = mk.li_mega_plain(*args, record=record)
        li_k = mk.li_mega_cuda(*args)
        diff = (li_k - li_p).abs()
        frame_err = max(frame_err, float(diff.max()))
        frame_diff += float(diff.sum())
        frame_ref += float(li_p.abs().sum())
        lanes_off += int((li_k != li_p).any(-1).sum())
        k2_frame_ms += cuda_ms(lambda: mk.li_mega_cuda(*args), 5)
        k2_frame_plain_ms += cuda_ms(lambda: mk.li_mega_plain(*args), 1)
        nbytes, flops, tests = k2_bound_terms(args, record, False, False)
        k2_bytes += nbytes
        k2_flops += flops
        k2_tests += tests
        k2_sweeps += len(record) * m * SPP
        del record, li_k
    frame_rel = frame_diff / max(frame_ref, 1e-30)
    k2_bound = bound(k2_bytes, k2_flops)
    log("K2-frame", lanes=n_pix * SPP, rel_l1=f"{frame_rel:.3e}",
        max_abs_err=f"{frame_err:.3e}", lanes_off=lanes_off,
        ms=f"{k2_frame_ms:.3f}", plain_ms=f"{k2_frame_plain_ms:.3f}",
        bound_ms=f"{k2_bound[0]:.4f}", bound_by=k2_bound[1],
        needed_tests_per_lane_sweep=f"{k2_tests / k2_sweeps:.2f}")
    require(frame_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3 on the frame")
    kernels["K2"] = dict(
        name="K2 detached Li megakernel", route="cuda",
        source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:591",
        max_abs_err=max(k2_err, frame_err), ms=k2_frame_ms,
        plain_ms=k2_frame_plain_ms, bound_ms=k2_bound[0],
        bound_by=k2_bound[1], library_ms=None)

    # ---- 3a. K2 beyond the box, and on exact ties --------------------------
    k2_top_err = k2_top_phase(dev)
    k2_tie_phase(dev)

    # ---- 3b. K2 pair and stash, K3, K4 vs plain on 131,072-lane crops ------
    edge_scene = pt.Scene.from_arrays(arrays, device=dev)
    edge_scene.opts.sppe = SPPE
    train_kernel_phases(sd, edge_scene.configure(), tables, dev, gen, kernels)
    for k, err in k2_top_err.items():
        kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"], err)

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
        launches = rebuilds("main-path", _cuda.LAUNCHES, plain.hits, 0, 0)
    require(plain.hits == 1, "main path: the picks are not the one hit set")
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

    # ---- 6. 64x64 training steps: the kernels against the plain path -------
    compare_steps("train-64", arrays, dev, pt.RenderOption(64, 64, 8, 8, 0))
    compare_steps("train-se-64", arrays, dev,
                  pt.RenderOption(64, 64, 8, 8, 8))
    # guided: one table built on the card, the same table on both sides
    # (the card's mass table sums with float atomics)
    guide = pt.Scene.from_arrays(arrays, device=dev)
    guide.opts = pt.RenderOption(64, 64, 8, 8, 8)
    guider = pt.PathTracer(DEPTH)
    guider.preprocess_secondary_edges(guide, 0, [8, 8, 8, 4], 1)
    table = guider.warpper[0]
    compare_steps("train-se-64-guided", arrays, dev,
                  pt.RenderOption(64, 64, 8, 8, 8),
                  warp=lambda device: tree_map(lambda x: x.to(device),
                                               table))

    # ---- 7. the training main path at full size -----------------------------
    se_k1_phase(arrays, dev, gen, kernels)
    scene0 = pt.Scene.from_arrays(arrays, device=dev)
    scene0.opts.sppe = SPPE
    step0 = train_step_fn(integrator, scene0)
    train_scene = pt.Scene.from_arrays(arrays, device=dev)
    train_scene.opts.sppe, train_scene.opts.sppse = SPPE, SPPSE
    step = train_step_fn(integrator, train_scene)
    train_frame_phase(step, kernels)
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        loss, grads, img_t = step()
        torch.cuda.synchronize()
        k1_step = se_k1_launches(n_pix, SPPSE)
        # one attached hit set of the three a secondary-edge chunk
        launches_t = rebuilds("main-path-train", _cuda.LAUNCHES, plain.hits,
                              0, k1_step // 3)
    require(plain.hits == k1_step, "training main path: hit sets rebuilt "
            "!= SE chunks x hit sets a chunk")
    log("main-path-train", **{f"{k}_LAUNCHES": v for k, v in
                              launches_t.items()},
        K1_expected=k1_step, plain_calls=plain.count)
    for k in ("K1", "K2-stash", "K3", "K4", "K2-pair"):
        require(launches_t[k] > 0, f"training main path: {k} not launched")
    require(launches_t["K1"] == k1_step,
            "training main path: K1 launches != SE chunks x launches a chunk")
    require(plain.count == 0, "training main path: a plain version ran")
    require(launches_t["K2-stash"] == launches_t["K3"] == launches_t["K4"],
            "training main path: stash, K3 and K4 launches differ")
    require(tuple(img_t.shape) == (n_pix, 3), "train: wrong image shape")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values()),
        "train: non-finite loss or gradient")
    require(all(float(g.abs().sum()) > 0 for g in grads.values()),
            "train: a parameter got no gradient")
    _, grads0, _ = step0()
    se_moved = {k: rel_l1(grads[k], grads0[k]) for k in ("tx", "dv")}
    require(all(se_moved[k] > v for k, v in SE_MOVED_MIN.items()),
            "train: the secondary-edge term did not move the geometry "
            "gradients beyond the run-to-run spread")
    _, grads_again, _ = step()
    spread = {k: rel_l1(grads_again[k], grads[k]) for k in ("tx", "dv")}
    # the step's image is the attached Li (K3 over K2-stash's hits): the
    # frame's radiance up to the stash's bilinear bounce origins
    t_rel = rel_l1(img_t, img)
    require(t_rel < 1e-3, "train: image differs from renderC's frame")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    step0_ms = wall_ms(step0, 3)
    se_ms = se_pass_ms(step, 3)
    # bench.py:46-49: spp (1 + 2d) + sppe 2 (1 + 2d) + sppse 3 rays a pixel
    rays = n_pix * (SPP * (1 + 2 * DEPTH) + SPPE * 2 * (1 + 2 * DEPTH)
                    + SPPSE * 3)
    log("train", size=f"{W}x{H}", spp=SPP, sppe=SPPE, sppse=SPPSE,
        depth=DEPTH, loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        se_moved_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in
                                 se_moved.items()),
        run_to_run_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in
                                   spread.items()),
        image_rel_l1_vs_frame=f"{t_rel:.3e}", step_ms=f"{step_ms:.2f}",
        peak_gb=f"{peak_gb:.3f}", mrays_per_s=f"{rays / step_ms / 1e3:.1f}",
        rays=rays, step_sppse0_ms=f"{step0_ms:.2f}",
        se_pass_ms=f"{se_ms:.2f}", se_share=f"{se_ms / step_ms:.3f}")

    # ---- 7a. a guided step at full size -------------------------------------
    guided = pt.PathTracer(DEPTH)
    _, cold_ms = _synced_ms(lambda: guided.preprocess_secondary_edges(
        train_scene, 0, GUIDE_RESO, 1))
    _, warm_ms = _synced_ms(lambda: guided.preprocess_secondary_edges(
        train_scene, 0, GUIDE_RESO, 1))
    table = guided.warpper[0]
    require(table.needs_coin, "train-guided: the table has no alias rows")
    step_g = train_step_fn(guided, train_scene)
    loss_g, grads_g, _ = step_g()
    guided_ms = wall_ms(step_g, 3)
    log("train-guided", reso=",".join(map(str, GUIDE_RESO)),
        cells=table.num_cells,
        nonzero_cells=int((table.distrb.pmf > 0).sum()),
        preprocess_ms_cold=f"{cold_ms:.2f}",
        preprocess_ms=f"{warm_ms:.2f}", step_ms=f"{guided_ms:.2f}",
        loss=f"{float(loss_g):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads_g.items()))
    require(bool(torch.isfinite(loss_g)) and all(
        bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
        for g in grads_g.values()),
        "train-guided: non-finite or zero loss or gradient")
    require(int((table.distrb.pmf > 0).sum()) > 0,
            "train-guided: an empty guiding table")

    # ---- 7b. renderD: forward and reverse mode -----------------------------
    renderd_64_phase(arrays, dev)
    launches_d = renderd_phase(arrays, dev, img)

    # ---- 8. the large-scene path --------------------------------------------
    launches_l = large_scene_phases(kernels, dev, gen)
    k1_frame_phase(dev)
    launches_dk5 = renderd_k5_phase(dev)

    # ---- 9. the envmap path (BASELINE config #3 on the stand-in) -----------
    t_env = time.perf_counter()
    envmap_64_phase(dev)
    launches_e = envmap_phases(dev, kernels)
    env_s = time.perf_counter() - t_env

    # ---- 10. torch.func.jvp on the card -------------------------------------
    func_jvp_phase(arrays, dev)

    # ---- 11. the textured path (BASELINE config #4) ---------------------------
    t_tex = time.perf_counter()
    texture_64_phase(dev)
    launches_x = textured_phases(dev)
    tex_s = time.perf_counter() - t_tex

    # ---- 12. the gallery training step ---------------------------------------
    t_gal = time.perf_counter()
    launches_g = gallery_step_phases(dev)
    gal_s = time.perf_counter() - t_gal

    # ---- 13. the other BSDFs and the room (BASELINE config #5) ---------------
    t_room = time.perf_counter()
    bsdf_64_phase(dev)
    room_64_phase(dev)
    launches_r = room_phases(dev, kernels)
    room_s = time.perf_counter() - t_room

    # ---- 14. scene files: the host library, the loader, intrinsics ---------
    t_files = time.perf_counter()
    files_phase()
    box_want = {"frame": {**launches, "K1": launches["K1"] - 1},
                "step": launches_t, "renderD": launches_d}
    launches_lc = loaded_cbox_phase(dev, box_want, img)
    launches_le = loaded_envmap_phase(
        dev, {k: launches_e["runs"][k] for k in ("frame", "step")})
    launches_i = intrinsic_phases(dev, img, box_want)
    files_s = time.perf_counter() - t_files

    # ---- 15. the other integrators, path replay, the sharded room ----------
    t_int = time.perf_counter()
    integrators_64_phase(dev)
    launches_n = integrator_phases(dev)
    launches_p = prb_phase(dev)
    sharded_phase(dev)
    int_s = time.perf_counter() - t_int

    # ---- 16. the reference-compatible surface, the examples ------------------
    t_api = time.perf_counter()
    launches_a = api_phase(dev)
    api_s = time.perf_counter() - t_api
    t_ex = time.perf_counter()
    launches_x2 = examples_phase(dev)
    ex_s = time.perf_counter() - t_ex

    kernels["K1"]["launches_step"] = launches_t["K1"]
    kernels["K1"]["launches_renderD"] = launches_d["K1"]
    kernels["K1"]["launches_texture"] = launches_x["K1"]
    kernels["K1"]["launches_room"] = launches_r["K1"]
    kernels["K6"]["launches_gallery_step"] = launches_g["K6"]
    kernels["K2-pair"]["launches_renderD"] = launches_d["K2-pair"]
    kernels["K5"]["launches_renderD"] = launches_dk5["K5"]
    for k in ("K1", "K2", "K2-pair", "K2-stash", "K3", "K4"):
        kernels[k]["launches_loaded"] = launches_lc[k]
        kernels[k]["launches_intrinsic"] = launches_i[k]
    kernels["K6"]["launches_loaded"] = launches_le["K6"]
    kernels["K1"]["launches_integrators"] = launches_n.get("K1", 0)
    kernels["K1"]["launches_prb"] = launches_p.get("K1", 0)
    kernels["K2-pair"]["launches_prb"] = launches_p.get("K2-pair", 0)
    kernels["K5"]["launches_fields"] = launches_n.get("K5", 0)
    kernels["K6"]["launches_fields"] = launches_n.get("K6", 0)
    for k in kernels:
        if k != "K7":  # K7's launches are summed apart (K7_MAIN_PATHS)
            kernels[k]["launches_api"] = launches_a.get(k, 0)
            kernels[k]["launches_examples"] = launches_x2.get(k, 0)
    later = {k: launches_lc[k] + launches_le[k] + launches_i[k]
             + launches_n.get(k, 0) + launches_p.get(k, 0)
             + launches_a.get(k, 0) + launches_x2.get(k, 0)
             for k in launches_lc}
    record = {"kernels": (
        [{**kernels["K1"], "launches": launches["K1"] + launches_t["K1"]
          + launches_d["K1"] + launches_x["K1"] + launches_r["K1"]
          + later["K1"]},
         {**kernels["K2"], "launches": launches["K2"] + later["K2"]},
         {**kernels["K2-pair"], "launches": launches_t["K2-pair"]
          + launches_d["K2-pair"] + later["K2-pair"]}]
        + [{**kernels[k], "launches": launches_t[k] + later[k]}
           for k in ("K2-stash", "K3", "K4")]
        + [{**kernels["K5"], "launches": launches_l["K5"]
            + launches_dk5["K5"] + later["K5"]},
           {**kernels["K6"], "launches": launches_l["K6"]
            + launches_e["K6"] + launches_g["K6"] + later["K6"]},
           {**kernels["K7"], "launches": K7_MAIN_PATHS["K7"],
            "jvp_launches": K7_MAIN_PATHS["K7-jvp"],
            "vjp_launches": K7_MAIN_PATHS["K7-vjp"]}])}
    log("total", seconds=f"{time.perf_counter() - t_start:.1f}",
        envmap_seconds=f"{env_s:.1f}", texture_seconds=f"{tex_s:.1f}",
        gallery_step_seconds=f"{gal_s:.1f}", room_seconds=f"{room_s:.1f}",
        files_seconds=f"{files_s:.1f}", integrators_seconds=f"{int_s:.1f}",
        api_seconds=f"{api_s:.1f}", examples_seconds=f"{ex_s:.1f}")
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
