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
split at the middle), checks a
32x32 render against ``tests/golden_cbox32.npy``, then drives four main
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
  through K1.

64x64 training steps of the box (sppse 0, sppse 8, and sppse 8 guided by
one table on both sides), a 64x64 renderD of the box (forward and reverse
mode) and of the 1,292-triangle gallery (forward mode) and a 64x64 frame
of the 5,132-triangle gallery run through the kernels and, on the CPU,
through the plain versions, and the two must agree. One training step
and one gallery frame run with every launch recorded, and each launch is
held against its plain version on the inputs it was given; so do K1's
launches in the first chunk of the step's secondary-edge pass. Kernels,
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
                                   None if stash else s.active,
                                   chunk=1 << 15) for s in record)
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
        scene.bsdfs[1].reflectance = p["alb"]
        scene.emitters[0].radiance = p["rad"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"tx": torch.zeros(()), "dv": torch.zeros_like(verts),
              "alb": scene.bsdfs[1].reflectance.clone(),
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


def renderd_tangent(integrator, scene, setup, name, direction,
                    seed: int = SEED, **kwargs):
    """``forward_mode`` along ``direction`` of the ``train_setup``
    parameter ``name`` (``setup`` is ``train_setup(scene)``)."""
    params, apply_params, _ = setup
    return forward_mode(integrator, scene,
                        lambda v: apply_params({**params, name: v}),
                        params[name], direction, seed, **kwargs)


def renderd_grads(integrator, scene, setup, weight, seed: int = SEED):
    """``{name: gradient}`` of ``sum(weight * renderD)`` with respect to
    the ``train_setup`` parameters, in reverse mode."""
    import torch

    params, apply_params, _ = setup
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    apply_params(p)
    try:
        img = integrator.renderD(scene, 0, seed=seed)
        grads = torch.autograd.grad((img * weight).sum(), list(p.values()))
    finally:
        apply_params(params)
    return dict(zip(p, grads))


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


def se_pass_ms(integrator, step, reps: int) -> float:
    """Median span of the step's secondary-edge pass on the card's stream
    (CUDA events around ``render_secondary_edges``) over ``reps`` steps."""
    import torch

    spans = []
    inner = integrator.render_secondary_edges

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    integrator.render_secondary_edges = timed
    try:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    finally:
        del integrator.render_secondary_edges
    return statistics.median(a.elapsed_time(b) for a, b in spans)


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
        launches5 = dict(_cuda.LAUNCHES)
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
        launches = dict(_cuda.LAUNCHES)
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
        launches = dict(_cuda.LAUNCHES)
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
        launches = dict(_cuda.LAUNCHES)
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
        launches_t = dict(_cuda.LAUNCHES)
    k1_step = se_k1_launches(n_pix, SPPSE)
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
    se_ms = se_pass_ms(integrator, step, 3)
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

    kernels["K1"]["launches_step"] = launches_t["K1"]
    kernels["K1"]["launches_renderD"] = launches_d["K1"]
    kernels["K2-pair"]["launches_renderD"] = launches_d["K2-pair"]
    kernels["K5"]["launches_renderD"] = launches_dk5["K5"]
    record = {"kernels": (
        [{**kernels["K1"], "launches": launches["K1"] + launches_t["K1"]
          + launches_d["K1"]},
         {**kernels["K2"], "launches": launches["K2"]},
         {**kernels["K2-pair"], "launches": launches_t["K2-pair"]
          + launches_d["K2-pair"]}]
        + [{**kernels[k], "launches": launches_t[k]}
           for k in ("K2-stash", "K3", "K4")]
        + [{**kernels["K5"], "launches": launches_l["K5"]
            + launches_dk5["K5"]},
           {**kernels["K6"], "launches": launches_l["K6"]}])}
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
