#!/usr/bin/env python3
"""Where the time of psdr_jit_tpu_torch's renderC, or of its training
step, goes on a CUDA card.

    python3 scripts/torch_profile_render.py           # renderC
    python3 scripts/torch_profile_render.py --train   # loss_and_grad
    python3 scripts/torch_profile_render.py --large   # the gallery
    python3 scripts/torch_profile_render.py --renderD # renderD

from the repository root. Both use the Cornell box of
``tests/data/cbox_scene.npz`` (512x512, spp 32) with ``PathTracer(3)``;
the training step adds sppe 32, sppse 32 and the parameters of
``chip_smoke.py``.

renderC: the card (``nvidia-smi`` name, power limit, SM clocks), the
frame's host time over 10 runs, the device's busy time per frame from
``torch.profiler`` with the kernels by device time, and the frame split
into its stages by CUDA events.

--train: the step's host time and peak device memory at each training
chunk size (2^20..2^23 lanes) and at each secondary-edge chunk size
(2^21..2^23 lanes); the secondary-edge pass's span on the card's stream
and K1's own time a step (each recorded launch timed alone); the device's busy
time per step with the kernels by device time; and the step split into
its parts: each part is timed on the host between two synchronizes, so
the parts add up to a step slower than an unsplit one.

--large: renderC of the 102,412-triangle gallery (``chip_smoke``
``gallery_arrays``, 256x256, spp 4, ``PathTracer(2)``, the general Li
through K6): the frame's host time over 10 runs, the device's busy time
per frame with the kernels by device time and K6's share of it; K6 a
frame with leaves of 2, 4, 6 and 8 triangles, and on K5's tree split by
surface area (``bvh.build_sah_bvh``, leaves of at most 2 and 4) with the
time to build each tree; the frame at 512x512 spp 8 at each
general-path chunk size (2^18..2^21 lanes) with its peak device memory;
and, on the 1,292-triangle gallery, K5 against K6 on the same 262,144
rays and in the whole frame.

--renderD: renderD of the box (512x512, spp 32, sppe 32, sppse 32,
``PathTracer(3)``) in forward mode (along the light's translation) and
in reverse mode (``torch.autograd.grad`` of ``sum(w * renderD)`` for the
four parameters of ``chip_smoke.train_setup``): host time and peak
device memory of each at each interior chunk size (``DIFF_CHUNK_LANES``,
2^20..2^23 lanes); K1's launches and device time in the reverse render's
forward sweep and in its backward sweep (which launches the checkpointed
chunks' K1 and K2 pair again), beside the bytes that saving the interior's
hit payloads across the checkpoints would hold; the device's busy time
per render of each mode with the kernels by device time; and whether
``torch.func.jvp`` runs the forward mode in place of
``torch.autograd.forward_ad``.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import psdr_jit_tpu_torch as pt  # noqa: E402
from psdr_jit_tpu_torch.core.math import scrub_nonfinite  # noqa: E402
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup  # noqa: E402
from psdr_jit_tpu_torch.ops import megakernel as mk  # noqa: E402
from psdr_jit_tpu_torch.ops.image import interior_average  # noqa: E402

DEPTH = 3
STAGES = ("lane set-up and first draw", "primary rays",
          "tables and ray packing", "K2", "scrub and average")


def busy_ms(fn, reps: int, rows: int = 15) -> float:
    """Device busy time per call of ``fn`` from ``torch.profiler``, with
    the kernel table printed."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=rows, max_name_column_width=60))
    return busy


def host_ms(fn, reps: int):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def train(dev) -> int:
    from chip_smoke import (SPPE, SPPSE, KernelCalls, cuda_ms, se_pass_ms,
                            train_step_fn)
    from psdr_jit_tpu_torch.integrator import base, fused
    from psdr_jit_tpu_torch.ops import image
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    sc = pt.Scene.from_arrays(np.load(ROOT / "tests/data/cbox_scene.npz"),
                              device=dev)
    sc.opts.sppe, sc.opts.sppse = SPPE, SPPSE
    integ = pt.PathTracer(DEPTH)
    step = train_step_fn(integ, sc)
    print(f"loss_and_grad {sc.opts.width}x{sc.opts.height} spp "
          f"{sc.opts.spp} sppe {SPPE} sppse {SPPSE} depth {DEPTH}")

    def sweep(owner, name, sizes, what):
        default = getattr(owner, name)
        for lanes in sizes:
            setattr(owner, name, lanes)
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            med, lo, hi = host_ms(step, 5)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            print(f"{what} chunk 2^{lanes.bit_length() - 1} lanes: step "
                  f"host ms median {med:.3f} min {lo:.3f} max {hi:.3f}, "
                  f"peak {peak:.3f} GB")
        setattr(owner, name, default)

    sweep(base, "TRAIN_CHUNK_LANES", (1 << 20, 1 << 21, 1 << 22, 1 << 23),
          "interior and primary-edge")
    sweep(base, "SE_CHUNK_LANES", (1 << 21, 1 << 22, 1 << 23),
          "secondary-edge")

    span = se_pass_ms(integ, step, 3)
    with KernelCalls({"K1": (ix, "sweep_cuda")}) as rec:
        step()
        torch.cuda.synchronize()
    k1 = sum(cuda_ms(lambda: fn(*args), 3)
             for fn, args, _ in rec.calls["K1"])
    print(f"secondary-edge pass span {span:.3f} ms; K1 "
          f"{len(rec.calls['K1'])} launches {k1:.4f} ms a step")

    med, lo, hi = host_ms(step, 10)
    print(f"default chunks (2^{base.TRAIN_CHUNK_LANES.bit_length() - 1}, "
          f"2^{base.SE_CHUNK_LANES.bit_length() - 1} lanes): step host ms "
          f"median {med:.3f} min {lo:.3f} max {hi:.3f}")
    busy = busy_ms(step, 3, rows=25)
    print(f"device busy per step (profiler, sum of kernel time): "
          f"{busy:.3f} ms, idle share {1 - busy / med:.3f} of the median")

    parts = {}

    def timed(owner, name, label):
        fn = getattr(owner, name)
        wrapped = fn.__func__ if isinstance(fn, staticmethod) else fn

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wrapped(*args, **kwargs)
            torch.cuda.synchronize()
            parts[label] = parts.get(label, 0.0) + (
                time.perf_counter() - t0) * 1e3
            return out

        setattr(owner, name, wrap_static(owner, name, wrapper))
        return fn

    def wrap_static(owner, name, fn):
        # an autograd.Function's backward is a staticmethod
        return staticmethod(fn) if name == "backward" else fn

    sites = [(pt.Scene, "configure_data", "scene compile"),
             (fused, "_interior_scan", "interior pass"),
             (mk, "li_mega_stash", "K2 stash"),
             (sm, "attached_tables", "attached tables"),
             (sm, "shade_cuda", "K3"),
             (sm, "shade_adjoint_cuda", "K4"),
             (base.Integrator, "_render_primary_edges", "primary-edge pass"),
             (mk, "li_mega_pair", "K2 pair"),
             (base.Integrator, "render_secondary_edges",
              "secondary-edge pass"),
             (ix, "sweep_cuda", "K1"),
             (image._SplatDerivativeOnly, "backward", "splat gather")]
    saved = [timed(*site) for site in sites]
    reps = 5
    step()
    parts.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3 / reps
    for (owner, name, _), fn in zip(sites, saved):
        setattr(owner, name, wrap_static(owner, name, fn))
    split = {k: v / reps for k, v in parts.items()}
    inner = {"interior pass": (("K2 stash", "attached tables", "K3", "K4"),
                               "lane set-up, camera rays, loss, PyTorch "
                               "backward of the rays"),
             "primary-edge pass": (("K2 pair",),
                                   "edge sampling, edge rays, splat "
                                   "gather, PyTorch backward of the "
                                   "endpoints"),
             "secondary-edge pass": (("K1",),
                                     "boundary sampling, the "
                                     "re-intersections, splat gather, "
                                     "PyTorch backward")}
    print(f"split step (synchronized parts), host ms per step: {total:.3f}")
    for label in ("scene compile", "interior pass", "K2 stash",
                  "attached tables", "K3", "K4", "primary-edge pass",
                  "K2 pair", "secondary-edge pass", "K1",
                  "splat gather (both edge passes)"):
        print(f"  {label}: {split.get(label.split(' (')[0], 0.0):.3f}")
    for outer, (names, what) in inner.items():
        rest = split.get(outer, 0.0) - sum(split.get(n, 0.0) for n in names)
        print(f"  {outer}, the rest ({what}): {rest:.3f}")
    rest = total - sum(split.get(k, 0.0) for k in
                       ("scene compile", "interior pass", "primary-edge pass",
                        "secondary-edge pass"))
    print(f"  leaves and the backward through the scene compile: {rest:.3f}")
    return 0


def renderd(dev) -> int:
    from chip_smoke import (SPPE, SPPSE, KernelCalls, cuda_ms, renderd_grads,
                            renderd_tangent, renderd_weight, train_setup)
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import megakernel as mk_

    sc = pt.Scene.from_arrays(np.load(ROOT / "tests/data/cbox_scene.npz"),
                              device=dev)
    sc.opts.sppe, sc.opts.sppse = SPPE, SPPSE
    sc.configure()
    w_, h_, spp = sc.opts.width, sc.opts.height, sc.opts.spp
    integ = pt.PathTracer(DEPTH)
    setup = train_setup(sc)
    w = renderd_weight(w_ * h_, dev)
    print(f"renderD {w_}x{h_} spp {spp} sppe {SPPE} sppse {SPPSE} depth "
          f"{DEPTH}")

    def fwd():
        return renderd_tangent(integ, sc, setup, "tx", 1.0)

    def rev():
        return renderd_grads(integ, sc, setup, w)

    default = base.DIFF_CHUNK_LANES
    for lanes in (1 << 20, 1 << 21, 1 << 22, 1 << 23):
        base.DIFF_CHUNK_LANES = lanes
        for name, fn in (("forward", fwd), ("reverse", rev)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            med, lo, hi = host_ms(fn, 3)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            print(f"interior chunk 2^{lanes.bit_length() - 1} lanes: "
                  f"{name} host ms median {med:.3f} min {lo:.3f} max "
                  f"{hi:.3f}, peak {peak:.3f} GB")
    base.DIFF_CHUNK_LANES = default

    # K1 (and K2 pair) in the reverse render's two sweeps
    params, apply_params, _ = setup
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    apply_params(p)
    sites = {"K1": (ix, "sweep_cuda"), "K2-pair": (mk_, "li_mega_pair_cuda")}
    with KernelCalls(sites) as fwd_calls:
        img = integ.renderD(sc, 0, seed=0)
        torch.cuda.synchronize()
    with KernelCalls(sites) as bwd_calls:
        torch.autograd.grad((img * w).sum(), list(p.values()))
        torch.cuda.synchronize()
    apply_params(params)
    del img
    n_int = -(-w_ * h_ // max(base.DIFF_CHUNK_LANES // spp, 1))
    for sweep, rec in (("forward sweep", fwd_calls), ("backward sweep",
                                                      bwd_calls)):
        for k, calls in rec.calls.items():
            ms = sum(cuda_ms(lambda: fn(*args), 3) for fn, args, _ in calls)
            print(f"reverse render, {sweep}: {k} {len(calls)} launches "
                  f"{ms:.4f} ms")
    # the forward sweep launches the interior's chunks first; the backward
    # sweep launches the same K1 calls again when it recomputes them
    interior = fwd_calls.calls["K1"][:n_int * (1 + 2 * DEPTH)]
    ms_int = sum(cuda_ms(lambda: fn(*args), 3) for fn, args, _ in interior)
    print(f"re-launching the interior's K1 in the backward sweep: "
          f"{len(interior)} launches {ms_int:.4f} ms a render")
    lanes = w_ * h_ * spp
    saved = lanes * (1 + 2 * DEPTH) * 16
    print(f"saving the interior's hit payloads instead (tri id, valid, u, "
          f"v: 16 B a lane an intersection): {lanes} lanes x "
          f"{1 + 2 * DEPTH} = {saved / 1e9:.3f} GB held to the backward")

    for name, fn in (("forward", fwd), ("reverse", rev)):
        med, lo, hi = host_ms(fn, 3)
        busy = busy_ms(fn, 2, rows=20)
        print(f"{name} host ms median {med:.3f}; device busy per render "
              f"(profiler) {busy:.3f} ms, idle share {1 - busy / med:.3f}")

    # torch.func.jvp in place of torch.autograd.forward_ad
    def render_tx(tx):
        apply_params({**params, "tx": tx})
        return integ.renderD(sc, 0, seed=0)

    try:
        _, tan = torch.func.jvp(render_tx, (torch.zeros(()),),
                                (torch.ones(()),))
        ref = fwd()[1]
        print(f"torch.func.jvp runs: rel L1 against forward_ad "
              f"{float((tan - ref).abs().sum() / ref.abs().sum()):.3e}")
    except Exception as exc:  # the outcome is what this line reports
        print(f"torch.func.jvp fails: {type(exc).__name__}: {exc}"[:400])
    finally:
        apply_params(params)
    return 0


def large(dev) -> int:
    from chip_smoke import (CHECK_RAYS, LARGE, LARGE_DEPTH, WIDE, KernelCalls,
                            cuda_ms, gallery_arrays, mixed_rays)
    from psdr_jit_tpu_torch.integrator import base
    from psdr_jit_tpu_torch.ops import bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    integ = pt.PathTracer(LARGE_DEPTH)
    sc = pt.Scene.from_arrays(gallery_arrays(*LARGE), device=dev)
    sd = sc.configure()
    print(f"gallery {sd.tri.p0.shape[0]} triangles, renderC {LARGE[0]}x"
          f"{LARGE[1]} spp {LARGE[2]} depth {LARGE_DEPTH}, chunk "
          f"2^{base.GENERAL_CHUNK_LANES.bit_length() - 1} lanes")

    def frame():
        return integ.renderC(sc, 0, seed=0)

    med, lo, hi = host_ms(frame, 10)
    print(f"frame host ms median {med:.3f} min {lo:.3f} max {hi:.3f}")
    frames = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / frames / 1e3
    walk = [e for e in kernels
            if "walk_kernel" in e.name or "pack_kernel" in e.name]
    k6 = sum(e.self_device_time_total for e in walk) / frames / 1e3
    n_kernels = (len(kernels) - len(walk)) / frames
    print(f"device busy per frame (profiler): {busy:.3f} ms, idle share "
          f"{1 - busy / med:.3f} of the median; K6 {k6:.3f} ms, the rest "
          f"(PyTorch kernels of the general Li and the lane set-up) "
          f"{busy - k6:.3f} ms in {n_kernels:.0f} launches")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))

    # K6 at other leaf sizes, and on K5's surface-area tree (built on the
    # host: its build time is printed): each launch of one frame, re-run
    # on that tree (the same hits)
    with KernelCalls({"K6": (bvh, "walk_cuda")}) as rec:
        frame()
        torch.cuda.synchronize()
    trees = {f"leaves of {leaf}": lambda leaf=leaf: bvh.build_bvh(
        sd.tri.p0, sd.tri.e1, sd.tri.e2, leaf) for leaf in (2, 4, 6, 8)}
    trees.update({f"a surface-area tree, leaves of at most {leaf}": (
        lambda leaf=leaf: bvh.build_sah_bvh(sd.tri.p0, sd.tri.e1, sd.tri.e2,
                                            leaf)) for leaf in (2, 4)})
    for name, build in trees.items():
        t0 = time.perf_counter()
        tree = build()
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        ms = tests = rays = 0
        for _, (_, o, d, act), _ in rec.calls["K6"]:
            ms += cuda_ms(lambda: bvh.walk_cuda(tree, o, d, act), 10)
            counts = torch.zeros((o.shape[0], 2), dtype=torch.int32,
                                 device=dev)
            bvh.walk_cuda(tree, o, d, act, counts)
            tests += int(counts[:, 0].sum())
            rays += o.shape[0]
        print(f"K6 on {name}: {ms:.4f} ms a frame, built in "
              f"{build_ms:.1f} ms, tree depth "
              f"{tree.depth}, {tests / rays:.1f} tests a ray")

    wide = pt.Scene.from_arrays(gallery_arrays(*WIDE), device=dev)
    wide.configure()
    default = base.GENERAL_CHUNK_LANES
    for lanes in (1 << 18, 1 << 19, 1 << 20, 1 << 21):
        base.GENERAL_CHUNK_LANES = lanes
        integ.renderC(wide, 0, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        med, lo, hi = host_ms(lambda: integ.renderC(wide, 0, seed=0), 3)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{WIDE[0]}x{WIDE[1]} spp {WIDE[2]}, chunk "
              f"2^{lanes.bit_length() - 1} lanes: host ms median {med:.3f} "
              f"min {lo:.3f} max {hi:.3f}, peak {peak:.3f} GB")
    base.GENERAL_CHUNK_LANES = default

    mid = pt.Scene.from_arrays(gallery_arrays(*LARGE, 4, 2), device=dev)
    sdm = mid.configure()
    gen = torch.Generator(device=dev).manual_seed(7)
    o, d, act = mixed_rays(sdm, CHECK_RAYS, gen, dev)
    tri = sdm.tri
    h = bvh.build_bvh(tri.p0, tri.e1, tri.e2)
    k5_walk = functools.partial(bvh.walk_cuda, kernel="K5")
    k5_ms = cuda_ms(lambda: k5_walk(sdm.bvh, o, d, act), 20)
    k6_ms = cuda_ms(lambda: bvh.walk_cuda(h, o, d, act), 20)
    same = all(torch.equal(a, b) for a, b in zip(
        k5_walk(sdm.bvh, o, d, act), bvh.walk_cuda(h, o, d, act)))
    print(f"{tri.p0.shape[0]} triangles, {o.shape[0]} mixed rays: K5 "
          f"{k5_ms:.4f} ms, K6 {k6_ms:.4f} ms, equal hits {same}")
    def device_ms(name):
        """The walk's device ms summed over one frame's launches (as
        ``name``), each timed alone on its recorded inputs."""
        with KernelCalls({name: (bvh, "walk_cuda")}) as rec:
            integ.renderC(mid, 0, seed=0)
            torch.cuda.synchronize()
        return sum(cuda_ms(lambda: fn(*args), 10)
                   for fn, args, _ in rec.calls[name])

    k5_frame = host_ms(lambda: integ.renderC(mid, 0, seed=0), 5)[0]
    k5_dev = device_ms("K5")
    limit = ix.K5_MAX_TRIS
    ix.K5_MAX_TRIS = ix.K1_MAX_TRIS  # route the same scene to K6 and its tree
    try:
        mid.configure()
        k6_frame = host_ms(lambda: integ.renderC(mid, 0, seed=0), 5)[0]
        k6_dev = device_ms("K6")
    finally:
        ix.K5_MAX_TRIS = limit
        mid.configure()
    print(f"renderC of it at {LARGE[0]}x{LARGE[1]} spp {LARGE[2]}: through "
          f"K5 {k5_frame:.3f} ms, through K6 {k6_frame:.3f} ms (host "
          f"medians); the kernel alone a frame: K5 {k5_dev:.4f} ms, K6 "
          f"{k6_dev:.4f} ms")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda:0")
    if "--train" in sys.argv[1:]:
        return train(dev)
    if "--large" in sys.argv[1:]:
        return large(dev)
    if "--renderD" in sys.argv[1:]:
        return renderd(dev)
    sc = pt.Scene.from_arrays(np.load(ROOT / "tests/data/cbox_scene.npz"),
                              device=dev)
    sd = sc.configure()
    w, h, spp = sc.opts.width, sc.opts.height, sc.opts.spp
    integ = pt.PathTracer(DEPTH)
    for _ in range(3):
        integ.renderC(sc, 0, seed=0)
    torch.cuda.synchronize()

    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        integ.renderC(sc, 0, seed=0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"renderC {w}x{h} spp {spp} depth {DEPTH}: host ms median "
          f"{statistics.median(walls):.3f} min {min(walls):.3f} "
          f"max {max(walls):.3f}")

    frames = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            integ.renderC(sc, 0, seed=0)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == DeviceType.CUDA) / frames / 1e3
    print(f"device busy per frame (profiler, sum of kernel time): "
          f"{busy_ms:.3f} ms")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))

    times = {name: [] for name in STAGES}
    pix = torch.arange(w * h, device=dev)
    for rep in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        m, sampler, samples = interior_lane_setup(w, h, spp, 0, pix)
        ev[1].record()
        ray = sd.sensors[0].sample_primary_ray(samples)
        ev[2].record()
        tables = mk.build_tables(sd)
        act = torch.ones(m * spp, dtype=torch.bool, device=dev)
        o, d = ray.o.contiguous(), ray.d.contiguous()
        ev[3].record()
        li = mk.li_mega(*tables, o, d, act, sampler.lane, sampler.seed_value,
                        depth=DEPTH, cnt0=sampler.cnt)
        ev[4].record()
        interior_average(scrub_nonfinite(li), m, spp)
        ev[5].record()
        torch.cuda.synchronize()
        if rep:  # the first is a warm-up
            for k, name in enumerate(STAGES):
                times[name].append(ev[k].elapsed_time(ev[k + 1]))
    for name, v in times.items():
        print(f"stage {name}: median {statistics.median(v):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
