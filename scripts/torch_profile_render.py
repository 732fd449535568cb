#!/usr/bin/env python3
"""Where the time of psdr_jit_tpu_torch's renderC, or of its training
step, goes on a CUDA card.

    python3 scripts/torch_profile_render.py           # renderC
    python3 scripts/torch_profile_render.py --train   # loss_and_grad

from the repository root. Both use the Cornell box of
``tests/data/cbox_scene.npz`` (512x512, spp 32) with ``PathTracer(3)``;
the training step adds sppe 32 and the parameters of ``chip_smoke.py``.

renderC: the card (``nvidia-smi`` name, power limit, SM clocks), the
frame's host time over 10 runs, the device's busy time per frame from
``torch.profiler`` with the kernels by device time, and the frame split
into its stages by CUDA events.

--train: the step's host time and peak device memory at each training
chunk size (2^20..2^23 lanes), the device's busy time per step with the
kernels by device time, and the step split into its parts: each part is
timed on the host between two synchronizes, so the parts add up to a
step slower than an unsplit one.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

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
    from chip_smoke import SPPE, train_step_fn
    from psdr_jit_tpu_torch.integrator import base, fused
    from psdr_jit_tpu_torch.ops import image
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    sc = pt.Scene.from_arrays(np.load(ROOT / "tests/data/cbox_scene.npz"),
                              device=dev)
    sc.opts.sppe = SPPE
    step = train_step_fn(pt.PathTracer(DEPTH), sc)
    print(f"loss_and_grad {sc.opts.width}x{sc.opts.height} spp "
          f"{sc.opts.spp} sppe {SPPE} depth {DEPTH}")
    default = base.TRAIN_CHUNK_LANES
    for lanes in (1 << 20, 1 << 21, 1 << 22, 1 << 23):
        base.TRAIN_CHUNK_LANES = lanes
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        med, lo, hi = host_ms(step, 5)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"chunk 2^{lanes.bit_length() - 1} lanes: step host ms median "
              f"{med:.3f} min {lo:.3f} max {hi:.3f}, peak {peak:.3f} GB")
    base.TRAIN_CHUNK_LANES = default
    med, lo, hi = host_ms(step, 10)
    print(f"default chunks (2^{default.bit_length() - 1} lanes): step host "
          f"ms median {med:.3f} "
          f"min {lo:.3f} max {hi:.3f}")
    busy = busy_ms(step, 3)
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
             (fused, "_edge_pullbacks", "primary-edge pass"),
             (mk, "li_mega_pair", "K2 pair"),
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
             "primary-edge pass": (("K2 pair", "splat gather"),
                                   "edge sampling, edge rays, PyTorch "
                                   "backward of the endpoints")}
    print(f"split step (synchronized parts), host ms per step: {total:.3f}")
    for label in ("scene compile", "interior pass", "K2 stash",
                  "attached tables", "K3", "K4", "primary-edge pass",
                  "K2 pair", "splat gather"):
        print(f"  {label}: {split.get(label, 0.0):.3f}")
    for outer, (names, what) in inner.items():
        rest = split.get(outer, 0.0) - sum(split.get(n, 0.0) for n in names)
        print(f"  {outer}, the rest ({what}): {rest:.3f}")
    rest = total - sum(split.get(k, 0.0) for k in
                       ("scene compile", "interior pass", "primary-edge pass"))
    print(f"  leaves and the backward through the scene compile: {rest:.3f}")
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
