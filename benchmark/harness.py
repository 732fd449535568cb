"""One run of one cell: set-up, the measured window, with ``--trace 1``
the spans and profiles of the per-layer metrics, then the check against
the reference. Everything that belongs to a configuration, a mix or a
metric is read from its file by the name ``BENCHMARK.json`` gives."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

import check
import tracing
from scenes import load_config, rays_per_iteration
from workload import load_mix, make_loop

BENCH_DIR = Path(__file__).resolve().parent
METRICS_DIR = BENCH_DIR / "metrics"
# top-level module names no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "psdr_jit_tpu")
PROGRAM = "psdr_jit_tpu_torch"
# a traced run profiles whole iterations for about this long (at least
# one, at most MAX_PROFILED)
PROFILE_SECONDS = 1.0
MAX_PROFILED = 20


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_reader(name: str):
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def p95(values) -> float:
    return statistics.quantiles(values, n=100)[94]


def phase(name: str, t0: float):
    print(f"[setup] {name} at {time.time() - t0:.2f} s", file=sys.stderr)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(loop, first: int, seconds: float, keep: int, seed: int,
               device):
    """Iterations from ``first`` until ``seconds`` have passed on the host
    clock: ``(times, window_s, failed, answers)``; ``answers`` holds
    ``keep`` iterations' answers drawn uniformly from the seed (reservoir
    sampling)."""
    rng = random.Random(seed)
    slots = []
    times, failed = [], 0
    i = first
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        value = loop.step(i)
        now = time.perf_counter()
        times.append(now - t)
        if not math.isfinite(value):
            failed += 1
        n = i - first
        if keep:
            if n < keep:
                slots.append((i, loop.answer()))
            else:
                j = rng.randrange(n + 1)
                if j < keep:
                    slots[j] = (i, loop.answer())
        i += 1
        if now - start >= seconds:
            break
    _sync(device)
    return times, time.perf_counter() - start, failed, dict(slots)


def traced_metrics(loop, next_i, iter_s, sites, device):
    """The profiles of a traced run: ``(trace fields, breakdown)``."""
    n = max(1, min(MAX_PROFILED, round(PROFILE_SECONDS / max(iter_s, 1e-6))))
    state = {"i": next_i}

    def run():
        for _ in range(n):
            loop.step(state["i"])
            state["i"] += 1

    dev_events, window = tracing.profile(run, with_host=False, device=device)
    busy = tracing.busy_seconds(dev_events)
    with tracing.Spans(sites, device, annotate=True):
        host_events, _ = tracing.profile(run, with_host=True, device=device)
    kernels, ops = tracing.kernels_and_ops(host_events)
    bd = tracing.breakdown(host_events)
    bd["device_ops"] = tracing.breakdown(dev_events)["device_ops"]
    return {"kernels": kernels, "ops": ops, "busy_s": busy,
            "window_s": window}, bd


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0=None, size=None, spp=None,
             program=None, reference=None) -> dict:
    """The result of one run (the line ``run.py`` prints). ``size``,
    ``spp``, ``program`` and ``reference`` are for the CPU tests: a
    smaller frame, fewer samples, and stand-in packages."""
    t0 = time.time() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cell = cell_of(spec, workload)
    config = load_config(cell["config"])
    mix = load_mix(cell["traffic"])
    pkg = program or importlib.import_module(PROGRAM)
    phase("program imported", t0)
    if cuda:
        kernels = importlib.import_module(f"{PROGRAM}.ops._cuda")
        kernels.build()
        torch.zeros(1, device=device)
        phase("kernels built or found, device ready", t0)
        kernels.library()
        phase("kernel library loaded", t0)

    loop = make_loop(pkg, config, mix, seed, device, size=size, spp=spp)
    _sync(device)
    phase("scene and target", t0)
    first = loop.warmup_iterations()
    for i in range(first):
        loop.step(i)
    _sync(device)
    phase(f"{first} warm iterations", t0)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t0

    readers = {}
    if trace:
        for m in spec["per_layer"]:
            if applies(m, workload):
                readers[m["name"]] = load_reader(m["name"])
    sites = [s for r in readers.values() for s in getattr(r, "SITES", ())]
    keep = int(mix.get("checked_answers", 0))
    spans = tracing.Spans(sites, device) if trace else contextlib.nullcontext()
    with spans:
        times, window_s, failed, answers = run_window(
            loop, first, seconds, keep, seed, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    n_done = len(times)
    rays = rays_per_iteration(config, mix, loop.n_pix, loop.counts) * n_done
    values = {"mrays_per_s": rays / window_s / 1e6,
              "iter_ms_p95": p95(times) * 1e3 if n_done >= 2 else None,
              "peak_gb": window_peak / 1e9, "setup_s": setup_s}
    metrics, breakdown = {}, None
    if not trace:
        for m in spec["end_to_end"]:
            if applies(m, workload) and values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        fields = {"iterations": n_done,
                  "spans_ms": spans.totals_ms()}
        if cuda:
            prof, breakdown = traced_metrics(
                loop, first + n_done, statistics.median(times), sites,
                device)
            fields.update(prof)
        t = tracing.Trace(**fields)
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
        for name, reader in readers.items():
            v = reader.read(t)
            if v is None:
                print(f"[metric] {name}: nothing to read in this run",
                      file=sys.stderr)
                continue
            metrics[name] = {"value": v, "unit": units[name]}

    record = loop.record if hasattr(loop, "record") else None
    del loop
    check.free_device_memory()

    ref_pkg = reference or importlib.import_module("reference")
    ref_loop = make_loop(ref_pkg, config, mix, seed, device, size=size,
                         spp=spp)
    numbers = check.compare(record, answers,
                            *check.reference_outputs(ref_loop, record,
                                                     answers))
    correct, checks = check.judge(numbers, check.load_limits(workload))
    correct = correct and n_done > 0 and failed == 0

    dev = {"platform": "gpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if trace and cuda:
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
    result = {"correct": correct, "attempted": n_done, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
