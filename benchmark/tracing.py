"""What a traced run (``--trace 1``) records, from the benchmark's own
files: spans around the program's calls into its layers, and the
profiler's device trace.

- **Spans.** Each per-layer reader (``metrics/<name>.py``) may name the
  sites it needs in ``SITES``: ``(module, attribute path, span, kind)``.
  The harness wraps each site while the window runs and records a span
  around every call (``kind`` "call") or around every call of the
  function the site returns (``kind`` "returns_fn": the per-chunk value
  functions of the edge passes). On the card a span is a pair of CUDA
  events on the current stream, on the CPU two host clock readings. A
  span inside an open span of the same name is not recorded again. A
  site that no longer exists is reported on standard error and its span
  stays empty, so its metric is left out.
- **Profiles.** ``profile`` runs a few whole iterations under
  ``torch.profiler``: with device activity only (busy time, idle share)
  or with host activity and ``record_shapes`` too (each kernel operator's
  inputs, for the rooflines, and the host op during each idle gap).
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import re
import sys
import time
from collections import defaultdict

import torch


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read. ``iterations``: the iterations of
    the spans' window; ``spans_ms``: each span's summed time over it;
    ``kernels``: ``(name, seconds)`` of every device kernel of the shapes
    profile, ``ops``: ``(name, shapes, dtypes, concrete inputs)`` of every
    host operator there; ``busy_s`` and ``window_s`` of the device-only
    profile (None where it did not run)."""

    iterations: int = 0
    spans_ms: dict = dataclasses.field(default_factory=dict)
    kernels: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)
    busy_s: float | None = None
    window_s: float | None = None


def span_mean_ms(trace: Trace, span: str):
    """A span's mean ms per iteration of the spans' window, or None."""
    ms = trace.spans_ms.get(span)
    return None if ms is None or not trace.iterations else ms / trace.iterations


def _resolve(module: str, path: str):
    """``(owner, name)`` of ``module``'s attribute ``path`` ("A.b"), or
    None where any part is missing."""
    try:
        owner = importlib.import_module(module)
    except ImportError:
        return None
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    if not hasattr(owner, name):
        return None
    return owner, name


class Spans:
    """Wraps the sites while the ``with`` block runs; ``annotate`` also
    opens a ``torch.profiler.record_function`` range of the span's name
    (for a profiled window)."""

    def __init__(self, sites, device, annotate: bool = False):
        self.sites = list(sites)
        self.cuda = torch.device(device).type == "cuda"
        self.annotate = annotate
        self.marks = defaultdict(list)
        self.open = defaultdict(int)
        self.missing = set()
        self._saved = []

    def _span(self, name, fn, *args, **kwargs):
        if self.open[name]:
            return fn(*args, **kwargs)
        self.open[name] += 1
        try:
            ctx = (torch.profiler.record_function(name) if self.annotate
                   else None)
            if ctx is not None:
                ctx.__enter__()
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                self.marks[name].append((start, end))
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.marks[name].append((t0, time.perf_counter()))
            if ctx is not None:
                ctx.__exit__(None, None, None)
            return out
        finally:
            self.open[name] -= 1

    def _wrapper(self, orig, span, kind):
        spans = self

        if kind == "call":
            def wrapper(*args, **kwargs):
                return spans._span(span, orig, *args, **kwargs)
        elif kind == "returns_fn":
            def wrapper(*args, **kwargs):
                fn = orig(*args, **kwargs)
                if fn is None:
                    return None
                return lambda *a, **k: spans._span(span, fn, *a, **k)
        else:
            raise ValueError(f"unknown site kind {kind!r}")
        return wrapper

    def __enter__(self):
        for module, path, span, kind in self.sites:
            found = _resolve(module, path)
            if found is None:
                print(f"[trace] site missing: {module}:{path} (span {span})",
                      file=sys.stderr)
                self.missing.add(span)
                continue
            owner, name = found
            own = name in vars(owner)
            orig = getattr(owner, name)
            self._saved.append((owner, name, own, vars(owner).get(name)))
            setattr(owner, name, self._wrapper(orig, span, kind))
        return self

    def __exit__(self, *exc):
        for owner, name, own, value in reversed(self._saved):
            if own:
                setattr(owner, name, value)
            else:
                delattr(owner, name)
        self._saved.clear()
        return False

    def totals_ms(self) -> dict:
        """Each span's summed time in ms (spans whose site is missing, or
        that never opened, are absent)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, marks in self.marks.items():
            if name in self.missing or not marks:
                continue
            if self.cuda:
                out[name] = sum(a.elapsed_time(b) for a, b in marks)
            else:
                out[name] = sum(b - a for a, b in marks) * 1e3
        return out


def _raw_events(prof):
    """The profiler's events as ``(name, is_device, device_index, start_ns,
    end_ns, shapes, dtypes, concrete, annotation)`` tuples."""
    out = []
    events = prof.profiler.kineto_results.events()
    for e in events:
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns()
        end = start + e.duration_ns()
        if dev:
            out.append((e.name(), True, e.device_index(), start, end,
                        None, None, None, False))
            continue
        try:
            shapes, dtypes = e.shapes(), e.dtypes()
            concrete = e.concrete_inputs()
        except (AttributeError, RuntimeError):
            shapes = dtypes = concrete = None
        out.append((e.name(), False, -1, start, end, shapes, dtypes,
                    concrete, bool(e.is_user_annotation())))
    return out


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, cut to ``limit`` characters."""
    n = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip() or name
    return s[:limit]


def profile(run, with_host: bool, device="cuda"):
    """Profile ``run()`` (whole iterations, ended by a synchronise).
    Returns ``(events, window_s)``: ``_raw_events`` of the trace and the
    host clock's length of the window."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA]
    if with_host:
        acts.append(ProfilerActivity.CPU)
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts,
                                record_shapes=with_host) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    return _raw_events(prof), window


def busy_seconds(events) -> float:
    """Seconds in which some device operation ran, averaged over the
    devices that ran any."""
    per = defaultdict(list)
    for name, dev, idx, s, e, *_ in events:
        if dev:
            per[idx].append((s, e))
    if not per:
        return 0.0
    return sum(sum(e - s for s, e in _union(iv)) for iv in per.values()) \
        / len(per) / 1e9


def kernels_and_ops(events):
    """``(kernels, ops)`` for the Trace: ``(name, seconds)`` of each device
    operation, ``(name, shapes, dtypes, concrete)`` of each host op."""
    kernels = [(n, (e - s) / 1e9) for n, dev, _, s, e, *_ in events if dev]
    ops = [(ev[0], ev[5], ev[6], ev[7]) for ev in events if not ev[1]]
    return kernels, ops


def breakdown(events, top: int = 10) -> dict:
    """``device_ops``: the ``top`` device operations by summed seconds;
    ``idle_gaps``: the device's idle gaps between its first and last
    operation, summed by what the host was doing at each gap's start (the
    innermost host op open then, under the innermost span it lies in),
    the ``top`` largest."""
    by_name = defaultdict(float)
    dev_iv = []
    host = []
    spans = []
    for name, dev, _, s, e, _, _, _, ann in events:
        if dev:
            by_name[short_name(name)] += (e - s) / 1e9
            dev_iv.append((s, e))
        elif ann:
            spans.append((s, e, name))
        elif not name.startswith(("cuda", "cu", "Memcpy", "Memset")):
            host.append((s, e, name))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    merged = _union(dev_iv)
    host.sort()
    spans.sort()
    starts = [h[0] for h in host]
    span_starts = [s[0] for s in spans]

    def innermost(items, keys, t, limit=4096):
        i = bisect.bisect_right(keys, t) - 1
        steps = 0
        while i >= 0 and steps < limit:
            s, e, name = items[i]
            if e >= t:
                return name
            i -= 1
            steps += 1
        return None

    gaps = defaultdict(float)
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        t = (e0 + s1) // 2
        op = innermost(host, starts, t) or "host"
        span = innermost(spans, span_starts, t)
        gaps[f"{span}/{op}" if span else op] += (s1 - e0) / 1e9
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle_gaps]}
