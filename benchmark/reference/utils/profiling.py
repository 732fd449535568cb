"""Timing and tracing (counterpart of ``psdr_jit_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock logging gated by
``RenderOption.log_level`` (integrator.cpp:40-45, scene.cpp:594-599):
:func:`log_time`. :func:`trace` records a ``torch.profiler`` trace of a
block (host and, where a card is visible, device activity) as a Chrome
trace file, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def log_time(label: str, enabled: bool = True, device=None):
    """Print '<label> in X seconds.' after the block where ``enabled``.
    With a CUDA ``device`` the card is synchronised before the clock is
    read at either end, so the time is the card's work too."""
    sync = (enabled and device is not None
            and torch.device(device).type == "cuda")
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if enabled:
        if sync:
            torch.cuda.synchronize(device)
        print(f"{label} in {time.perf_counter() - t0:.6g} seconds.")


@contextlib.contextmanager
def trace(logdir: str):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is visible) and write the Chrome trace
    ``<logdir>/trace_<pid>_<n>.json``; yields the profiler, whose
    ``key_averages()`` tables the block's operators."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
