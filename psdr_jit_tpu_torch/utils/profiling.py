"""Timing and tracing (counterpart of ``psdr_jit_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock logging gated by
``RenderOption.log_level`` (integrator.cpp:40-45, scene.cpp:594-599):
:func:`log_time`. :func:`trace` records a ``torch.profiler`` trace of a
block (host and, where a card is visible, device activity) as a Chrome
trace file, viewable in Perfetto or ``chrome://tracing``.

The port's layers open named spans (:func:`span`, :func:`spanned`) and
add to counters (:func:`count`) where their work happens: the entry
points (``step``, ``render``), the scene compile, the estimators, their
pullbacks and the closest hit. A span's full name is its parent's, a dot and its own
(``secondary_edge.hits``); the children of an entry span take their own
names and carry its id. Spans cost one check while nothing listens.
Under a torch profiler a span is a ``record_function`` range of its full
name, on the clock of the device kernels in the trace. While the
recorder is on (:func:`recording`) each span's host interval is kept
and, once CUDA is in use, a pair of CUDA events on the current stream;
:func:`totals` sums them by full name. Records stay in memory.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time

import torch

_RECORDER = None          # the Recorder while recording() is on
_LOCAL = threading.local()  # ``stack``: this thread's open spans
_ENTRY_IDS = itertools.count(1)
_profiling = torch.autograd._profiler_enabled


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
    ``key_averages()`` tables the block's operators. The port's spans
    are ranges of their full names in it."""
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


class Record:
    """One closed span: its full name, its parent's (None at the top),
    its entry span's id, its host interval (``perf_counter_ns``) and,
    once its CUDA events are read, its device ms."""

    __slots__ = ("full", "parent", "entry_id", "t0", "t1", "events",
                 "device_ms")

    def __init__(self, s, t1: int):
        self.full, self.parent, self.entry_id = s.full, s.parent, s.entry_id
        self.t0, self.t1, self.events = s._t0, t1, s._events
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6


class Recorder:
    """The spans that closed (``records``, in the order they closed) and
    the counters added while it was on. Spans and counts made while a
    torch profiler records are left out, so a profiled window does not
    inflate its times."""

    def __init__(self):
        self.records = []
        self.entries = 0
        self._unread = 0     # records before it have read their events
        self._counters = {}  # (full, name) -> int or a device tensor
        self._lock = threading.Lock()

    def _close(self, s, t1: int):
        with self._lock:
            self.records.append(Record(s, t1))
            if s.entry:
                self.entries += 1
                self._read_events(wait=False)

    def _count(self, full, name, value):
        with self._lock:
            key = (full, name)
            acc = self._counters.get(key, 0)
            if isinstance(value, torch.Tensor):
                value = value.detach().to(torch.int64)
                if isinstance(acc, torch.Tensor):
                    acc.add_(value)
                else:
                    acc = value + acc
            else:
                acc = acc + value
            self._counters[key] = acc

    def _read_events(self, wait: bool):
        """Read the device ms of the records whose device work has ended
        (all of them with ``wait``, after a synchronise) and let their
        events go."""
        records = self.records
        i = self._unread
        while i < len(records):
            r = records[i]
            if r.events is not None:
                if not wait and not r.events[1].query():
                    break
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                r.events = None
            i += 1
        self._unread = i

    def totals(self) -> dict:
        """``spans``: each full name's ``host_ms``, ``device_ms`` (None
        without CUDA events), ``self_ms`` (its time less its children's,
        by device time where there is one) and ``count`` (how often it
        closed); ``counters``: each span's counters' sums; ``entries``:
        the entry spans that closed."""
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with self._lock:
            self._read_events(wait=True)
            spans, children = {}, {}
            for r in self.records:
                tot = spans.setdefault(r.full, {"host_ms": 0.0,
                                                "device_ms": None,
                                                "count": 0})
                tot["host_ms"] += r.host_ms
                if r.device_ms is not None:
                    tot["device_ms"] = (tot["device_ms"] or 0.0) + r.device_ms
                tot["count"] += 1
                if r.parent is not None:
                    ch = children.setdefault(r.parent, [0.0, 0.0])
                    ch[0] += r.host_ms
                    ch[1] += r.host_ms if r.device_ms is None else r.device_ms
            for full, tot in spans.items():
                ch_host, ch_own = children.get(full, (0.0, 0.0))
                tot["self_ms"] = (tot["host_ms"] - ch_host
                                  if tot["device_ms"] is None
                                  else tot["device_ms"] - ch_own)
            counters = {}
            for (full, name), v in self._counters.items():
                counters.setdefault(full, {})[name] = int(v)
            return {"spans": spans, "counters": counters,
                    "entries": self.entries}


class _Off:
    """The span of a run that nothing listens to."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "entry", "full", "parent", "entry_id", "_rf",
                 "_rec", "_t0", "_events", "_open")

    def __init__(self, name: str, entry: bool):
        self.name, self.entry = name, entry

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self._open = top is None or top.name != self.name
        if not self._open:  # the shared chunk helpers: one span
            return self
        if top is None:
            self.full, self.parent = self.name, None
            self.entry_id = next(_ENTRY_IDS) if self.entry else None
        else:
            self.entry = False
            self.full = (self.name if top.entry
                         else f"{top.full}.{self.name}")
            self.parent, self.entry_id = top.full, top.entry_id
        stack.append(self)
        self._rf = self._rec = self._events = None
        if _profiling():
            self._rf = torch.profiler.record_function(
                self.full, None if self.entry_id is None
                else str(self.entry_id))
            self._rf.__enter__()
        elif _RECORDER is not None:
            self._rec = _RECORDER
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if not self._open:
            return False
        rec = self._rec
        if rec is not None:
            t1 = time.perf_counter_ns()
            if self._events is not None:
                self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        if rec is not None and not _profiling():
            rec._close(self, t1)
        return False


def span(name: str, entry: bool = False):
    """A context manager around one layer's work: ``entry`` marks an
    entry point (``step``, ``render``), whose children carry its id. A
    span inside an open span of the same name is not opened again.
    While no recorder is on and no torch profiler records it is a shared
    object that does nothing."""
    if _RECORDER is None and not _profiling():
        return _OFF
    return _Span(name, entry)


def spanned(name: str, entry: bool = False):
    """Decorate a function to run inside :func:`span` ``(name, entry)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, entry):
                return fn(*args, **kwargs)
        return inner
    return wrap


def counting() -> bool:
    """Whether :func:`count` adds anything now: the recorder is on and no
    torch profiler records (a caller skips computing a count else)."""
    return _RECORDER is not None and not _profiling()


def count(name: str, value) -> None:
    """Add ``value`` (a Python int or a 0-d tensor, summed on its device
    without a synchronise) to the counter ``name`` of the innermost open
    span, while :func:`counting`."""
    rec = _RECORDER
    if rec is None or _profiling():
        return
    stack = _stack()
    rec._count(stack[-1].full if stack else "", name, value)


def recording(on: bool = True):
    """Switch the recorder on (a fresh one where it was off; it stays as
    it is where it was on) or off. Returns the recorder, or None."""
    global _RECORDER
    if not on:
        _RECORDER = None
    elif _RECORDER is None:
        _RECORDER = Recorder()
    return _RECORDER


def totals() -> dict:
    """The recorder's :meth:`Recorder.totals` (empty while it is off)."""
    return (_RECORDER or Recorder()).totals()


@contextlib.contextmanager
def recorder():
    """A fresh recorder for the block (the one before is put back after
    it); yields it."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, Recorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev
