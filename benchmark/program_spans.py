"""The program's own spans and counters, for the per-layer readers that
read them (``psdr_jit_tpu_torch/utils/profiling.py``): the spans the
port opens where its work happens, keyed by full name (``step``,
``compile.pullback``, ``secondary_edge.hits``), and the counters of its
spans (``secondary_edge.hits``: ``rays``, ``active``).

A reader calls :func:`switch_on` when it is imported: the harness imports
the readers only in a traced run, after the warm iterations, so the run
that gives the end-to-end metrics keeps the recorder off. The recorder
leaves out what a torch profiler recorded, so the readers divide by its
own count of entry spans (``step``, ``render``), not by the window's
iterations. A program without the recorder gives nothing to read."""


def _profiling():
    """The program's profiling module, or None where it has no
    recorder."""
    try:
        from psdr_jit_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "recording")
            and hasattr(profiling, "totals")):
        return None
    return profiling


def switch_on():
    """Switch the program's recorder on, where it has one."""
    p = _profiling()
    if p is not None:
        p.recording()


def totals():
    """The recorder's totals, or None."""
    p = _profiling()
    return None if p is None else p.totals()


def _ms(span: dict, clock: str) -> float:
    if clock == "device":
        return (span["host_ms"] if span["device_ms"] is None
                else span["device_ms"])
    return span[f"{clock}_ms"]


def mean_ms(names, clock: str):
    """The spans ``names``' summed ms on ``clock`` ("device": the CUDA
    events, or the host clock where a span has none; "host"; "self": the
    time less the children's, by the device clock where there is one),
    a mean per entry span; None where none of them closed."""
    t = totals()
    if not t or not t["entries"]:
        return None
    found = [t["spans"][n] for n in names if n in t["spans"]]
    if not found:
        return None
    return sum(_ms(s, clock) for s in found) / t["entries"]


def counter_share(span: str, part: str, whole: str):
    """100 × the counter ``part`` over the counter ``whole`` of ``span``,
    or None where they are absent or ``whole`` is 0."""
    t = totals()
    c = (t or {}).get("counters", {}).get(span, {})
    if not c.get(whole) or part not in c:
        return None
    return 100.0 * c[part] / c[whole]
