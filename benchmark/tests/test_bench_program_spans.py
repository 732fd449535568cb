"""The readers of the program's own spans and counters
(``program_spans.py``): None on an empty recorder and on a program
without one; on a recorder filled by hand, through the program's spans
on a set clock, the value reckoned from it (on the CPU the device clock
falls back to the host's)."""
import types

import pytest

import harness
from psdr_jit_tpu_torch.utils import profiling

MS = 1_000_000  # ns

# two entries of this tree, (name, start ms, end ms, children, counts)
STEP = ("step", 0, 100, [
    ("compile", 0, 10, [], []),
    ("interior", 10, 40, [("hits", 12, 20, [], []),
                          ("pullback", 30, 38, [], [])], []),
    ("secondary_edge", 40, 90, [
        ("hits", 40, 43, [], [("rays", 100), ("active", 50)]),
        ("hits", 45, 48, [], [("rays", 100), ("active", 40)]),
        ("hits", 50, 53, [], [("rays", 100), ("active", 30)]),
        ("pullback", 60, 65, [], []),
        ("pullback", 70, 75, [], [])], []),
    ("compile.pullback", 92, 96, [], [])], [])

# each reader's value on that recorder, a mean per entry
EXPECTED = {
    "entry_self_ms": 100 - (10 + 30 + 50 + 4),
    "compile_pullback_ms": 4.0,
    "secondary_edge_hits_ms": 9.0,
    "secondary_edge_pullback_ms": 10.0,
    "interior_hits_ms": 8.0,
    "secondary_edge_active_share": 40.0,
}


@pytest.fixture
def readers():
    """The readers, loaded as the harness loads them, with a recorder of
    the test's own (so loading them leaves the process's as it was)."""
    with profiling.recorder():
        yield {name: harness.load_reader(name) for name in EXPECTED}


def _fill(monkeypatch, entries: int = 2):
    """``entries`` steps of ``STEP``, 100 ms apart, on a set clock."""
    clock = [0, 0]  # the entry's start, the time in it (ns)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: sum(clock)))

    def run(name, t0, t1, children, counts, entry=False):
        clock[1] = t0 * MS
        with profiling.span(name, entry=entry):
            for c in children:
                run(*c)
            for key, v in counts:
                profiling.count(key, v)
            clock[1] = t1 * MS

    for i in range(entries):
        clock[0] = 100 * i * MS
        run(*STEP, entry=True)


def test_readers_read_nothing_on_an_empty_recorder(readers):
    for name, reader in readers.items():
        assert reader.read(None) is None, name


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_recorder_filled_by_hand(readers, monkeypatch, name):
    _fill(monkeypatch)
    assert profiling.totals()["entries"] == 2
    assert readers[name].read(None) == pytest.approx(EXPECTED[name])


def test_readers_read_nothing_without_the_recorder(readers, monkeypatch):
    """A program without the recorder (an older commit): loading and
    reading raise nothing and read None."""
    _fill(monkeypatch)
    monkeypatch.delattr(profiling, "recording")
    for name in EXPECTED:
        assert harness.load_reader(name).read(None) is None, name
