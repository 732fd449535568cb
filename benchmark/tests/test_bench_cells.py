"""A small dry run of every cell on the CPU, where the port runs its
plain versions: the harness drives the cell's traffic file end to end
and holds it against the reference. Then the check's failures: the
control (the reference computed in bfloat16) and each fault of
``faults.py`` planted in the port come out not correct, with the cells'
own limits."""
import math

import pytest

import check
import faults
import harness
import reference
from conftest import ROOT

SPEC = harness.load_spec(ROOT)
CELLS = [c["name"] for c in SPEC["workloads"]]
SIZE, SPP = (16, 16), 4
SEED = 2 ** 31 + 11  # larger than 32 signed bits hold


def _run(workload, seed=SEED, program=None):
    import psdr_jit_tpu_torch as pt

    return harness.run_cell(SPEC, workload, seed, 1.0, False, device="cpu",
                            size=SIZE, spp=SPP, program=program or pt,
                            reference=reference)


@pytest.mark.parametrize("workload", CELLS)
def test_dry_run(workload):
    r = _run(workload)
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = harness.cell_of(SPEC, workload)
    names = {m["name"] for m in SPEC["end_to_end"]
             if harness.applies(m, workload)}
    assert set(r["metrics"]) == names
    assert list(r)[-1] == "checks"
    for name, c in r["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], name
    assert r["correct"] is True
    assert r["device"]["count"] == cell["chips"]


def _control_readings(workload):
    import calibrate
    import psdr_jit_tpu_torch as pt

    return calibrate.readings(pt, reference, SPEC, workload, SEED, "cpu",
                              True, (), size=SIZE, spp=SPP)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    r = _control_readings(workload)
    ok, _ = check.judge(r["control"], check.load_limits(workload))
    assert not ok
    assert any(r["control"][k] > 3 * v for k, v in r["program"].items()
               if isinstance(v, float))


def _faults(workload):
    mix = harness.load_mix(harness.cell_of(SPEC, workload)["traffic"])
    names = (faults.TRAIN_FAULTS if mix["entry"] == "loss_and_grad"
             else faults.RENDER_FAULTS)
    return [(workload, f) for f in names]


@pytest.mark.parametrize("workload,fault",
                         [p for w in CELLS for p in _faults(w)])
def test_fault_in_the_port_fails(workload, fault):
    import psdr_jit_tpu_torch as pt

    with faults.planted(pt, fault):
        r = _run(workload)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _record(norms, scale=None):
    """A training record whose first gradients have the given norms, the
    leaf ``scale[0]`` scaled by ``scale[1]``."""
    import torch

    grad = {k: torch.full((3,), n / 3 ** 0.5) for k, n in norms.items()}
    if scale is not None:
        grad[scale[0]] = grad[scale[0]] * scale[1]
    start = {k: torch.zeros(3) for k in norms}
    end = {k: torch.full((3,), 0.1) for k in norms}
    return {"loss": [1.0, 0.9, 0.8], "grad": grad, "start": start,
            "end": end, "image": torch.ones(4, 3)}


@pytest.mark.parametrize("leaf,factor", [("tx", 2.0), ("tx", 1.01),
                                         ("rad", 1.01)])
def test_one_leaf_gradient_scaled_fails(leaf, factor):
    # the box's leaf norms as the reference reads them (PERF.md)
    norms = {"tx": 2.0e4, "dv": 15.0, "alb": 500.0, "rad": 5000.0}
    limits = check.load_limits("cbox.train")
    ref = _record(norms)
    assert check.judge(check.train_numbers(_record(norms), ref), limits)[0]
    numbers = check.train_numbers(_record(norms, (leaf, factor)), ref)
    ok, checks = check.judge(numbers, limits)
    assert not ok
    assert checks[f"grad_gap.{leaf}"]["value"] > checks[f"grad_gap.{leaf}"]["limit"]
