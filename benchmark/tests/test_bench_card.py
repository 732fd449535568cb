"""On the card, at a cell's own size: the port passes its limits and the
control (the reference computed in bfloat16) fails them. Skips without a
card; run with ``python -m pytest benchmark/tests -m gpu``."""
import pytest

import calibrate
import check
import harness
from conftest import ROOT

SPEC = harness.load_spec(ROOT)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["cbox.frame", "cbox.renderD_fwd"])
def test_port_passes_and_control_fails_on_card(card, workload):
    import psdr_jit_tpu_torch as pt
    import reference

    r = calibrate.readings(pt, reference, SPEC, workload, 3_200_000_017,
                           card, True, ())
    limits = check.load_limits(workload)
    assert check.judge(r["program"], limits)[0], r
    assert not check.judge(r["control"], limits)[0], r
