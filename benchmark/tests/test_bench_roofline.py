"""The rooflines' arithmetic against chip_smoke.py's (the figures the
bring-up PRs reported), on fixed shapes."""
import re

import pytest
import torch

import roofline
import tracing


def test_bound_matches_chip_smoke():
    import chip_smoke

    for nbytes, flops in ((1e9, 0.0), (3.35e8, 1e12), (41e6, 46e9)):
        ms, by = chip_smoke.bound(nbytes, flops)
        s, by2 = roofline.bound(nbytes, flops)
        assert by == by2
        assert s * 1e3 == pytest.approx(ms, rel=1e-12)


def test_k1_bytes_match_hit_bound_terms():
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    f, n = 32, 4096
    p0 = torch.rand((f, 3), generator=gen)
    e1 = torch.rand((f, 3), generator=gen) * 0.1
    e2 = torch.rand((f, 3), generator=gen) * 0.1
    o = torch.rand((n, 3), generator=gen) - 2.0
    d = torch.nn.functional.normalize(torch.ones(n, 3), dim=-1)
    t = torch.full((n,), 1e30)
    active = torch.ones(n, dtype=torch.bool)
    nbytes, _, _ = chip_smoke.hit_bound_terms(p0, e1, e2, o, d, t, active)
    shapes = [[9, f], [6, f // 16], [n, 3], [n, 3], [n]]
    assert roofline.k1_bytes(shapes) == nbytes


@pytest.mark.parametrize("mode,depth,per_lane", [
    (roofline.K2_SINGLE, 3, 41), (roofline.K2_PAIR, 3, 65),
    (roofline.K2_STASH, 3, 41 + 12 * 7), (None, None, 41)])
def test_k2_bytes_by_mode(mode, depth, per_lane):
    n, f = 1000, 32
    shapes = [[9, f]] + [[]] * 4 + [[n, 3]] * 4 + [[n], [n]] + [[]] * 6
    concrete = [None] * 12 + [depth, 0, False, mode, 2]
    assert roofline.k2_bytes(shapes, None, concrete) == \
        n * per_lane + roofline.TRI_BYTES * f


def test_share_sums_launches_and_kernel_time():
    shapes = [[9, 32], [2, 16], [1000, 3], [1000, 3], [1000]]
    trace = tracing.Trace(
        ops=[("psdr_jit_tpu_torch::k1_sweep", shapes, None, None)] * 2,
        kernels=[("void sweep_kernel<2>(float const*)", 1e-6),
                 ("void li_mega_kernel<0>(...)", 5.0)])
    share = roofline.share(trace, "psdr_jit_tpu_torch::k1_sweep",
                           re.compile(r"\bsweep_kernel\b"), roofline.k1_bytes)
    nbytes = 2 * (1000 * 41 + 36 * 32)
    assert share == pytest.approx(100 * nbytes / 3.35e12 / 1e-6)
    assert roofline.share(tracing.Trace(), "x", re.compile("y"),
                          roofline.k1_bytes) is None


def test_busy_union_and_breakdown():
    ev = [("k_a", True, 0, 0, 100, None, None, None, False),
          ("k_b", True, 0, 50, 150, None, None, None, False),
          ("k_a", True, 0, 400, 500, None, None, None, False),
          ("aten::item", False, -1, 140, 420, None, None, None, False),
          ("interior", False, -1, 0, 600, None, None, None, True)]
    assert tracing.busy_seconds(ev) == pytest.approx(250e-9)
    bd = tracing.breakdown(ev)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(200e-9)]
    assert bd["idle_gaps"] == [["interior/aten::item", pytest.approx(250e-9)]]
    assert tracing.short_name("void li_mega_kernel<2, true>(float*, int)") \
        == "li_mega_kernel"
