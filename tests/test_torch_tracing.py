"""The port's spans and counters (``psdr_jit_tpu_torch/utils/profiling.py``)
on a 16x16, spp-4 Cornell box step (sppe 4, sppse 4, depth 3): the span
tree of ``loss_and_grad``, ``renderD`` and ``renderC``, the closest hit's
lane counters against the secondary-edge pass's own masks, a step with
nothing listening (no records, the same bits), and a step under
``profiling.trace`` (the spans in the Chrome trace, none in the
recorder)."""

import json
import os

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import psdr_jit_tpu_torch as pt
from psdr_jit_tpu_torch.integrator import edge
from psdr_jit_tpu_torch.scene.scene import SceneData
from psdr_jit_tpu_torch.utils import profiling
from chip_smoke import train_setup
from torch_threads import _one_thread  # noqa: F401

SEED = 3
SCENE_NPZ = os.path.join(os.path.dirname(__file__), "data", "cbox_scene.npz")
STEP_SPANS = {"step", "compile", "interior", "interior.pullback",
              "primary_edge", "primary_edge.pullback", "secondary_edge",
              "secondary_edge.hits", "secondary_edge.pullback",
              "compile.pullback"}


def _box():
    with np.load(SCENE_NPZ) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["opts"] = np.asarray([16, 16, 4, 4, 4], np.int64)
    sc = pt.Scene.from_arrays(arrays, device="cpu")
    sc.configure()
    return sc


@pytest.fixture(scope="module")
def box():
    sc = _box()
    params, apply_params, pixel_loss = train_setup(sc)
    return sc, params, apply_params, pixel_loss, pt.PathTracer(3)


def _step(box):
    sc, params, apply_params, pixel_loss, integ = box
    return integ.loss_and_grad(sc, params, apply_params, pixel_loss,
                               seed=SEED)


@pytest.fixture(scope="module")
def recorded(box):
    """The recorded step, and each closest hit of its secondary-edge pass
    as ``(rays, active lanes)`` from the masks the pass hands it."""
    hits, inside = [], []
    ray_intersect = SceneData.ray_intersect
    eval_se = edge.eval_secondary_edge

    def spy_hit(self, ray, active=None, *args, **kwargs):
        its = ray_intersect(self, ray, active, *args, **kwargs)
        if inside:
            n = its.tri_id.numel()
            hits.append((n, n if active is None else int(active.sum())))
        return its

    def spy_pass(*args, **kwargs):
        inside.append(True)
        try:
            return eval_se(*args, **kwargs)
        finally:
            inside.pop()

    mp = pytest.MonkeyPatch()
    mp.setattr(SceneData, "ray_intersect", spy_hit)
    mp.setattr(edge, "eval_secondary_edge", spy_pass)
    try:
        with profiling.recorder() as rec:
            out = _step(box)
            totals = rec.totals()
    finally:
        mp.undo()
    return out, rec, totals, hits


def test_step_span_tree(recorded):
    """Each span of the step is there, once an entry; every child's host
    interval lies inside its parent's, under the same entry id; no self
    time is negative."""
    _, rec, totals, _ = recorded
    assert set(totals["spans"]) == STEP_SPANS
    assert totals["entries"] == 1
    assert totals["spans"]["step"]["count"] == 1
    assert totals["spans"]["secondary_edge.hits"]["count"] >= 3
    (entry,) = [r for r in rec.records if r.full == "step"]
    assert entry.parent is None and entry.entry_id is not None
    for r in rec.records:
        assert r.entry_id == entry.entry_id, r.full
        if r is entry:
            continue
        parents = [p for p in rec.records if p.full == r.parent
                   and p.t0 <= r.t0 and r.t1 <= p.t1]
        assert len(parents) == 1, r.full
    for name, s in totals["spans"].items():
        assert s["device_ms"] is None  # no card: the host clock
        assert s["self_ms"] >= 0.0, name
        assert s["self_ms"] <= s["host_ms"], name


def test_secondary_edge_hit_counters(recorded):
    """The closest hit counts the secondary-edge pass's rays and its live
    lanes, those of the masks the pass passed it."""
    _, _, totals, hits = recorded
    c = totals["counters"]["secondary_edge.hits"]
    assert c["rays"] >= c["active"] >= 0
    assert c["rays"] == sum(n for n, _ in hits)
    assert c["active"] == sum(a for _, a in hits)
    assert 0 < c["active"] < c["rays"]
    assert set(totals["counters"]) == {"secondary_edge.hits"}


def test_step_unrecorded_is_the_same(recorded, box):
    """With nothing listening a span is the one shared no-op object, no
    record is made, and the step's loss, gradients and image are the
    recorded step's bit for bit."""
    (loss, grads, image), _, _, _ = recorded
    assert profiling.recording(False) is None
    assert profiling.span("step", entry=True) is profiling.span("hits")
    loss2, grads2, image2 = _step(box)
    assert profiling.totals() == {"spans": {}, "counters": {},
                                  "entries": 0}
    assert torch.equal(loss, loss2) and torch.equal(image, image2)
    assert grads.keys() == grads2.keys()
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k


def test_profiled_step_in_the_trace_not_the_recorder(box, tmp_path):
    """Under ``profiling.trace`` the spans are ranges of their full names
    in the Chrome trace; the recorder, on all along, keeps none of
    them."""
    with profiling.recorder() as rec:
        with profiling.trace(str(tmp_path)):
            _step(box)
        totals = rec.totals()
    assert totals == {"spans": {}, "counters": {}, "entries": 0}
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"step", "compile.pullback", "secondary_edge.hits"} <= names


def test_render_span_trees(box):
    """renderD in forward mode: the render's compile, interior (the
    general Li's closest hits) and both edge images, no pullback;
    renderC on the megakernel's scene: the interior alone, no closest
    hit through the scene."""
    sc, params, apply_params, _, integ = box
    with profiling.recorder() as rec:
        with fwAD.dual_level():
            apply_params({**params, "tx": fwAD.make_dual(
                params["tx"], torch.ones_like(params["tx"]))})
            img = integ.renderD(sc, 0, seed=SEED)
            tangent = fwAD.unpack_dual(img).tangent
        apply_params(params)
        d_totals = rec.totals()
    assert tangent is not None and bool(tangent.abs().sum() > 0)
    assert set(d_totals["spans"]) == {
        "render", "compile", "interior", "interior.hits", "primary_edge",
        "secondary_edge", "secondary_edge.hits"}
    assert d_totals["entries"] == 1
    hits = d_totals["counters"]["interior.hits"]
    assert hits["rays"] >= hits["active"] > 0
    with profiling.recorder() as rec:
        integ.renderC(sc, 0, seed=SEED)
        c_totals = rec.totals()
    assert set(c_totals["spans"]) == {"render", "interior"}
    assert c_totals["entries"] == 1 and c_totals["counters"] == {}


def test_span_rules():
    """A span inside an open span of its own name is not opened again;
    an entry's children take their own names and its id; counters sum
    ints and 0-d tensors under the innermost span's full name."""
    with profiling.recorder() as rec:
        with profiling.span("render", entry=True):
            with profiling.span("interior"):
                with profiling.span("interior"):
                    with profiling.span("hits"):
                        profiling.count("rays", 4)
                        profiling.count("rays", torch.tensor(3))
                        profiling.count("active", torch.tensor(2))
        totals = rec.totals()
    assert [r.full for r in rec.records] == ["interior.hits", "interior",
                                             "render"]
    assert len({r.entry_id for r in rec.records}) == 1
    assert totals["spans"]["interior"]["count"] == 1
    assert totals["counters"] == {"interior.hits": {"rays": 7, "active": 2}}
    assert not profiling.counting()
