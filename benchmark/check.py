"""What decides ``correct``: the port's outputs on the timed path held
against the reference package's (``reference/``), which rebuilds the
scene from the same arrays and draws the same samples.

Training cells (``loss_and_grad``): the reference follows the set-up's
first ``checked_steps`` steps from the same start, target and seeds, with
its own Adam. Compared, as gaps relative to the reference:

- ``loss_gap``: the worst step's ``|L - L_ref| / |L_ref|``, and
  ``loss_gap.<k>`` step ``k``'s own (from 1);
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step over ``1 - beta1``), each leaf's ``| |g| - |g_ref| |`` over the
  larger of its ``|g_ref|`` and the median leaf's ``|g_ref|``, by the worst
  leaf; ``grad_gap.median`` by the median leaf, and ``grad_gap.<leaf>``
  each leaf's own (a cell's limits name the ones it compares: where one
  leaf swings from seed to seed, the others are held by their own);
- ``change_gap``: the parameters' change over the checked steps, by the
  worst leaf, each as above; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (Adam moves them by
  round-off);
- ``image_gap``: the first step's image, ``sum |I - I_ref| / sum
  |I_ref|``.

Render cells: ``checked_answers`` iterations of the window, drawn from
the seed (reservoir sampling), each rendered again by the reference with
its sampler seed; the worst sample's relative L1 of each image
(``primal_gap`` and ``tangent_gap``, or ``image_gap``).

The limits of each cell are data, ``limits/<workload>.json``: ``{number:
{"limit": x, ...}}`` with the readings each was set from. A cell compares
the numbers its file names, and each has to be there and within its limit.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
LEAF_FLOOR = 1e-3  # a leaf counts in change_gap above this share of the median


def load_limits(workload: str) -> dict:
    path = LIMITS_DIR / f"{workload}.json"
    if not path.exists():
        return {}
    return {k: v["limit"] for k, v in json.loads(path.read_text()).items()}


def rel_l1(a, b) -> float:
    a, b = a.double(), b.double()
    den = float(b.abs().sum())
    num = float((a - b).abs().sum())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's ``| |prog| - |ref| |`` over the larger of its ``|ref|``
    and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    scale = statistics.median(norms.values()) if norms else 0.0
    out = {}
    for k in keys:
        den = max(norms[k], scale)
        gap = abs(float(prog[k].double().norm()) - norms[k])
        out[k] = gap / den if den > 0 else (0.0 if gap == 0 else math.inf)
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    losses = [abs(a - b) / abs(b) if b != 0 else abs(a - b)
              for a, b in zip(prog["loss"], ref["loss"])]
    g_norms = {k: float(v.double().norm()) for k, v in ref["grad"].items()}
    g_med = statistics.median(g_norms.values())
    moving = [k for k, n in g_norms.items() if n >= LEAF_FLOOR * g_med]
    change_p = {k: prog["end"][k] - prog["start"][k] for k in prog["end"]}
    change_r = {k: ref["end"][k] - ref["start"][k] for k in ref["end"]}
    grads = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    changes = leaf_gaps(change_p, change_r, moving)
    out = {"loss_gap": max(losses),
           "grad_gap": max(grads.values()),
           "grad_gap.median": statistics.median(grads.values()),
           "change_gap": max(changes.values(), default=0.0),
           "image_gap": rel_l1(prog["image"], ref["image"])}
    out.update({f"loss_gap.{k}": v for k, v in enumerate(losses, 1)})
    out.update({f"grad_gap.{k}": v for k, v in grads.items()})
    return out


def render_numbers(prog_answers: dict, ref_answers: dict) -> dict:
    """``{<image>_gap: worst relative L1}`` over the sampled iterations."""
    out = {}
    for i, ans in prog_answers.items():
        for key, img in ans.items():
            gap = rel_l1(img, ref_answers[i][key])
            out[f"{key}_gap"] = max(out.get(f"{key}_gap", 0.0), gap)
    return out


def reference_outputs(loop, record, answers):
    """What the reference's ``loop`` produces for the program's run:
    ``(record, None)`` after the checked steps of a training cell, or
    ``(None, answers)`` for the render iterations the program's answers
    came from."""
    if record is not None:
        for i in range(loop.checked):
            loop.step(i)
        return loop.record, None
    ref_answers = {}
    for i in sorted(answers):
        loop.step(i)
        ref_answers[i] = loop.answer()
    return None, ref_answers


def compare(record, answers, ref_record, ref_answers) -> dict:
    """The compared numbers of a run's outputs against the reference's."""
    if record is not None:
        return train_numbers(record, ref_record)
    return render_numbers(answers, ref_answers)


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: each number that has a limit beside it; a
    cell without limits, or a limited number that is missing or not
    finite, fails."""
    checks = {}
    ok = bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def free_device_memory():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
