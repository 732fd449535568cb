"""The readings each limit of ``limits/<workload>.json`` is set from, on
the card at the cell's own size (the benchmark's runs never run this):

    python3 benchmark/calibrate.py --workload <name> --seeds 12 \
        --control 3 --faults 3 --out <file.json>

For each seed: the port drives the cell's entry as a run's set-up and
window do (the training steps the check follows, or the render
iterations after the warm-up), the reference renders the same, and the
compared numbers are the port's readings (the lower end of a limit). On
the first ``--control`` seeds the control, the reference computed in
bfloat16 (its float inputs and every output it reads rounded through
bfloat16) put in the port's place, gives the upper end; on the first
``--faults`` seeds each fault of ``faults.py`` planted in the reference
put in the port's place gives its readings. Writes every reading to
``--out`` and prints one JSON line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def answers_of(loop, first: int, keep: int) -> dict:
    out = {}
    for i in range(first, first + keep):
        loop.step(i)
        out[i] = loop.answer()
    return out


def readings(prog_pkg, ref_pkg, spec, workload, seed, device, control,
             fault_names, size=None, spp=None) -> dict:
    """``{"program": numbers, "control": numbers?, "<fault>": numbers?}``
    of one seed."""
    import torch

    import check
    import faults
    import harness
    from scenes import load_config
    from workload import load_mix, make_loop

    cell = harness.cell_of(spec, workload)
    config = load_config(cell["config"])
    mix = load_mix(cell["traffic"])

    def loop_of(pkg, round_to=None):
        return make_loop(pkg, config, mix, seed, device, size=size, spp=spp,
                         round_to=round_to)

    def produce(pkg, round_to=None):
        loop = loop_of(pkg, round_to)
        if mix["entry"] == "loss_and_grad":
            for i in range(loop.checked):
                loop.step(i)
            return loop.record, None
        first = loop.warmup_iterations()
        for i in range(first):
            loop.step(i)
        return None, answers_of(loop, first, int(mix["checked_answers"]))

    def numbers(record, answers):
        out = check.compare(record, answers, ref_record, ref_answers)
        if record is not None:
            out["grad_norms"] = {k: float(v.norm())
                                 for k, v in ref_record["grad"].items()}
            out["ref_losses"] = list(ref_record["loss"])
        return out

    out = {}
    record, answers = produce(prog_pkg)
    check.free_device_memory()
    ref_record, ref_answers = check.reference_outputs(loop_of(ref_pkg),
                                                      record, answers)
    check.free_device_memory()
    out["program"] = numbers(record, answers)
    if control:
        out["control"] = numbers(*produce(ref_pkg, torch.bfloat16))
        check.free_device_memory()
    for name in fault_names:
        with faults.planted(ref_pkg, name):
            out[name] = numbers(*produce(ref_pkg))
        check.free_device_memory()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seed", type=int, action="append",
                    help="read these seeds first (then --seeds more)")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault", action="append",
                    help="read only these faults (default: every fault of "
                         "the cell's entry but 'unchanged', which reads 1)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(1, str(ROOT))
    import harness
    import faults
    import reference
    from workload import load_mix

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import psdr_jit_tpu_torch as pt

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    mix = load_mix(cell["traffic"])
    fault_names = (faults.TRAIN_FAULTS if mix["entry"] == "loss_and_grad"
                   else faults.RENDER_FAULTS)
    fault_names = tuple(f for f in fault_names if f != "unchanged"
                        and (not args.fault or f in args.fault))
    results = []
    seeds = (args.seed or []) + [args.first_seed + 7919 * k
                                 for k in range(args.seeds)]
    for k, seed in enumerate(seeds):
        t = time.time()
        r = readings(pt, reference, spec, args.workload, seed, "cuda",
                     k < args.control, fault_names if k < args.faults else (),
                     )
        r["seed"] = seed
        r["seconds"] = time.time() - t
        results.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    summary = {}
    for r in results:
        for kind, numbers in r.items():
            if not isinstance(numbers, dict):
                continue
            for name, v in numbers.items():
                if not isinstance(v, float):
                    continue
                s = summary.setdefault(kind, {}).setdefault(
                    name, {"min": v, "max": v})
                s["min"], s["max"] = min(s["min"], v), max(s["max"], v)
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(0),
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
