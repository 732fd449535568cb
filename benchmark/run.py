"""The benchmark of psdr_jit_tpu_torch (BENCHMARK.json at the root):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout, on a machine with the cards the cell
asks for. It builds the cell's scene from its configuration on the card,
warms up the cell's own iteration, measures for ``--seconds``, checks the
output against the reference (``benchmark/reference``) and prints one JSON
line last: the end-to-end metrics with ``--trace 0``, the per-layer
metrics with ``--trace 1``. Without the cards it exits 2 and prints no
result. The kernels build at first use into the port's build directory in
the checkout; other compile caches go to ``.bench_cache/`` there.
"""

import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import harness

    harness.phase("torch imported", T0)

    spec = harness.load_spec(ROOT)
    cell = harness.cell_of(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    sys.path.insert(1, str(ROOT))  # the port, beside the benchmark
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
