#!/usr/bin/env python3
"""Two measurements behind choices in psdr_jit_tpu_torch's PyTorch code,
on a CUDA card:

    python3 scripts/torch_gather_sqrt.py

from the repository root.

* Square roots (``core/math.py _sqrt``): torch's float32 ``sqrt`` on the
  CPU and on the card, and the float64 root rounded once to float32 (the
  correctly rounded result), on 2^22 uniform floats in [0, 2): how many
  differ, pair by pair.
* The backward of a row gather (``ops/gather.py``): a (2^22, 3) cotangent
  of uniform row ids summed into 32 to 4,096 rows by ``index_add_`` (one
  float atomic an element) and by ``torch.bincount`` with weights (a
  histogram summed in shared memory first), timed with
  ``chip_smoke.cuda_ms``; ``BINCOUNT_MAX_ROWS`` picks between them.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import cuda_ms  # noqa: E402
from psdr_jit_tpu_torch.ops import gather  # noqa: E402

LANES = 1 << 22
ROWS = (32, 80, 256, 512, 1024, 2048, 4096)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(LANES, generator=gen) * 2.0
    roots = {"cpu float32": torch.sqrt(x),
             "card float32": torch.sqrt(x.to(dev)).cpu(),
             "float64 rounded": torch.sqrt(x.double()).float()}
    names = list(roots)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            n = int((roots[a] != roots[b]).sum())
            print(f"sqrt of {LANES} floats: {a} vs {b}: {n} differ")

    for rows in ROWS:
        g = torch.Generator(device=dev).manual_seed(rows)
        idx = torch.randint(0, rows, (LANES,), device=dev, generator=g)
        ct = torch.randn((LANES, 3), device=dev, generator=g)

        def by_index_add():
            return ct.new_zeros((rows, 3)).index_add_(0, idx, ct)

        def by_bincount():
            flat = (idx[:, None] * 3 + torch.arange(3, device=dev)).reshape(-1)
            return torch.bincount(flat, ct.reshape(-1), minlength=rows * 3)

        err = float((by_bincount().reshape(rows, 3)
                     - by_index_add()).abs().max())
        print(f"gather backward, {LANES} x 3 into {rows} rows: index_add_ "
              f"{cuda_ms(by_index_add, 10):.4f} ms, bincount "
              f"{cuda_ms(by_bincount, 10):.4f} ms (max difference "
              f"{err:.3e}); the package takes "
              f"{'bincount' if rows <= gather.BINCOUNT_MAX_ROWS else 'index_add_'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
