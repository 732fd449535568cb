#!/usr/bin/env python3
"""K4 built from other sources, timed on one CUDA card on the training
step's own inputs.

    python3 scripts/torch_k4_variants.py DIR [DIR ...]

Each DIR holds the kernel sources of ``ops/_cuda.SOURCES`` (for example
the package's ``psdr_jit_tpu_torch/csrc``, a parent commit's, or a copy
edited to leave out one part of K4 for a measurement; such copies belong
in a git-ignored directory). Each is built by ``_cuda.build`` into a
library of its own under the package's ignored ``build/`` and launched
through ``shade_mega.shade_adjoint_cuda``. The script records the K4 launches of one step of
``chip_smoke.py``'s training main path (512x512, spp 32, sppe 32,
``PathTracer(3).loss_and_grad``) through the package, prints ptxas's
registers, stack and spills of each build's ``shade_bwd_kernel``, the
largest relative L1 of its cotangent groups against the package's K4, and
its ms a step (CUDA events, the step's launches, 5 repetitions), in four
rounds in turns (forward, backward, forward, backward). It also prints, for
the step's stashed hits, how many distinct table rows the 32 lanes of a
warp hit at each of the path's hits.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def kernels_of(src: Path):
    """The package's wrappers launch the kernels built from ``src``."""
    from psdr_jit_tpu_torch.ops import _cuda

    saved = _cuda.library
    _cuda.library = lambda: saved(src)
    try:
        yield
    finally:
        _cuda.library = saved


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_k4_variants: no CUDA device visible", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    srcs = [Path(x).resolve() for x in sys.argv[1:]]
    for src in srcs:
        _cuda.library(src)
        report = (_cuda.build(src).parent / "ptxas.txt").read_text()
        print(f"{src}: ptxas (depth:registers/stack/spill stores+loads) "
              f"{cs.ptxas_report('shade_bwd_kernel', report)}", flush=True)

    dev = torch.device("cuda:0")
    scene = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    scene.opts.sppe = cs.SPPE
    step = cs.train_step_fn(pt.PathTracer(cs.DEPTH), scene)
    with cs.KernelCalls({"K4": (sm, "shade_adjoint_cuda")}) as rec:
        step()
        torch.cuda.synchronize()
    calls = [args for _, args, _ in rec.calls["K4"]]
    print(f"K4 launches in a step: {len(calls)}, lanes "
          f"{[a[6].shape[0] for a in calls]}", flush=True)
    ref = [sm.shade_adjoint_cuda(*a) for a in calls]
    for src in srcs:
        with kernels_of(src):
            got = [sm.shade_adjoint_cuda(*a) for a in calls]
        rel = max(float((x - y).abs().sum() / y.abs().sum().clamp_min(1e-30))
                  for r, g in zip(ref, got) for x, y in zip(g, r))
        print(f"{src}: largest group rel L1 vs the package's K4 {rel:.3e}")
    times = {src: [] for src in srcs}
    for rnd in range(4):
        for src in (srcs if rnd % 2 == 0 else srcs[::-1]):
            with kernels_of(src):
                times[src].append(cs.cuda_ms(
                    lambda: [sm.shade_adjoint_cuda(*a) for a in calls], 5))
    for src, ts in times.items():
        print(f"{src}: ms a step " + " ".join(f"{t:.3f}" for t in ts))
    ids = calls[0][3]
    warps = ids[:, :ids.shape[1] // 32 * 32].reshape(ids.shape[0], -1, 32)
    rows = (warps.sort(-1).values.diff(dim=-1) != 0).sum(-1) + 1
    for k in range(ids.shape[0]):
        print(f"hit {k}: distinct rows a warp, mean "
              f"{rows[k].float().mean():.3f}, one-row warps "
              f"{(rows[k] == 1).float().mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
