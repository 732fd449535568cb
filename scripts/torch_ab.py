#!/usr/bin/env python3
"""Two checkouts of psdr_jit_tpu_torch on one CUDA card, in turns.

    git archive <commit> | tar -x -C _tree/parent      # a git-ignored dir
    python3 scripts/torch_ab.py _tree/parent .          # A, B, B, A

Runs each checkout's package in a process of its own (the two share the
package name), in the order A, B, B, A, and prints one JSON line a run and
a summary. Each run measures, on its checkout's kernels:

* the 102,412-triangle gallery (``chip_smoke.gallery_arrays``, 256x256,
  spp 4, ``PathTracer(2).renderC``): the frame's host time (median of 5)
  and peak device memory, and K6 alone on each of the frame's launches
  (CUDA events, recorded inputs), per launch and summed;
* the Cornell-box training step of ``chip_smoke.py`` (512x512, spp 32,
  sppe 32, ``PathTracer(3).loss_and_grad``): its host time (median of 3)
  and peak device memory, and K4 alone on each of the step's launches;
* ptxas's registers, stack and spills of K4 and K6 from the checkout's
  build;
* K6's own (ray, triangle) tests per ray: from its counting build where it
  has one, else (the block/cluster hierarchy it replaced) the 64-triangle
  clusters its rays enter before their hits, times 64.

The tests that any hierarchy of boxes must make (``chip_smoke``
``triangle_box_tests``) and the bytes any closest hit must move (the rays,
and ``TRI_BYTES`` a triangle) depend on the rays, hits and triangles only,
so one count, and one bound, serves both checkouts; it is computed in the
B runs.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(tree: Path) -> dict:
    """One run on the checkout at ``tree`` (its package and chip_smoke)."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    assert Path(pt.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda:0")
    _cuda.library()
    out = {"tree": str(tree), "card": cs.card_line()}
    report = (_cuda.build().parent / "ptxas.txt").read_text()
    out["ptxas"] = {k: _this_smoke().ptxas_report(k, report)
                    for k in ("shade_bwd_kernel", "bvh_kernel")}

    # ---- the gallery frame ------------------------------------------------
    big = pt.Scene.from_arrays(cs.gallery_arrays(256, 256, 4), device=dev)
    big.configure()
    integ = pt.PathTracer(2)
    integ.renderC(big, 0, seed=0)
    with cs.KernelCalls({"K6": (bvh, "bvh_cuda")}) as rec:
        integ.renderC(big, 0, seed=0)
        torch.cuda.synchronize()
    calls = rec.calls["K6"]
    launch_ms = [cs.cuda_ms(lambda: fn(*args), 5) for fn, args, _ in calls]
    out["K6_launch_ms"] = launch_ms
    out["K6_frame_ms"] = sum(launch_ms)
    n_rays = sum(args[1].shape[0] for _, args, _ in calls)
    own = 0
    for fn, args, res in calls:
        h, o, d, act = args
        if hasattr(h, "cbox"):  # the block/cluster hierarchy
            own += cs.needed_tests(h.cbox[:, 0:3], h.cbox[:, 4:7],
                                   bvh.BVH_CLUSTER, o, d, res[0], act)
        else:
            c = torch.zeros((o.shape[0], 2), dtype=torch.int32, device=dev)
            fn(*args, counts=c)
            own += int(c[:, 0].sum())
    out["K6_tests_per_ray"] = own / n_rays
    if hasattr(cs, "triangle_box_tests"):
        need = sum(cs.triangle_box_tests(
            args[0].tri4[:, 0:3], args[0].tri4[:, 3:6], args[0].tri4[:, 6:9],
            args[1], args[2], res[0], args[3]) for _, args, res in calls)
        out["needed_tests_per_ray"] = need / n_rays
        tris = sum(cs.TRI_BYTES * args[0].tri4.shape[0]
                   for _, args, _ in calls)
        out["K6_bound_ms"] = cs.bound(n_rays * (cs.RAY_BYTES + 1) + tris,
                                      need * cs.TEST_FLOPS)[0]
    out["frame_ms"] = cs.wall_ms(lambda: integ.renderC(big, 0, seed=0), 5)
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(big, 0, seed=0)
    torch.cuda.synchronize()
    out["frame_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    # ---- the training step ------------------------------------------------
    scene = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    scene.opts.sppe = cs.SPPE
    step = cs.train_step_fn(pt.PathTracer(cs.DEPTH), scene)
    step()
    with cs.KernelCalls({"K4": (sm, "shade_adjoint_cuda")}) as rec:
        step()
        torch.cuda.synchronize()
    k4 = [cs.cuda_ms(lambda: fn(*args), 5) for fn, args, _ in rec.calls["K4"]]
    out["K4_launch_ms"] = k4
    out["K4_step_ms"] = sum(k4)
    out["step_ms"] = cs.wall_ms(step, 3)
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    torch.cuda.synchronize()
    out["step_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def _this_smoke():
    """This checkout's ``chip_smoke`` module (for its ptxas parser, which
    an older checkout's may lack), loaded under another name."""
    spec = importlib.util.spec_from_file_location(
        "_ab_chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print("AB " + json.dumps(measure(Path(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device visible", file=sys.stderr)
        return 2
    a, b = (Path(x).resolve() for x in sys.argv[1:])
    runs = []
    for tree in (a, b, b, a):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--measure",
                               str(tree)], capture_output=True, text=True,
                              cwd=tree, timeout=1200)
        lines = [ln[3:] for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
        print(json.dumps(runs[-1]), flush=True)
        print(f"[run] {tree.name or tree}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    keys = ("K6_frame_ms", "K6_tests_per_ray", "frame_ms", "frame_peak_gb",
            "K4_step_ms", "step_ms", "step_peak_gb")
    for k in keys:
        print(f"{k:18s} A {statistics.mean([runs[0][k], runs[3][k]]):10.4f} "
              f"({runs[0][k]:.4f}, {runs[3][k]:.4f})  B "
              f"{statistics.mean([runs[1][k], runs[2][k]]):10.4f} "
              f"({runs[1][k]:.4f}, {runs[2][k]:.4f})")
    for k in ("needed_tests_per_ray", "K6_bound_ms"):
        print(f"{k:18s} {runs[1].get(k)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
