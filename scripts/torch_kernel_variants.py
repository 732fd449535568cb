#!/usr/bin/env python3
"""K2 or K4 built from other sources, timed on one CUDA card on the main
paths' own inputs.

    python3 scripts/torch_kernel_variants.py K2|K4 DIR [DIR ...]

Each DIR holds the kernel sources of ``ops/_cuda.SOURCES`` (for example
the package's ``psdr_jit_tpu_torch/csrc``, a parent commit's, or a copy
edited to leave out one part of a kernel for a measurement; such copies
belong in a git-ignored directory). Each is built by ``_cuda.build`` into
a library of its own under the package's ignored ``build/`` and launched
through the package's wrappers. The script records the kernel's launches
in the main paths of ``chip_smoke.py`` through the package, prints
ptxas's registers, stack and spills of each build's kernel, how far each
build's results are from the package's, and each build's ms on those
launches (CUDA events, 3 repetitions a launch) in four rounds in turns
(forward, backward, forward, backward).

K4: the two launches of one training step (512x512, spp 32, sppe 32,
``PathTracer(3).loss_and_grad``); it also prints, for the step's stashed
hits, how many distinct table rows the 32 lanes of a warp hit at each of
the path's hits.

K2: the single-mode launch of a 512x512 spp-32 ``PathTracer(3).renderC``
frame and the stash- and pair-mode launches of that training step. It
also prints:

* from K2's plain version run with its sweep recorder on each mode's
  first launch: the lanes each sweep's result is used for
  (``Sweep.active``) and the (ray, triangle) tests a lane a sweep that any
  hierarchy of boxes needs (``chip_smoke.k2_bound_terms``);
* K1, which runs the one-level sweep of the parent K2, timed on all the
  rays of each mode's sweeps: the sweeps' time without the shading;
* from the counting build of the first DIR (``PSDR_K2_COUNTS``, see
  ``k2_kernel_counts``), on every launch: the warps that make each sweep,
  the lanes whose hit is used, and the box and (ray, triangle) tests the
  warps run, a lane a sweep.

Other sizes of K2's culling runs are copies with another ``kGroup`` in
``megakernel.cu``.

A build that exports ``psdr_diag_hits(ids, u, v)`` (a diagnostic copy)
is handed, before each launch, the plain version's hits of the launch's
sweeps, ``(rows, N)`` int32 and float32 device arrays in the recorder's
order (pair mode: ray_n's rows, then ray_p's), so that it can take its
hits from there instead of sweeping.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
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


def in_turns(srcs, run) -> dict:
    """``{src: [result of run(src) in each of four rounds]}``, the builds
    in turns: forward, backward, forward, backward."""
    times = {src: [] for src in srcs}
    for rnd in range(4):
        for src in (srcs if rnd % 2 == 0 else srcs[::-1]):
            with kernels_of(src):
                times[src].append(run(src))
    return times


def sass_counts(lib: Path, kernel: str) -> str:
    """SASS instructions of each compiled function whose name holds
    ``kernel`` in the library ``lib`` (``cuobjdump -sass``)."""
    import re
    import subprocess

    from psdr_jit_tpu_torch.ops import _cuda

    cuobjdump = Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    out, name = [], None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            if kernel in name:
                out.append([name[-24:], 0])
            continue
        if name and kernel in name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
            out[-1][1] += 1
    return ",".join(f"{n}:{c}" for n, c in out)


def ptxas_of(srcs, kernel: str):
    import chip_smoke as cs
    from psdr_jit_tpu_torch.ops import _cuda

    for src in srcs:
        _cuda.library(src)
        lib = _cuda.build(src)
        report = (lib.parent / "ptxas.txt").read_text()
        print(f"{src}: ptxas (template:registers/stack/spill stores+loads) "
              f"{cs.ptxas_report(kernel, report)}; SASS instructions "
              f"{sass_counts(lib, kernel)}", flush=True)


def k4(srcs) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    ptxas_of(srcs, "shade_bwd_kernel")
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
    times = in_turns(srcs, lambda src: cs.cuda_ms(
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


K2_WRAPPERS = {"single": "li_mega_cuda", "pair": "li_mega_pair_cuda",
               "stash": "li_mega_stash_cuda"}
K2_PLAIN = {"single": "li_mega_plain", "pair": "li_mega_pair_plain",
            "stash": "li_mega_stash_plain"}


def k2_sweep_counts(mode, args, record):
    """The lanes each sweep of a launch's ``record`` is used for, and the
    (ray, triangle) tests a lane a sweep any hierarchy of boxes needs."""
    import chip_smoke as cs

    used = ", ".join(f"{float(s.active.float().mean()):.4f}" for s in record)
    tests = cs.k2_bound_terms(args, record, mode == "pair",
                              mode == "stash")[2]
    print(f"[K2 {mode}] lanes used a sweep {used}; tests a lane a sweep "
          f"needed {tests / len(record) / args[5].shape[0]:.2f}",
          flush=True)


K2_DEPTH_ARG = {"single": 10, "pair": 12, "stash": 10}


def k2_kernel_counts(src: Path, calls) -> None:
    """K2's own counts on every recorded launch, from its counting build: a
    copy of ``src`` under the package's ignored ``build/`` with
    ``PSDR_K2_COUNTS`` defined at the top of ``megakernel.cu`` (its sweeps
    tally what the warps run, ``csrc/sweep.cuh`` ``Tally``; its outputs
    must equal the package's). Prints, for each mode and each sweep of a
    path (camera, then NEE and bounce of each depth), the share of warps
    that make it, the share of threads whose hit is used, and the box and
    (ray, triangle) tests the warps run a thread (a thread is a lane in
    single and stash mode and one of a lane's two rays in pair mode), then
    the tests a thread a sweep over all of a path's sweeps."""
    import shutil

    import torch

    from psdr_jit_tpu_torch.ops import _cuda

    copy = _cuda.BUILD_ROOT / "k2_counting_src"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(src, copy)
    mega = copy / "megakernel.cu"
    mega.write_text("#define PSDR_K2_COUNTS 1\n" + mega.read_text())
    lib = _cuda.library(copy)
    lib.psdr_k2_counts.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * 64)()

    def read():
        _cuda.check(lib.psdr_k2_counts(ctypes.addressof(sums)), "K2 counts")
        return torch.tensor(list(sums), dtype=torch.float64).reshape(16, 4)

    def leaves(x):
        return ([x] if isinstance(x, torch.Tensor)
                else [y for z in x for y in leaves(z)])

    def row(x):
        return " ".join(f"{float(v):.3f}" for v in x)

    with kernels_of(copy):
        for mode, launches in calls.items():
            read()
            err = 0.0
            threads = 0
            for fn, args, ref in launches:
                for a, b in zip(leaves(fn(*args)), leaves(ref)):
                    err = max(err, float((a.float() - b.float()).abs().max()))
                threads += args[5].shape[0] * (2 if mode == "pair" else 1)
            c = read()[:1 + 2 * args[K2_DEPTH_ARG[mode]]]
            box, tri = 32 * c[:, 2] / threads, 32 * c[:, 3] / threads
            print(f"[K2 {mode} counting build] max abs diff vs the package's "
                  f"{err:.3e}; threads {threads}; by sweep: warps making it "
                  f"{row(c[:, 0] / -(-threads // 32))}; threads used "
                  f"{row(c[:, 1] / threads)}; box tests a thread {row(box)}; "
                  f"tests a thread {row(tri)}; a thread a sweep: box tests "
                  f"{float(box.mean()):.2f}, tests {float(tri.mean()):.2f}",
                  flush=True)


def k2(srcs) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import megakernel as mk

    ptxas_of(srcs, "li_mega_kernel")
    library = _cuda.library  # the builds by source, while kernels_of swaps it
    dev = torch.device("cuda:0")
    integ = pt.PathTracer(cs.DEPTH)
    scene = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    with cs.KernelCalls({"single": (mk, K2_WRAPPERS["single"])}) as rec:
        integ.renderC(scene, 0, seed=cs.SEED)
        torch.cuda.synchronize()
    calls = {"single": rec.calls["single"]}
    train = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    train.opts.sppe = cs.SPPE
    step = cs.train_step_fn(integ, train)
    with cs.KernelCalls({m: (mk, K2_WRAPPERS[m])
                         for m in ("pair", "stash")}) as rec:
        step()
        torch.cuda.synchronize()
    calls.update(rec.calls)
    hits = {}
    for mode, launches in calls.items():
        print(f"K2 {mode}: {len(launches)} launches, lanes "
              f"{[a[5].shape[0] for _, a, _ in launches]}", flush=True)
        for j, (_, args, _) in enumerate(launches):
            record = []
            getattr(mk, K2_PLAIN[mode])(*args, record=record)
            hits[mode, j] = tuple(torch.stack(x).contiguous() for x in zip(
                *((s.id, s.u, s.v) for s in record)))
            if j == 0:
                k2_sweep_counts(mode, args, record)
            o = torch.cat([s.o for s in record]).contiguous()
            d = torch.cat([s.d for s in record]).contiguous()
            ms = cs.cuda_ms(lambda: ix.intersect_cuda(args[0], args[1], o, d),
                            3)
            print(f"[K2 {mode}] launch {j}: K1 on its {o.shape[0]} sweep "
                  f"rays {ms:.3f} ms", flush=True)
            del record, o, d

    def launch(src, mode, j, fn, args):
        lib = library(src)
        if hasattr(lib, "psdr_diag_hits"):
            lib.psdr_diag_hits.argtypes = [ctypes.c_void_p] * 3
            lib.psdr_diag_hits(*(x.data_ptr() for x in hits[mode, j]))
        return fn(*args)

    for src in srcs:
        with kernels_of(src):
            for mode, launches in calls.items():
                err = off = 0
                for j, (fn, args, ref) in enumerate(launches):
                    got = launch(src, mode, j, fn, args)
                    if mode == "stash":
                        (got, gh), (ref, rh) = got, ref
                        same = gh[0] == rh[0]
                        off += int((~same).sum()) + sum(
                            int((a[same] != b[same]).sum())
                            for a, b in zip(gh[1:], rh[1:]))
                    err = max(err, float((got - ref).abs().max()))
                print(f"{src}: {mode} max abs diff vs the package's K2 "
                      f"{err:.3e}" + (f", hits off {off}" if mode == "stash"
                                      else ""), flush=True)

    def run(src):
        return {mode: sum(cs.cuda_ms(lambda: launch(src, mode, j, fn, args),
                                     3)
                          for j, (fn, args, _) in enumerate(launches))
                for mode, launches in calls.items()}

    times = in_turns(srcs, run)
    for src, ts in times.items():
        for mode in calls:
            unit = "frame" if mode == "single" else "step"
            print(f"{src}: {mode} ms a {unit} "
                  + " ".join(f"{t[mode]:.3f}" for t in ts))
    k2_kernel_counts(srcs[0], calls)
    return 0


def main() -> int:
    import torch

    import chip_smoke as cs

    if len(sys.argv) < 3 or sys.argv[1] not in ("K2", "K4"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device visible", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    srcs = [Path(x).resolve() for x in sys.argv[2:]]
    return (k2 if sys.argv[1] == "K2" else k4)(srcs)


if __name__ == "__main__":
    sys.exit(main())
