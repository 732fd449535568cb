#!/usr/bin/env python3
"""K2, K3, K4 or K5 built from other sources, timed on one CUDA card on
the main paths' own inputs.

    python3 scripts/torch_kernel_variants.py K2|K3|K4 DIR [DIR ...]
    python3 scripts/torch_kernel_variants.py K5 [--parent PDIR] DIR [DIR ...]

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

K3: the two launches of that step, with the same rows a warp, each
build's commonest SASS opcodes, and the lanes (and 32-lane warps) whose
path is still alive at each depth, by its stashed hits (a valid camera
hit and valid bounce hits so far; the kernel's own rule adds ``wi_z >
0``, so these are upper bounds), and of them those whose NEE shadow ray
hit an emitter.

K5: the five launches of a ``PathTracer(2).renderC`` frame of the
1,292- and of the 3,852-triangle gallery (``gallery_arrays(256, 256, 4,
n, 2)``, n = 4 and 12 spheres), each DIR's K5 (its ``bvh.cu`` walk) on
trees split by surface area (``bvh.build_sah_bvh``, K5's, at most
``bvh.STACK`` deep) with leaves of at most 2, 4 and 8, beside K6 as it
is (the package's, on its own tree, leaves of 4 split at the middle)
and, with ``--parent``, the K5 of a parent checkout's ``csrc`` (PDIR),
which swept 512-triangle super-blocks of a packed table (built alone from
its ``intersect_super.cu``, its C interface called here directly). It
prints the (ray, triangle) tests a ray of each: counted for K5 and K6 by
the walk's counting build, for the parent by the plain sweep that visits
as it did (``sweep_grouped_plain`` at ``CLUSTER``: a ray's own clusters
against its running hit, in id order); the tests any hierarchy of boxes
needs (``chip_smoke.triangle_box_tests``); ptxas's registers and spills.

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


def sass_ops(lib: Path, kernel: str, top: int = 12) -> str:
    """The commonest SASS opcodes (without modifiers) of the compiled
    functions whose name holds ``kernel`` in ``lib``, with their counts."""
    import collections
    import re
    import subprocess

    from psdr_jit_tpu_torch.ops import _cuda

    cuobjdump = Path(_cuda._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    ops, name = collections.Counter(), None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", ln)
        if name and kernel in name and m:
            ops[m.group(1)] += 1
    return " ".join(f"{op}:{n}" for op, n in ops.most_common(top))


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


def warp_rows(ids):
    """For each hit row of the stashed ``ids`` (rows, N): the distinct
    table rows a 32-lane warp reads, and the share of warps reading one."""
    warps = ids[:, :ids.shape[1] // 32 * 32].reshape(ids.shape[0], -1, 32)
    rows = (warps.sort(-1).values.diff(dim=-1) != 0).sum(-1) + 1
    for k in range(ids.shape[0]):
        print(f"hit {k}: distinct rows a warp, mean "
              f"{rows[k].float().mean():.3f}, one-row warps "
              f"{(rows[k] == 1).float().mean():.3f}")


def k3(srcs) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    ptxas_of(srcs, "shade_fwd_kernel")
    from psdr_jit_tpu_torch.ops import _cuda

    for src in srcs:
        ops = sass_ops(_cuda.build(src), "shade_fwd_kernel")
        print(f"{src}: SASS opcodes {ops}", flush=True)
    dev = torch.device("cuda:0")
    scene = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    scene.opts.sppe = cs.SPPE
    step = cs.train_step_fn(pt.PathTracer(cs.DEPTH), scene)
    with cs.KernelCalls({"K3": (sm, "shade_cuda")}) as rec:
        step()
        torch.cuda.synchronize()
    calls = [args for _, args, _ in rec.calls["K3"]]
    ref = [out for _, _, out in rec.calls["K3"]]
    print(f"K3 launches in a step: {len(calls)}, lanes "
          f"{[a[6].shape[0] for a in calls]}", flush=True)
    for src in srcs:
        with kernels_of(src):
            got = [sm.shade_cuda(*a) for a in calls]
        rel = max(cs.rel_l1(g, r) for g, r in zip(got, ref))
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        print(f"{src}: rel L1 vs the package's K3 {rel:.3e}, max abs "
              f"{err:.3e}", flush=True)
    times = in_turns(srcs, lambda src: cs.cuda_ms(
        lambda: [sm.shade_cuda(*a) for a in calls], 10))
    for src, ts in times.items():
        print(f"{src}: ms a step " + " ".join(f"{t:.3f}" for t in ts))
    table, ids, act = calls[0][0], calls[0][3], calls[0][8]
    live = act & (ids[0] >= 0)
    n = live.shape[0] // 32 * 32
    for k in range(cs.DEPTH):
        warps = live[:n].reshape(-1, 32).any(1)
        nee = ids[1 + 2 * k]
        lit = live & (nee >= 0) & (table[nee.clamp(min=0).long(),
                                         sm.ROW_ISEM] > 0.5)
        print(f"depth {k + 1}: live lanes {live.float().mean():.4f}, warps "
              f"with a live lane {warps.float().mean():.4f}; NEE hit an "
              f"emitter: lanes {lit.float().mean():.4f}, warps with one "
              f"{lit[:n].reshape(-1, 32).any(1).float().mean():.4f}")
        live = live & (ids[2 + 2 * k] >= 0)
    warp_rows(ids)
    return 0


def parent_k5(parent: Path):
    """The parent's K5 (``intersect_super.cu`` of the ``csrc`` at
    ``parent``, which streamed 512-triangle super-blocks of a packed
    table), built alone into the package's ignored ``build/``, with its C
    entry's argument types; prints ptxas's registers and spills."""
    import subprocess

    import chip_smoke as cs
    from psdr_jit_tpu_torch.ops import _cuda

    out = _cuda.BUILD_ROOT / "parent_k5"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_k5.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                           str(lib), str(parent / "intersect_super.cu")],
                          capture_output=True, text=True, check=True)
    regs = cs.ptxas_report("intersect_super_kernel", proc.stdout + proc.stderr)
    print(f"parent K5: ptxas {regs}", flush=True)
    fn = ctypes.CDLL(str(lib)).psdr_intersect_super
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, p, p, ll, p, p, p, p]
    fn.restype = i
    return fn


def k5(srcs, parent) -> int:
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    ptxas_of(srcs, "bvh_kernel")
    parent_fn = None if parent is None else parent_k5(parent)
    dev = torch.device("cuda:0")
    integ = pt.PathTracer(2)
    for n_spheres in (4, 12):
        sc = pt.Scene.from_arrays(cs.gallery_arrays(256, 256, 4, n_spheres, 2),
                                  device=dev)
        sd = sc.configure()
        tri = sd.tri
        with cs.KernelCalls({"K5": (bvh, "walk_cuda")}) as rec:
            integ.renderC(sc, 0, seed=0)
            torch.cuda.synchronize()
        calls = rec.calls["K5"]
        f = tri.p0.shape[0]
        rays = sum(args[1].shape[0] for _, args, _ in calls)
        print(f"[K5 {f} triangles] {len(calls)} launches, {rays} rays",
              flush=True)
        trees = {"mid leaf 4": bvh.build_bvh(tri.p0, tri.e1, tri.e2)}
        trees.update({f"sah leaf <={leaf}": bvh.build_sah_bvh(
            tri.p0, tri.e1, tri.e2, leaf) for leaf in (2, 4, 8)})
        pad = tri.p0.new_zeros((-f % 512, 3))  # whole super-blocks
        tab, box = ix.pack_triangles(*(torch.cat([x, pad]) for x in (
            tri.p0, tri.e1, tri.e2)))

        def parent_run(o, d, act):
            n = o.shape[0]
            t = torch.empty(n, device=dev)
            ids = torch.empty(n, dtype=torch.int32, device=dev)
            uv = torch.empty((n, 2), device=dev)
            _cuda.check(parent_fn(
                tab.data_ptr(), box.data_ptr(), tab.shape[1], o.data_ptr(),
                d.data_ptr(), act.data_ptr(), n, t.data_ptr(),
                ids.data_ptr(), uv.data_ptr(), _cuda.stream_of(dev)),
                "parent K5")
            return t, ids, uv

        cands = {"K6 as is (mid leaf 4)": lambda o, d, a: bvh.walk_cuda(
            trees["mid leaf 4"], o, d, a)}
        if parent_fn is not None:
            cands["parent K5"] = parent_run
        for src in srcs:
            for tree in list(trees)[1:]:
                def run(o, d, a, src=src, tree=tree):
                    with kernels_of(src):
                        return bvh.walk_cuda(trees[tree], o, d, a,
                                             kernel="K5")
                cands[f"{src} {tree}"] = run
        for name, fn in cands.items():
            same = all(all(torch.equal(x, y) for x, y in zip(
                fn(*args[1:]), out)) for _, args, out in calls)
            print(f"[K5 {f}] {name}: bitwise equal to the package's "
                  f"{same}", flush=True)
        names = list(cands)
        times = {name: [] for name in names}
        for rnd in range(4):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[name].append(sum(cs.cuda_ms(
                    lambda: cands[name](*args[1:]), 5)
                    for _, args, _ in calls))
        for name, ts in times.items():
            print(f"[K5 {f}] {name}: ms a frame "
                  + " ".join(f"{t:.4f}" for t in ts), flush=True)
        need = sum(cs.triangle_box_tests(tri.p0, tri.e1, tri.e2, *args[1:3],
                                         out[0], args[3])
                   for _, args, out in calls)
        for name, tree in trees.items():
            counted = [0, 0]
            for _, args, _ in calls:
                c = torch.zeros((args[1].shape[0], 2), dtype=torch.int32,
                                device=dev)
                with kernels_of(srcs[0]):
                    bvh.walk_cuda(tree, *args[1:], counts=c)
                counted = [x + y for x, y in zip(counted, c.sum(0).tolist())]
            print(f"[K5 {f}] {name}, depth {tree.depth}, "
                  f"{tree.node.shape[0]} nodes: tests / node visits a ray "
                  f"{counted[0] / rays:.2f} / {counted[1] / rays:.2f}",
                  flush=True)
        stats = {}
        for _, args, _ in calls:
            o, d, act = args[1:]
            ix.sweep_grouped_plain(tab, o.unbind(-1), d.unbind(-1),
                                   ix.CLUSTER, stats, live=act)
        print(f"[K5 {f}] tests a ray: parent (its visits, plain) "
              f"{stats['tri_tests'] / rays:.2f}, needed by any hierarchy "
              f"{need / rays:.2f}", flush=True)
    return 0


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
    warp_rows(calls[0][3])
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

    args = sys.argv[2:]
    parent = None
    if args[:1] == ["--parent"] and len(args) > 1:
        parent, args = Path(args[1]).resolve(), args[2:]
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if not args or mode not in ("K2", "K3", "K4", "K5") or (
            parent is not None and mode != "K5"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device visible", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    srcs = [Path(x).resolve() for x in args]
    if mode == "K5":
        return k5(srcs, parent)
    return {"K2": k2, "K3": k3, "K4": k4}[mode](srcs)


if __name__ == "__main__":
    sys.exit(main())
