#!/usr/bin/env python3
"""K1, K2, K3, K4 or K5 built from other sources, timed on one CUDA card
on the main paths' own inputs.

    python3 scripts/torch_kernel_variants.py K2|K3|K4 DIR [DIR ...]
    python3 scripts/torch_kernel_variants.py K1|K5 [--parent PDIR] DIR [DIR ...]

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

K1: its ray families (``chip_smoke.k1_families``: (a) pixel-centre
picks, (b) camera rays, (c) rays on cluster-box planes, (d) random rays,
(e) the secondary-edge stand-ins with their dead lanes, and also with
every lane active; the check set, (a)-(d) in one launch) at 32 triangles
(the Cornell box) and 492 (``chip_smoke.K1_GALLERY``), each family alone,
through: the parent's K1 with ``--parent`` (``intersect.cu`` of a parent
checkout's ``csrc``, the one-level sweep of 16-triangle clusters, built
alone; a dead lane sweeps the ray the parent's routing gave it); K2's two
sweeps with runs of 2 over K2's staged float4 table (``sweep_grouped`` and
``sweep_queued`` of the first DIR's ``sweep.cuh``, launched one ray a
thread by a kernel this script writes, ``K1_SWEEP_CU``, with no packing of
the active rays); and each DIR's K1 sweep (``intersect.sweep_cuda``) and
walk (``bvh.walk_cuda``) on area-split trees (``bvh.build_sah_bvh``) with
leaves of at most 1, 2 and 4. Then, on the galleries of 92 to 412 triangles,
where the walk overtakes the sweeps (``k1_crossover``). It prints each one's agreement with the plain
version (bit for bit), its ms in four rounds in turns, the (ray, triangle)
and box tests a ray (the sweeps' counting build, ``PSDR_K2_COUNTS``; the
walk's; the parent's plain model, ``sweep_grouped_plain`` at ``CLUSTER``),
the tests any hierarchy of boxes needs (``chip_smoke.triangle_box_tests``),
ptxas's registers and spills of each, and the trees' host build time.

K5: the five launches of a ``PathTracer(2).renderC`` frame of the
1,292- and of the 3,852-triangle gallery (``gallery_arrays(256, 256, 4,
n, 2)``, n = 4 and 12 spheres), each DIR's K5 (its ``bvh.cu`` walk) on
trees split by surface area (``bvh.build_sah_bvh``, K5's, at most
``bvh.STACK`` deep) with leaves of at most 1, 2, 4 and 8, beside K6 as it
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
* K1 (up to 192 triangles K2's queued sweep, one ray a thread), timed on
  all the rays of each mode's sweeps: the sweeps' time without the
  shading;
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

    ptxas_of(srcs, "walk_kernel")
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
            tri.p0, tri.e1, tri.e2, leaf) for leaf in (1, 2, 4, 8)})
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
            act = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
            ms = cs.cuda_ms(lambda: ix.sweep_cuda(args[0], args[1], o, d,
                                                  act), 3)
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


# K2's two sweeps on K1's rays (the K1 mode's sweep variants): a closest
# hit of N rays over K2's staged float4 table, one ray a thread, all 32
# lanes of a warp sweeping together (sweep.cuh sweep_grouped and
# sweep_queued with runs of 2), in a persistent grid of 256-thread blocks
# that stage the table once, as K2 does. Built by k1_sweep_variants from
# the sweep.cuh of a source directory; PSDR_K2_COUNTS makes its counting
# build, which writes each lane's warp's (ray, triangle) and box tests.
K1_SWEEP_CU = r"""
#include "sweep.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kG = 2;

__device__ __forceinline__ void store(const psdr::Hit& h, long long i, float* t,
                                      int* id, float* uv) {
  t[i] = h.t;
  id[i] = h.id;
  uv[2 * i] = h.u;
  uv[2 * i + 1] = h.v;
}

template <int kMode>  // 0: sweep_grouped, 1: sweep_queued
__global__ void __launch_bounds__(kThreads)
    k1_sweep_kernel(const float* __restrict__ tri_g, const float* __restrict__ box_g,
                    int f_pad, const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d, const bool* __restrict__ active,
                    long long n, float* __restrict__ out_t, int* __restrict__ out_id,
                    float* __restrict__ out_uv, int* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  const int nc = f_pad / psdr::kCluster;
  auto* s_queue = reinterpret_cast<psdr::WarpQueue*>(smem4);
  float4* s_tri = reinterpret_cast<float4*>(s_queue + kThreads / psdr::kWarp);
  float4* s_cbox = s_tri + 3 * f_pad;
  float4* s_gbox = s_cbox + 2 * nc;
  float* rows = reinterpret_cast<float*>(s_tri);
  for (int k = threadIdx.x; k < 12 * f_pad; k += blockDim.x) {
    const int j = k / 12, q = k % 12;
    rows[k] = q < 9 ? tri_g[q * f_pad + j] : 0.0f;
  }
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    float lo[3], hi[3];
    for (int q = 0; q < 3; ++q) {
      lo[q] = box_g[q * nc + k];
      hi[q] = box_g[(3 + q) * nc + k];
      const float m = psdr::box_margin(lo[q], hi[q]);
      lo[q] -= m;
      hi[q] += m;
    }
    s_cbox[2 * k] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    s_cbox[2 * k + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < f_pad / kG; k += blockDim.x)
    psdr::row_box(s_tri, k * kG, kG, s_gbox + 2 * k);
  __syncthreads();
  psdr::WarpQueue& q = s_queue[threadIdx.x / psdr::kWarp];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w0 = static_cast<long long>(blockIdx.x) * blockDim.x; w0 < n;
       w0 += stride) {
    const long long i = w0 + threadIdx.x;
    const bool live = i < n;
    const bool need = live && active[i];
    const float ox = live ? ray_o[3 * i] : 0.0f, oy = live ? ray_o[3 * i + 1] : 0.0f,
                oz = live ? ray_o[3 * i + 2] : 0.0f;
    const float dx = live ? ray_d[3 * i] : 0.0f, dy = live ? ray_d[3 * i + 1] : 0.0f,
                dz = live ? ray_d[3 * i + 2] : 1.0f;
    psdr::Tally tally;
    const psdr::Hit h =
        kMode == 0 ? psdr::sweep_grouped<kG>(s_tri, s_cbox, s_gbox, nc, need, ox, oy, oz,
                                             dx, dy, dz, tally)
                   : psdr::sweep_queued<kG>(s_tri, s_cbox, s_gbox, nc, q, need, ox, oy,
                                            oz, dx, dy, dz, tally);
    if (live) {
      store(h, i, out_t, out_id, out_uv);
      if (counts != nullptr) {
        counts[2 * i] = static_cast<int>(tally.tri);
        counts[2 * i + 1] = static_cast<int>(tally.box);
      }
    }
  }
}
}  // namespace

extern "C" int psdr_k1_sweep(int mode, const float* tri, const float* box, int f_pad,
                             const float* ray_o, const float* ray_d, const bool* active,
                             long long n, float* t, int* id, float* uv, int* counts,
                             void* stream) {
  const int nc = f_pad / psdr::kCluster;
  const size_t smem = sizeof(psdr::WarpQueue) * (kThreads / psdr::kWarp) +
                      sizeof(float4) * (3 * f_pad + 2 * nc + 2 * (f_pad / kG));
  auto kernel = mode == 0 ? k1_sweep_kernel<0> : k1_sweep_kernel<1>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(needed < most ? needed : most);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, box, f_pad, ray_o, ray_d, active, n, t, id, uv, counts);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_alone(name: str, source: Path, include: Path, defines=(),
                kernel: str = ""):
    """``source`` compiled alone with the package's flags (``-I include``)
    into a library under the package's ignored ``build/<name>``; prints
    ptxas's registers and spills of ``kernel`` and returns the loaded
    library."""
    import subprocess

    import chip_smoke as cs
    from psdr_jit_tpu_torch.ops import _cuda

    out = _cuda.BUILD_ROOT / name
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defines,
                           "-I", str(include), "-shared", "-o", str(lib),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    if kernel:
        print(f"{name}: ptxas {cs.ptxas_report(kernel, proc.stdout + proc.stderr)}",
              flush=True)
    return ctypes.CDLL(str(lib))


def k1_sweep_variants(src: Path):
    """K2's sweeps on K1's rays (``K1_SWEEP_CU`` over ``src``'s
    ``sweep.cuh``): ``(timing library, counting library)``."""
    from psdr_jit_tpu_torch.ops import _cuda

    gen = _cuda.BUILD_ROOT / "k1_sweep_src"
    gen.mkdir(parents=True, exist_ok=True)
    cu = gen / "k1_sweep.cu"
    cu.write_text(K1_SWEEP_CU)
    libs = [build_alone(name, cu, src, defines, "k1_sweep_kernel")
            for name, defines in (("k1_sweep", ()),
                                  ("k1_sweep_counting",
                                   ("-DPSDR_K2_COUNTS=1",)))]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs:
        lib.psdr_k1_sweep.argtypes = [i, p, p, i, p, p, p, ll, p, p, p, p, p]
        lib.psdr_k1_sweep.restype = i
    return libs


def parent_k1(parent: Path):
    """The parent's K1 (``intersect.cu`` of the ``csrc`` at ``parent``: the
    one-level cluster sweep of ``psdr::sweep``, one thread a ray, with no
    active input), built alone, with its C entry's argument types."""
    lib = build_alone("parent_k1", parent / "intersect.cu", parent,
                      kernel="intersect_kernel")
    fn = lib.psdr_intersect
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, i, p, p, ll, p, p, p, p]
    fn.restype = i
    return fn


def k1(srcs, parent) -> int:
    """K1's diagnosis and its variants on its ray families at 32 and 492
    triangles (module docstring)."""
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    ptxas_of(srcs, "walk_kernel")
    sweep_libs = k1_sweep_variants(srcs[0])
    parent_fn = None if parent is None else parent_k1(parent)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    scenes = {"cbox": pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev),
              "gallery": pt.Scene.from_arrays(
                  cs.gallery_arrays(**cs.K1_GALLERY), device=dev)}
    for size, sc in scenes.items():
        sd = sc.configure()
        tri = sd.tri
        f = tri.p0.shape[0]
        tab, box = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
        fams = cs.k1_families(sd, gen, dev)
        fams["edge_all_active"] = (*fams["edge"][:2],
                                   torch.ones_like(fams["edge"][2]))
        fams["check_set"] = tuple(torch.cat([fams[k][j] for k in (
            "picks", "camera", "on_plane", "random")]).contiguous()
            for j in range(3))
        trees, build_ms = {}, {}
        for leaf in (1, 2, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trees[leaf] = bvh.build_sah_bvh(tri.p0, tri.e1, tri.e2, leaf)
            torch.cuda.synchronize()
            build_ms[leaf] = (time.perf_counter() - t0) * 1e3
        print(f"[K1 {size}] {f} triangles; area-split tree build ms (host): "
              + ", ".join(f"leaves <= {k}: {v:.2f} (depth "
                          f"{trees[k].depth}, {trees[k].node.shape[0]} nodes)"
                          for k, v in build_ms.items()), flush=True)

        def out3(n):
            return (torch.empty(n, device=dev),
                    torch.empty(n, dtype=torch.int32, device=dev),
                    torch.empty((n, 2), device=dev))

        def parent_run(o, d, a):
            # no active input: the parent's routing hands a dead lane a ray
            # from the origin along +z (the rays come substituted, below)
            t, ids, uv = out3(o.shape[0])
            _cuda.check(parent_fn(tab.data_ptr(), box.data_ptr(),
                                  tab.shape[1], o.data_ptr(), d.data_ptr(),
                                  o.shape[0], t.data_ptr(), ids.data_ptr(),
                                  uv.data_ptr(), _cuda.stream_of(dev)),
                        "parent K1")
            return t, ids, uv

        def sweep_run(mode, lib=sweep_libs[0], counts=None):
            def run(o, d, a):
                t, ids, uv = out3(o.shape[0])
                _cuda.check(lib.psdr_k1_sweep(
                    mode, tab.data_ptr(), box.data_ptr(), tab.shape[1],
                    o.data_ptr(), d.data_ptr(), a.data_ptr(), o.shape[0],
                    t.data_ptr(), ids.data_ptr(), uv.data_ptr(),
                    None if counts is None else counts.data_ptr(),
                    _cuda.stream_of(dev)), "K1 sweep variant")
                return t, ids, uv
            return run

        cands = {}
        if parent_fn is not None:
            cands["parent K1"] = parent_run
        cands["grouped<2>"] = sweep_run(0)
        cands["queued<2>"] = sweep_run(1)
        for src in srcs:
            def sweep(o, d, a, src=src):
                with kernels_of(src):
                    return ix.sweep_cuda(tab, box, o, d, a)
            cands[f"{src.parent.name}/{src.name} sweep"] = sweep
            for leaf, tree in trees.items():
                def walk(o, d, a, src=src, tree=tree):
                    with kernels_of(src):
                        return bvh.walk_cuda(tree, o, d, a, kernel="K1")
                cands[f"{src.parent.name}/{src.name} walk <= {leaf}"] = walk
        names = list(cands)
        def masked(hits, a):
            return tuple(torch.where(a if x.dim() == 1 else a[:, None], x, m)
                         for x, m in zip(hits, (ix.INF, -1, 0.0)))

        unit_z = torch.tensor([0.0, 0.0, 1.0], device=dev)
        for fam, (o, d, a) in fams.items():
            n = o.shape[0]
            args = {name: (o, d, a) for name in names}
            if parent_fn is not None:
                args["parent K1"] = (
                    torch.where(a[:, None], o, 0.0).contiguous(),
                    torch.where(a[:, None], d, unit_z).contiguous(), a)
            ref = ix.sweep_plain(tab, o.unbind(-1), d.unbind(-1))
            ref = masked((ref[0], ref[1], torch.stack(ref[2:], -1)), a)
            need = cs.triangle_box_tests(tri.p0, tri.e1, tri.e2, o, d,
                                         ref[0], a)
            stats = {}
            ix.sweep_grouped_plain(tab, o.unbind(-1), d.unbind(-1),
                                   ix.CLUSTER, stats, live=a)
            live = int(a.sum())
            print(f"[K1 {size} {fam}] {n} rays, {live} active; needed tests "
                  f"a ray {need / n:.2f}; parent (plain model): tests a ray "
                  f"{stats['tri_tests'] / n:.2f}, its warps' "
                  f"{32 * stats['warp_tri_tests'] / n:.2f}, box tests a ray "
                  f"{tab.shape[1] // ix.CLUSTER}", flush=True)
            for name in names:
                got = masked(cands[name](*args[name]), a)
                same = all(torch.equal(x, y) for x, y in zip(got, ref))
                print(f"[K1 {size} {fam}] {name}: bitwise equal to the plain "
                      f"version {same}", flush=True)
            for mode, name in ((0, "grouped<2>"), (1, "queued<2>")):
                c = torch.zeros((n, 2), dtype=torch.int32, device=dev)
                sweep_run(mode, sweep_libs[1], c)(o, d, a)
                tests, boxes = c.sum(0).tolist()
                print(f"[K1 {size} {fam}] {name} counting build: tests a ray "
                      f"{tests / n:.2f}, box tests a ray {boxes / n:.2f}",
                      flush=True)
            for leaf, tree in trees.items():
                c = torch.zeros((n, 2), dtype=torch.int32, device=dev)
                with kernels_of(srcs[0]):
                    bvh.walk_cuda(tree, o, d, a, counts=c, kernel="K1")
                tests, visits = c.sum(0).tolist()
                print(f"[K1 {size} {fam}] walk <= {leaf} counting build: "
                      f"tests a ray {tests / n:.2f}, node visits a ray "
                      f"{visits / n:.2f}", flush=True)
            times = {name: [] for name in names}
            for rnd in range(4):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    times[name].append(cs.cuda_ms(
                        lambda: cands[name](*args[name]), 10))
            for name, ts in times.items():
                print(f"[K1 {size} {fam}] {name}: ms "
                      + " ".join(f"{t:.4f}" for t in ts), flush=True)
    k1_frame(srcs, dev)
    k1_crossover(srcs[0], sweep_libs[0], dev, gen)
    return 0


def k1_frame(srcs, dev) -> None:
    """Each DIR's walk on the five K1 launches of a ``PathTracer(2).renderC``
    frame of the 492-triangle gallery (``chip_smoke.K1_GALLERY``), recorded
    through the package, bit for bit against the package's and timed a
    frame in four rounds in turns."""
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import bvh

    sc = pt.Scene.from_arrays(cs.gallery_arrays(**cs.K1_GALLERY), device=dev)
    integ = pt.PathTracer(2)
    integ.renderC(sc, 0, seed=0)
    with cs.KernelCalls({"K1": (bvh, "walk_cuda")}) as rec:
        integ.renderC(sc, 0, seed=0)
        torch.cuda.synchronize()
    calls = rec.calls["K1"]
    live = [f"{float(args[3].float().mean()):.3f}" for _, args, _ in calls]
    print(f"[K1 frame] {len(calls)} launches, active share {live}",
          flush=True)
    for src in srcs:
        with kernels_of(src):
            same = all(all(torch.equal(x, y) for x, y in zip(fn(*args), out))
                       for fn, args, out in calls)
        print(f"[K1 frame] {src}: bitwise equal to the package's {same}",
              flush=True)

    def run(src):
        return [cs.cuda_ms(lambda: fn(*args), 10) for fn, args, _ in calls]

    for src, ts in in_turns(srcs, run).items():
        print(f"[K1 frame] {src}: ms a frame "
              + " ".join(f"{sum(t):.4f}" for t in ts) + "; a launch "
              + ",".join(f"{x:.4f}" for x in ts[0]), flush=True)
    # the first DIR's walk on other area-split trees of the same triangles
    tri = sc.data.tri
    saved = bvh.SAH_NODE_COST
    trees = {}
    for leaf, cost in ((2, saved), (1, saved), (2, 0.5), (2, 2.0), (4, 2.0)):
        bvh.SAH_NODE_COST = cost
        trees[f"leaves <= {leaf}, node cost {cost}"] = bvh.build_sah_bvh(
            tri.p0, tri.e1, tri.e2, leaf)
    bvh.SAH_NODE_COST = saved
    names = list(trees)
    times = {name: [] for name in names}
    with kernels_of(srcs[0]):
        for rnd in range(4):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[name].append(sum(cs.cuda_ms(lambda: bvh.walk_cuda(
                    trees[name], *args[1:], kernel="K1"), 10)
                    for _, args, _ in calls))
        for name in names:
            c = [0, 0]
            for _, args, _ in calls:
                k = torch.zeros((args[1].shape[0], 2), dtype=torch.int32,
                                device=dev)
                bvh.walk_cuda(trees[name], *args[1:], counts=k, kernel="K1")
                c = [x + y for x, y in zip(c, k.sum(0).tolist())]
            rays = sum(args[1].shape[0] for _, args, _ in calls)
            print(f"[K1 frame] tree {name} (depth {trees[name].depth}, "
                  f"{trees[name].node.shape[0]} nodes): ms a frame "
                  + " ".join(f"{t:.4f}" for t in times[name])
                  + f"; tests / node visits a ray {c[0] / rays:.2f} / "
                  f"{c[1] / rays:.2f}", flush=True)


def k1_crossover(src: Path, sweep_lib, dev, gen) -> None:
    """Where the walk overtakes K2's sweeps: the check set and the
    secondary-edge stand-ins (with and without their dead lanes) on the
    galleries of 1 to 5 spheres (``gallery_arrays(256, 256, 4, n, 1)``: 92
    to 412 triangles), through ``sweep_grouped<2>``, ``sweep_queued<2>``
    (``K1_SWEEP_CU``), ``src``'s K1 sweep (``sweep_queued<2>`` on the
    packed active rays) and its walk on the area-split tree, each held
    bit for bit against the plain sweep and timed in four rounds in
    turns."""
    import torch

    import chip_smoke as cs
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda, bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    for n_spheres in range(1, 6):
        sd = pt.Scene.from_arrays(cs.gallery_arrays(256, 256, 4, n_spheres, 1),
                                  device=dev).configure()
        tri = sd.tri
        f = tri.p0.shape[0]
        tab, box = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
        tree = ix.routing_tree(tri.p0, tri.e1, tri.e2)
        fams = cs.k1_families(sd, gen, dev)
        check = tuple(torch.cat([fams[k][j] for k in (
            "picks", "camera", "on_plane", "random")]).contiguous()
            for j in range(3))
        eo, ed, ea = fams["edge"]
        runs = {"check_set": check, "edge": (eo, ed, ea),
                "edge_all_active": (eo, ed, torch.ones_like(ea))}

        def sweep(mode):
            def run(o, d, a):
                n = o.shape[0]
                t = torch.empty(n, device=dev)
                ids = torch.empty(n, dtype=torch.int32, device=dev)
                uv = torch.empty((n, 2), device=dev)
                _cuda.check(sweep_lib.psdr_k1_sweep(
                    mode, tab.data_ptr(), box.data_ptr(), tab.shape[1],
                    o.data_ptr(), d.data_ptr(), a.data_ptr(), n,
                    t.data_ptr(), ids.data_ptr(), uv.data_ptr(), None,
                    _cuda.stream_of(dev)), "K1 sweep variant")
                return t, ids, uv
            return run

        def walk(o, d, a):
            with kernels_of(src):
                return bvh.walk_cuda(tree, o, d, a, kernel="K1")

        def k1_sweep(o, d, a):
            with kernels_of(src):
                return ix.sweep_cuda(tab, box, o, d, a)

        cands = {"grouped<2>": sweep(0), "queued<2>": sweep(1),
                 "K1 sweep": k1_sweep, "walk": walk}
        for fam, (o, d, a) in runs.items():
            ref = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2, o, d, a)
            same = {name: all(torch.equal(x, y) for x, y in zip(
                (lambda r: (r[1], r[1] >= 0, r[2], r[0]))(fn(o, d, a)), ref))
                for name, fn in cands.items()}
            times = {name: [] for name in cands}
            names = list(cands)
            for rnd in range(4):
                for name in (names if rnd % 2 == 0 else names[::-1]):
                    times[name].append(cs.cuda_ms(
                        lambda: cands[name](o, d, a), 10))
            print(f"[K1 crossover {f} {fam}] " + "; ".join(
                f"{name}: bitwise {same[name]}, ms "
                + " ".join(f"{t:.4f}" for t in ts)
                for name, ts in times.items()), flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs

    args = sys.argv[2:]
    parent = None
    if args[:1] == ["--parent"] and len(args) > 1:
        parent, args = Path(args[1]).resolve(), args[2:]
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if not args or mode not in ("K1", "K2", "K3", "K4", "K5") or (
            parent is not None and mode not in ("K1", "K5")):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device visible", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    srcs = [Path(x).resolve() for x in args]
    if mode == "K5":
        return k5(srcs, parent)
    if mode == "K1":
        return k1(srcs, parent)
    return {"K2": k2, "K3": k3, "K4": k4}[mode](srcs)


if __name__ == "__main__":
    sys.exit(main())
