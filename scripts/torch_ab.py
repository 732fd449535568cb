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
* the 1,292- and 3,852-triangle galleries (``gallery_arrays(256, 256, 4,
  n_spheres, 2)`` with 4 and 12 spheres, ``PathTracer(2).renderC``): the
  frame's host time and peak memory, K5 alone on each of the frame's
  launches, and K6 as it is (its own tree, leaves of ``bvh.LEAF``) on the
  same rays;
* the Cornell-box frame of ``chip_smoke.py`` (512x512, spp 32,
  ``PathTracer(3).renderC``): its host time (median of 5) and peak device
  memory, and K2 (single mode) alone on the frame's launch;
* the Cornell-box training step of ``chip_smoke.py`` (512x512, spp 32,
  sppe 32, ``PathTracer(3).loss_and_grad``): its host time (median of 3)
  and peak device memory, and K3, K4, K2 stash and K2 pair alone on each
  of the step's launches;
* K1 alone on its launches (``k1_lines``): the Cornell box's check set,
  the secondary-edge stand-ins with and without their dead lanes, and the
  five launches of a frame of the 492-triangle gallery, with that frame's
  host time and, where K1 walks a tree, the tree's host build;
* the device operations (kernels, copies, fills) that one host frame of
  each gallery, one Cornell-box frame and one step issue, and their summed
  device time (``torch.profiler``): the launches and the device's share
  behind a host-bound frame's time;
* ptxas's registers, stack and spills of K1 (before its redesign; since,
  K1, K5 and K6 are one walk), K2, K3, K4, K5 (before its redesign) and K6
  from the checkout's build;
* K6's own (ray, triangle) tests per ray: from its counting build where it
  has one, else (the block/cluster hierarchy it replaced) the 64-triangle
  clusters its rays enter before their hits, times 64.

The tests that any hierarchy of boxes must make (``chip_smoke``
``triangle_box_tests``) and the bytes any closest hit must move (the rays,
and ``TRI_BYTES`` a triangle) depend on the rays, hits and triangles only,
so one count, and one bound, serves both checkouts, for K5 and K6 alike
(``chip_smoke.hit_bound_terms``); it is computed in the B runs. So are
K2's: its bound counts every sweep of each launch
(``chip_smoke.k2_bound_terms`` on the sweeps its plain version records),
with the tests a lane a sweep any hierarchy of boxes needs (from the same
count) and a model of those that K2's one-level sweep of every lane ran
before its redesign (``parent_model_tests``; K2's own counts come from its
counting build, ``torch_kernel_variants.py K2``).

Kernels are timed with this checkout's ``chip_smoke.cuda_ms`` on both
sides, so that the card is held while the host queues the calls.

Imports no JAX; exits non-zero without a CUDA card.
"""

from __future__ import annotations

import functools
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
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    assert Path(pt.__file__).resolve().is_relative_to(tree.resolve())
    dev = torch.device("cuda:0")
    _cuda.library()
    out = {"tree": str(tree), "card": cs.card_line()}
    report = (_cuda.build().parent / "ptxas.txt").read_text()
    out["ptxas"] = {k: _this_smoke().ptxas_report(k, report) for k in (
        "li_mega_kernel", "shade_fwd_kernel", "shade_bwd_kernel",
        "intersect_kernel", "sweep_kernel", "bvh_kernel", "walk_kernel")}

    # ---- K1: the check set, the stand-ins (e), the 492-triangle frame ----
    out.update(k1_lines(cs, pt, dev))

    # ---- the K5 galleries -------------------------------------------------
    for n_spheres in (4, 12):
        out.update(k5_frame(cs, pt, dev, n_spheres))

    # ---- the gallery frame ------------------------------------------------
    big = pt.Scene.from_arrays(cs.gallery_arrays(256, 256, 4), device=dev)
    big.configure()
    integ = pt.PathTracer(2)
    integ.renderC(big, 0, seed=0)
    with cs.KernelCalls({"K6": walk_site(bvh)}) as rec:
        integ.renderC(big, 0, seed=0)
        torch.cuda.synchronize()
    calls = rec.calls["K6"]
    launch_ms = [_this_smoke().cuda_ms(lambda: fn(*args), 5) for fn, args, _ in calls]
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
    device_work(out, "frame", lambda: integ.renderC(big, 0, seed=0))
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(big, 0, seed=0)
    torch.cuda.synchronize()
    out["frame_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    # ---- the Cornell-box frame --------------------------------------------
    cbox = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    integ = pt.PathTracer(cs.DEPTH)
    integ.renderC(cbox, 0, seed=cs.SEED)
    k2 = {"K2": (mk, "li_mega_cuda"), "K2-pair": (mk, "li_mega_pair_cuda"),
          "K2-stash": (mk, "li_mega_stash_cuda")}
    with cs.KernelCalls({"K2": k2["K2"]}) as rec:
        integ.renderC(cbox, 0, seed=cs.SEED)
        torch.cuda.synchronize()
    calls = dict(rec.calls)
    out["K2_frame_ms"] = sum(_this_smoke().cuda_ms(lambda: fn(*args), 5)
                             for fn, args, _ in calls["K2"])
    out["cbox_frame_ms"] = cs.wall_ms(lambda: integ.renderC(
        cbox, 0, seed=cs.SEED), 5)
    device_work(out, "cbox_frame", lambda: integ.renderC(
        cbox, 0, seed=cs.SEED))
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(cbox, 0, seed=cs.SEED)
    torch.cuda.synchronize()
    out["cbox_frame_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    # ---- the training step ------------------------------------------------
    scene = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    scene.opts.sppe = cs.SPPE
    step = cs.train_step_fn(pt.PathTracer(cs.DEPTH), scene)
    step()
    with cs.KernelCalls({"K3": (sm, "shade_cuda"),
                         "K4": (sm, "shade_adjoint_cuda"),
                         "K2-pair": k2["K2-pair"],
                         "K2-stash": k2["K2-stash"]}) as rec:
        step()
        torch.cuda.synchronize()
    calls.update(rec.calls)
    k4 = [_this_smoke().cuda_ms(lambda: fn(*args), 5) for fn, args, _ in rec.calls["K4"]]
    out["K4_launch_ms"] = k4
    out["K4_step_ms"] = sum(k4)
    k3 = [_this_smoke().cuda_ms(lambda: fn(*args), 10) for fn, args, _ in rec.calls["K3"]]
    out["K3_launch_ms"] = k3
    out["K3_step_ms"] = sum(k3)
    for mode in ("K2-pair", "K2-stash"):
        out[f"{mode}_step_ms"] = sum(_this_smoke().cuda_ms(lambda: fn(*args), 5)
                                     for fn, args, _ in calls[mode])
    if hasattr(cs, "k2_bound_terms"):
        out["K2_counts"] = k2_counts(cs, mk, calls)
    out["step_ms"] = cs.wall_ms(step, 3)
    device_work(out, "step", step)
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    torch.cuda.synchronize()
    out["step_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def k1_lines(cs, pt, dev) -> dict:
    """K1 alone on the launches it makes (recorded through the checkout's
    K1 wrappers: ``intersect.intersect_cuda`` before its redesign,
    ``intersect.sweep_cuda`` and ``bvh.walk_cuda`` since): one intersection
    of the Cornell box's check set (rays (a)-(d) of this checkout's
    ``chip_smoke.k1_families``), one of the stand-ins (e) with their dead
    lanes and one with every lane active, and the five of a
    ``PathTracer(2).renderC`` frame of the 492-triangle gallery
    (``K1_GALLERY``), with the frame's host time; where K1 walks a tree
    there, the tree's host build; after the redesign the bounds
    (``hit_bound_terms``) and the needed tests a ray."""
    import numpy as np
    import torch
    from psdr_jit_tpu_torch.ops import bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    smoke = _this_smoke()
    redesigned = not hasattr(ix, "intersect_cuda")
    sites = ({"K1": (ix, "sweep_cuda"), "K1-walk": (bvh, "walk_cuda")}
             if redesigned else {"K1": (ix, "intersect_cuda")})

    def launches(fn):
        with cs.KernelCalls(sites) as rec:
            fn()
            torch.cuda.synchronize()
        return [c for calls in rec.calls.values() for c in calls]

    def timed(calls):
        return sum(smoke.cuda_ms(lambda: fn(*args), 10)
                   for fn, args, _ in calls)

    out = {}
    cbox = pt.Scene.from_arrays(np.load(cs.SCENE_NPZ), device=dev)
    sd = cbox.configure()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    fams = smoke.k1_families(sd, gen, dev)
    check = tuple(torch.cat([fams[k][j] for k in (
        "picks", "camera", "on_plane", "random")]).contiguous()
        for j in range(3))
    eo, ed, ea = fams["edge"]
    for key, (o, d, a) in (("check_set", check), ("edge", (eo, ed, ea)),
                           ("edge_all_active",
                            (eo, ed, torch.ones_like(ea)))):
        sd.ray_intersect(pt.Ray(o, d), a)  # the tree, if any, built first
        calls = launches(lambda: sd.ray_intersect(pt.Ray(o, d), a))
        out[f"K1_{key}_ms"] = timed(calls)
        if redesigned and key == "check_set":
            b, f, t = smoke.hit_bound_terms(sd.tri.p0, sd.tri.e1, sd.tri.e2,
                                            o, d, calls[0][2][0], a)
            out["K1_check_set_bound"] = smoke.bound(b, f)
            out["K1_check_set_needed_tests_per_ray"] = t / o.shape[0]
    gal = pt.Scene.from_arrays(smoke.gallery_arrays(**smoke.K1_GALLERY),
                               device=dev)
    gsd = gal.configure()
    if redesigned:
        tri = gsd.tri
        out["K1_tree_build_ms_492"] = smoke._synced_ms(
            lambda: ix.routing_tree(tri.p0, tri.e1, tri.e2))[1]
    integ = pt.PathTracer(2)
    integ.renderC(gal, 0, seed=0)
    calls = launches(lambda: integ.renderC(gal, 0, seed=0))
    out["K1_492_launches"] = len(calls)
    out["K1_492_frame_ms"] = timed(calls)
    if redesigned:
        nbytes = flops = tests = rays = 0
        tri = gsd.tri
        for _, args, res in calls:
            b, f, t = smoke.hit_bound_terms(tri.p0, tri.e1, tri.e2,
                                            *args[1:3], res[0], args[3])
            nbytes, flops, tests = nbytes + b, flops + f, tests + t
            rays += args[1].shape[0]
        out["K1_492_bound"] = smoke.bound(nbytes, flops)
        out["K1_492_needed_tests_per_ray"] = tests / rays
    out["K1_492_host_frame_ms"] = cs.wall_ms(
        lambda: integ.renderC(gal, 0, seed=0), 5)
    device_work(out, "K1_492_host_frame",
                lambda: integ.renderC(gal, 0, seed=0))
    return out


def k5_frame(cs, pt, dev, n_spheres: int) -> dict:
    """The ``n_spheres`` gallery's frame through K5: host ms and peak
    memory, K5 alone on each launch, K6 as it is on the same rays, and
    (where the checkout's ``chip_smoke`` has ``hit_bound_terms``) the
    bound and the needed tests a ray, keyed ``K5_<F>_...``."""
    import torch
    from psdr_jit_tpu_torch.ops import bvh
    from psdr_jit_tpu_torch.ops import intersect as ix

    sc = pt.Scene.from_arrays(cs.gallery_arrays(256, 256, 4, n_spheres, 2),
                              device=dev)
    sd = sc.configure()
    tri = sd.tri
    key = f"K5_{tri.p0.shape[0]}"
    integ = pt.PathTracer(2)
    integ.renderC(sc, 0, seed=0)
    # before the walk counted its own launches, K5 had a wrapper of its own
    k5_site = ((ix, "intersect_super_cuda")
               if hasattr(ix, "intersect_super_cuda") else (bvh, "walk_cuda"))
    with cs.KernelCalls({"K5": k5_site}) as rec:
        integ.renderC(sc, 0, seed=0)
        torch.cuda.synchronize()
    calls = rec.calls["K5"]
    tree = bvh.build_bvh(tri.p0, tri.e1, tri.e2)
    k6 = getattr(*walk_site(bvh))
    out = {f"{key}_launches": len(calls),
           f"{key}_frame_ms": sum(_this_smoke().cuda_ms(lambda: fn(*args), 5)
                                  for fn, args, _ in calls),
           f"{key}_K6_as_is_frame_ms": sum(
               _this_smoke().cuda_ms(lambda: k6(tree, *args[-3:]), 5)
               for _, args, _ in calls)}
    if hasattr(cs, "hit_bound_terms"):
        nbytes = flops = tests = rays = 0
        for _, args, res in calls:
            b, f, t = cs.hit_bound_terms(tri.p0, tri.e1, tri.e2, *args[-3:-1],
                                         res[0], args[-1])
            nbytes, flops, tests = nbytes + b, flops + f, tests + t
            rays += args[-3].shape[0]
        out[f"{key}_bound"] = cs.bound(nbytes, flops)
        out[f"{key}_needed_tests_per_ray"] = tests / rays
    out[f"{key}_host_frame_ms"] = cs.wall_ms(
        lambda: integ.renderC(sc, 0, seed=0), 5)
    device_work(out, f"{key}_host_frame",
                lambda: integ.renderC(sc, 0, seed=0))
    torch.cuda.reset_peak_memory_stats(dev)
    integ.renderC(sc, 0, seed=0)
    torch.cuda.synchronize()
    out[f"{key}_host_frame_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                        / 1e9)
    return out


def walk_site(bvh):
    """``(module, name)`` of the checkout's K6 wrapper: ``bvh.bvh_cuda``
    before K5 and K6 shared ``bvh.walk_cuda``, which launches as K6 by
    default."""
    return (bvh, "bvh_cuda") if hasattr(bvh, "bvh_cuda") else (bvh,
                                                                "walk_cuda")


def k2_counts(cs, mk, calls) -> dict:
    """K2's bound (ms, by) in each mode, on its launches of the frame or the
    step, and the tests a lane a sweep needed and modelled for the
    one-level sweep (``parent_model_tests``) on those launches, from the
    plain version's record of their sweeps."""
    plain = {"K2": mk.li_mega_plain, "K2-pair": mk.li_mega_pair_plain,
             "K2-stash": mk.li_mega_stash_plain}
    out = {}
    for mode, launches in calls.items():
        if mode not in plain:
            continue
        nbytes = flops = tests = parent = sweeps = 0
        for _, args, _ in launches:
            record = []
            plain[mode](*args, record=record)
            b, f, t = cs.k2_bound_terms(args, record, mode == "K2-pair",
                                        mode == "K2-stash")
            nbytes += b
            flops += f
            tests += t
            parent += parent_model_tests(args[0], record)
            sweeps += len(record) * args[5].shape[0]
        out[f"{mode}_bound"] = cs.bound(nbytes, flops)
        out[f"{mode}_needed_tests"] = tests / sweeps
        out[f"{mode}_parent_model_tests"] = parent / sweeps
    return out


def parent_model_tests(tri, record) -> int:
    """The (ray, triangle) tests that K2 ran before its redesign on the
    sweeps of ``record``, modelled, not counted (that kernel has no
    counting build): its one-level sweep of every lane, one thread a lane
    (ray_n's sweeps, then ray_p's, in pair mode), so that a warp is 32
    consecutive lanes of one recorded sweep and runs a cluster's 16 tests
    when any of its lanes enters the cluster's box (``sweep_grouped_plain``
    at ``CLUSTER``)."""
    from psdr_jit_tpu_torch.ops import intersect as ix

    tests = 0
    for s in record:
        stats = {}
        ix.sweep_grouped_plain(tri, s.o.unbind(-1), s.d.unbind(-1),
                               ix.CLUSTER, stats)
        tests += 32 * stats["warp_tri_tests"]
    return tests


def device_work(out: dict, prefix: str, fn) -> None:
    """``out[prefix + "_device_ops"]``: the device operations that one call
    of ``fn`` issues, and ``out[prefix + "_device_busy_ms"]``: their summed
    device time, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out[f"{prefix}_device_ops"] = len(events)
    out[f"{prefix}_device_busy_ms"] = sum(
        e.self_device_time_total for e in events) / 1e3


@functools.cache
def _this_smoke():
    """This checkout's ``chip_smoke`` module, loaded under another name:
    its ptxas parser, which an older checkout's may lack, its ray families
    and its timer, so that both checkouts' kernels are timed alike (the
    card held while the host queues the calls)."""
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
    keys = ("K1_check_set_ms", "K1_edge_ms", "K1_edge_all_active_ms",
            "K1_492_frame_ms", "K1_492_host_frame_ms",
            "K1_492_host_frame_device_ops",
            "K1_492_host_frame_device_busy_ms", "K2_frame_ms",
            "cbox_frame_ms", "cbox_frame_peak_gb", "cbox_frame_device_ops",
            "cbox_frame_device_busy_ms",
            "K2-pair_step_ms", "K2-stash_step_ms", "K6_frame_ms",
            "K6_tests_per_ray", "frame_ms", "frame_peak_gb",
            "frame_device_ops", "frame_device_busy_ms", "K3_step_ms",
            "K4_step_ms", "step_ms", "step_peak_gb", "step_device_ops",
            "step_device_busy_ms") + tuple(
                f"K5_{f}_{k}" for f in (1292, 3852) for k in (
                    "frame_ms", "K6_as_is_frame_ms", "host_frame_ms",
                    "host_frame_peak_gb", "host_frame_device_ops",
                    "host_frame_device_busy_ms"))
    for k in keys:
        print(f"{k:33s} A {statistics.mean([runs[0][k], runs[3][k]]):10.4f} "
              f"({runs[0][k]:.4f}, {runs[3][k]:.4f})  B "
              f"{statistics.mean([runs[1][k], runs[2][k]]):10.4f} "
              f"({runs[1][k]:.4f}, {runs[2][k]:.4f})")
    for k in ("K1_check_set_bound", "K1_check_set_needed_tests_per_ray",
              "K1_492_launches", "K1_492_bound",
              "K1_492_needed_tests_per_ray", "K1_tree_build_ms_492", "needed_tests_per_ray", "K6_bound_ms",
              "K2_counts",
              "K5_1292_bound", "K5_1292_needed_tests_per_ray",
              "K5_3852_bound", "K5_3852_needed_tests_per_ray"):
        print(f"{k:18s} {runs[1].get(k)}")
    for k in ("ptxas",):
        print(f"{k:18s} A {runs[0][k]}  B {runs[1][k]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
