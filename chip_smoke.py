#!/usr/bin/env python3
"""On-card smoke run of psdr_jit_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Builds the port's kernels from ``psdr_jit_tpu_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (K1; K2 in
its single, pair and stash modes; K3, the attached shade; K4, its adjoint),
checks a 32x32 render against ``tests/golden_cbox32.npy``, then drives the
two main paths at full size on the Cornell box of
``tests/data/cbox_scene.npz``, as a user would, each with the launch
counts set to 0 just before it and read just after:

* serving: a picking query (``Scene.unit_ray_intersect``, K1) and a frame
  (``renderC``, K2) at 512x512, spp 32, ``PathTracer(3)``;
* training: one step of ``PathTracer(3).loss_and_grad`` at 512x512, spp
  32, sppe 32 (interior term through K2 stash, K3 and K4; primary-edge term
  through K2 pair), with gradients to a light translation, the tall
  block's vertex offsets, a reflectance and the radiance.

A 64x64 training step runs through the kernels and, on the CPU, through
the plain versions, and the two must agree. Before the full-size step is
counted, one step runs with every K2-stash, K3, K4 and K2-pair launch
recorded, and each launch is held against its plain version on the inputs
the step gave it (K4 with the step's own loss cotangent). Kernels, frame
and step are timed against their plain versions.

Every phase prints one line; any failure exits non-zero without the final
line. The last two lines are the card (``nvidia-smi`` name and power limit)
and ``{"ok": true, "device": {...}}``; the line before them is the kernels'
JSON record. Exits non-zero when no CUDA card is visible. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE_NPZ = ROOT / "tests" / "data" / "cbox_scene.npz"
GOLDEN = ROOT / "tests" / "golden_cbox32.npy"
FRAME = (512, 512, 32)  # width, height, spp of cbox_scene.npz
SPPE = 32  # edge samples per pixel of the training step
SEED = 0
DEPTH = 3


def log(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn`` (which ends on the device) over ``reps``
    runs after one warm-up, each closed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def on_plane_rays(box, n_per: int, gen, device):
    """Axis-aligned rays whose origin lies on a cluster box's face plane:
    the case where a per-ray slab test meets 0 * inf."""
    import torch

    lo, hi = box[:3].T, box[3:].T  # (nc, 3)
    nc = lo.shape[0]
    c = torch.randint(0, nc, (n_per,), generator=gen, device=device)
    p = lo[c] + (hi[c] - lo[c]) * torch.rand((n_per, 3), generator=gen,
                                             device=device)
    axis = torch.randint(0, 3, (n_per,), generator=gen, device=device)
    side = torch.randint(0, 2, (n_per,), generator=gen, device=device)
    plane = torch.where(side == 0, lo[c, axis], hi[c, axis])
    p[torch.arange(n_per, device=device), axis] = plane
    d = torch.zeros((n_per, 3), device=device)
    dax = torch.randint(0, 3, (n_per,), generator=gen, device=device)
    sgn = torch.where(torch.rand(n_per, generator=gen, device=device) < 0.5,
                      -1.0, 1.0)
    d[torch.arange(n_per, device=device), dax] = sgn
    return p.contiguous(), d.contiguous()


def pixel_center_rays(sd, width, height, device):
    """One ray through each pixel center, pixel-major."""
    import torch

    pix = torch.arange(width * height, device=device)
    xy = torch.stack([(pix % width).float() + 0.5,
                      (pix // width).float() + 0.5], -1)
    xy = xy / torch.tensor([width, height], dtype=torch.float32,
                           device=device)
    return sd.sensors[0].sample_primary_ray(xy)


def rel_l1(a, b) -> float:
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


def render_plain(sd, opts, seed, depth, chunk_lanes):
    """The main path with K2 replaced by its plain version: the same lane
    setup, primary rays, tables, chunking and average as renderC."""
    import torch
    from psdr_jit_tpu_torch.core.math import scrub_nonfinite
    from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.ops.image import interior_average

    dev = sd.tri.p0.device
    spp = opts.spp
    n_pix = opts.num_pixels
    pix = torch.arange(n_pix, device=dev)
    out = torch.empty((n_pix, 3), device=dev)
    step = max(chunk_lanes // spp, 1)
    tables = mk.build_tables(sd)
    for s in range(0, n_pix, step):
        m, sampler, samples = interior_lane_setup(
            opts.width, opts.height, spp, seed, pix[s:s + step])
        ray = sd.sensors[0].sample_primary_ray(samples)
        li = mk.li_mega_plain(
            *tables, ray.o, ray.d, torch.ones(m * spp, dtype=torch.bool,
                                              device=dev),
            sampler.lane, sampler.seed_value, depth, sampler.cnt)
        out[s:s + step] = interior_average(scrub_nonfinite(li), m, spp)
    return out


def train_setup(scene, seed: int = SEED):
    """``(params, apply_params, pixel_loss)`` of a training step with the
    JAX package's test parameters: a translation of the light (mesh 0),
    the tall block's raw vertex offsets (mesh 2), the reflectance of
    ``bsdfs[1]`` and the radiance; an L2 loss against a random target."""
    import numpy as np
    import torch

    light, block = scene.meshes[0], scene.meshes[2]
    base = light.to_world_raw.clone()
    verts = block.vertex_positions_raw.clone()
    target = torch.from_numpy(np.random.default_rng(seed).random(
        (scene.opts.num_pixels, 3)).astype(np.float32)).to(scene.device)

    def apply_params(p):
        light.to_world_raw = base + torch.nn.functional.pad(
            p["tx"].reshape(1, 1), (3, 0, 0, 3))
        block.vertex_positions_raw = verts + p["dv"]
        scene.bsdfs[1].reflectance = p["alb"]
        scene.emitters[0].radiance = p["rad"]

    def pixel_loss(rows, pix):
        return ((rows - target[pix]) ** 2).sum(-1)

    params = {"tx": torch.zeros(()), "dv": torch.zeros_like(verts),
              "alb": scene.bsdfs[1].reflectance.clone(),
              "rad": scene.emitters[0].radiance.clone()}
    return params, apply_params, pixel_loss


class PlainCalls:
    """Counts calls of the plain versions while active (by wrapping the
    module globals their dispatchers call), so a run can show that it
    reached none of them."""

    def __init__(self):
        from psdr_jit_tpu_torch.ops import intersect as ix
        from psdr_jit_tpu_torch.ops import megakernel as mk
        from psdr_jit_tpu_torch.ops import shade_mega as sm

        self.sites = [(ix, "ray_intersect_brute"), (mk, "_li_plain"),
                      (sm, "li_attached_plain")]
        self.count = 0

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.sites]
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, self._counted(fn))
        return self

    def _counted(self, fn):
        def wrapper(*args, **kwargs):
            self.count += 1
            return fn(*args, **kwargs)
        return wrapper

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)


def train_kernel_phases(sd, sd_edges, tables, dev, gen, kernels):
    """[K2-pair], [K2-stash], [K3], [K4]: each kernel against its plain
    version on a 131,072-lane crop of the training step's inputs."""
    import torch
    from psdr_jit_tpu_torch.core.sampler import Sampler
    from psdr_jit_tpu_torch.integrator.base import (STREAM_PRIMARY,
                                                    interior_lane_setup)
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.ops import shade_mega as sm
    from psdr_jit_tpu_torch.sensor.sensor import sample_primary_edge

    W, H, SPP = FRAME
    n = 1 << 17

    # K2 pair: the primary-edge pass's first 131,072 edge samples
    sampler = Sampler(SEED + STREAM_PRIMARY, torch.arange(n, device=dev))
    es = sample_primary_edge(sd_edges.sensors[0], sampler.next_1d())
    valid = es.idx >= 0
    args = (*tables, es.ray_n.o.contiguous(), es.ray_n.d.contiguous(),
            es.ray_p.o.contiguous(), es.ray_p.d.contiguous(), valid,
            sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
    out = mk.li_mega_pair_cuda(*args)
    ref = mk.li_mega_pair_plain(*args)
    torch.cuda.synchronize()
    rel, err = rel_l1(out, ref), float((out - ref).abs().max())
    ms = cuda_ms(lambda: mk.li_mega_pair_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: mk.li_mega_pair_plain(*args), 3)
    log("K2-pair", lanes=n, valid=int(valid.sum()), depth=DEPTH,
        bitwise_equal_to_plain=torch.equal(out, ref), rel_l1=f"{rel:.3e}",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(bool(torch.isfinite(out).all()), "K2-pair: non-finite values")
    require(float(out.abs().sum()) > 0, "K2-pair: all differences zero")
    require(rel < 1e-3, "K2-pair: rel L1 vs plain >= 1e-3")
    kernels["K2-pair"] = dict(
        name="K2 pair mode: Li(ray_n) - Li(ray_p)", route="cuda",
        source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:138", max_abs_err=err,
        ms=ms, plain_ms=plain_ms)

    # K2 stash: the camera lanes of a 4096-pixel crop (131,072 lanes)
    crop = torch.arange(H // 2 * W, (H // 2 + 8) * W, device=dev)
    m, sampler, samples = interior_lane_setup(W, H, SPP, SEED, crop)
    ray = sd.sensors[0].sample_primary_ray(samples, diff=False)
    o, d = ray.o.contiguous(), ray.d.contiguous()
    act = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    args = (*tables, o, d, act, sampler.lane, sampler.seed_value, DEPTH,
            sampler.cnt)
    li, hits = mk.li_mega_stash_cuda(*args)
    li_p, hits_p = mk.li_mega_stash_plain(*args)
    torch.cuda.synchronize()
    same = hits[0] == hits_p[0]
    uv_equal = all(torch.equal(a[same], b[same])
                   for a, b in zip(hits[1:], hits_p[1:]))
    rel, err = rel_l1(li, li_p), float((li - li_p).abs().max())
    id_match = same.float().mean().item()
    ms = cuda_ms(lambda: mk.li_mega_stash_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: mk.li_mega_stash_plain(*args), 3)
    log("K2-stash", lanes=o.shape[0], hits=hits[0].shape[0],
        id_match=f"{id_match:.6f}", uv_equal_where_ids_match=uv_equal,
        rel_l1=f"{rel:.3e}", max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}")
    require(rel < 1e-3, "K2-stash: rel L1 vs plain >= 1e-3")
    require(id_match >= 0.999 and uv_equal, "K2-stash: hits differ")
    kernels["K2-stash"] = dict(
        name="K2 stash mode: detached Li and the hits of every path",
        route="cuda", source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:138", max_abs_err=err,
        ms=ms, plain_ms=plain_ms)

    # K3 and K4 on the kernel's own stash
    tabs = [t.detach().contiguous() for t in sm.attached_tables(sd)]
    lane32 = mk._lane_i32(sampler.lane)
    shade_args = (*tabs, *hits, o, d, act, lane32, sampler.seed_value,
                  DEPTH, sampler.cnt)
    out = sm.shade_cuda(*shade_args)
    leaves = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    ref = sm.li_attached_plain(*leaves[:3], *hits, leaves[3], leaves[4],
                               act, sampler.lane, sampler.seed_value, DEPTH,
                               sampler.cnt)
    torch.cuda.synchronize()
    rel = rel_l1(out, ref.detach())
    err = float((out - ref.detach()).abs().max())
    ms = cuda_ms(lambda: sm.shade_cuda(*shade_args), 20)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: sm.li_attached_plain(
            *tabs, *hits, o, d, act, sampler.lane, sampler.seed_value,
            DEPTH, sampler.cnt), 3)
    log("K3", lanes=o.shape[0], depth=DEPTH, rel_l1=f"{rel:.3e}",
        max_abs_err=f"{err:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(bool(torch.isfinite(out).all()), "K3: non-finite radiance")
    require(rel < 1e-5, "K3: rel L1 vs plain >= 1e-5")
    kernels["K3"] = dict(
        name="K3 attached interior shade", route="cuda",
        source="psdr_jit_tpu_torch/csrc/shade.cu",
        replaces="psdr_jit_tpu/ops/shade_mega.py:390", max_abs_err=err,
        ms=ms, plain_ms=plain_ms)

    ct = torch.randn(out.shape, device=dev, generator=gen)
    grads = sm.shade_adjoint_cuda(*shade_args, False, ct)
    again = sm.shade_adjoint_cuda(*shade_args, False, ct)
    refs = torch.autograd.grad(ref, leaves, ct, retain_graph=True,
                               allow_unused=True)
    torch.cuda.synchronize()
    rels, errs = {}, []
    for name, g, r in zip(("table", "light", "misc", "o", "d"), grads, refs):
        r = torch.zeros_like(g) if r is None else r
        rels[name] = rel_l1(g, r) if r.abs().sum() > 0 else float(
            g.abs().sum())
        errs.append(float((g - r).abs().max()))
    spread = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                 for a, b in zip(grads[:3], again[:3]))
    ms = cuda_ms(lambda: sm.shade_adjoint_cuda(*shade_args, False, ct), 20)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        ref, leaves, ct, retain_graph=True, allow_unused=True), 3)
    log("K4", lanes=o.shape[0], depth=DEPTH,
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        max_abs_err=f"{max(errs):.3e}", run_to_run_rel=f"{spread:.3e}",
        bitwise_run_to_run=all(torch.equal(a, b)
                               for a, b in zip(grads, again)),
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    require(all(torch.isfinite(g).all() for g in grads), "K4: non-finite")
    require(all(v < 1e-4 for v in rels.values()),
            "K4: a cotangent group's rel L1 vs autograd >= 1e-4")
    kernels["K4"] = dict(
        name="K4 adjoint of K3, written by hand", route="cuda",
        source="psdr_jit_tpu_torch/csrc/shade.cu",
        replaces="psdr_jit_tpu/ops/shade_mega.py:450", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms)


class KernelCalls:
    """Records the inputs and outputs of every K2-stash, K3, K4 and K2-pair
    launch while active (by wrapping the module globals their dispatchers
    call), so each launch of a step can be held against its plain version
    on exactly the inputs the step gave it."""

    def __init__(self):
        from psdr_jit_tpu_torch.ops import megakernel as mk
        from psdr_jit_tpu_torch.ops import shade_mega as sm

        self.sites = {"K2-stash": (mk, "li_mega_stash_cuda"),
                      "K3": (sm, "shade_cuda"),
                      "K4": (sm, "shade_adjoint_cuda"),
                      "K2-pair": (mk, "li_mega_pair_cuda")}
        self.calls = {k: [] for k in self.sites}

    def __enter__(self):
        self.saved = {k: getattr(m, n) for k, (m, n) in self.sites.items()}
        for k, (m, n) in self.sites.items():
            setattr(m, n, self._recorded(k, self.saved[k]))
        return self

    def _recorded(self, kernel, fn):
        import torch

        def wrapper(*args):
            out = fn(*args)
            # a copy: autograd may add into a cotangent the kernel returned
            kept = torch.utils._pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, out)
            self.calls[kernel].append((fn, args, kept))
            return out
        return wrapper

    def __exit__(self, *exc):
        for k, (m, n) in self.sites.items():
            setattr(m, n, self.saved[k])


def _synced_ms(fn):
    """``(result, host ms)`` of one call of ``fn``, closed by a
    synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _plain_shade(args, ct, slice_lanes: int = 1 << 20):
    """K3's and K4's plain versions on the recorded inputs ``args`` of a
    ``shade_cuda`` launch, in slices of ``slice_lanes`` lanes: the radiance
    (N, 3), autograd's cotangents of (table, light, misc, o, d) for the
    output cotangent ``ct`` (the table groups summed over the slices), and
    the host ms of the forwards and of the backwards."""
    import torch
    from psdr_jit_tpu_torch.ops import shade_mega as sm

    table, light, misc, ids, us, vs, o, d, act, lane, *rest = args
    n = o.shape[0]
    outs, d_o, d_d = [], [], []
    sums = [torch.zeros_like(t) for t in (table, light, misc)]
    fwd_ms = bwd_ms = 0.0
    for s in range(0, n, slice_lanes):
        e = min(s + slice_lanes, n)
        leaves = [x.detach().clone().requires_grad_()
                  for x in (table, light, misc, o[s:e], d[s:e])]
        with torch.enable_grad():
            out, ms = _synced_ms(lambda: sm.li_attached_plain(
                *leaves[:3], ids[:, s:e], us[:, s:e], vs[:, s:e], leaves[3],
                leaves[4], act[s:e], lane[s:e], *rest))
            fwd_ms += ms
            grads, ms = _synced_ms(lambda: torch.autograd.grad(
                out, leaves, ct[s:e], allow_unused=True))
            bwd_ms += ms
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        for acc, g in zip(sums, grads[:3]):
            acc += g
        outs.append(out.detach())
        d_o.append(grads[3])
        d_d.append(grads[4])
    return (torch.cat(outs), (*sums, torch.cat(d_o), torch.cat(d_d)),
            fwd_ms, bwd_ms)


def train_frame_phase(step, kernels):
    """[train-frame]: one step of the training main path with each
    K2-stash, K3, K4 and K2-pair launch recorded, then each launch held
    against its plain version on the same inputs (K4 with the step's own
    loss cotangent) and timed at the step's shapes."""
    import torch
    from psdr_jit_tpu_torch.ops import megakernel as mk

    with KernelCalls() as rec:
        step()
        torch.cuda.synchronize()
    stats = {}

    def note(kernel, err, diff, ref, ms, plain_ms, **extra):
        s = stats.setdefault(kernel, dict(launches=0, lanes=0, err=0.0,
                                          diff=0.0, ref=0.0, ms=0.0,
                                          plain_ms=0.0))
        s["launches"] += 1
        s["err"] = max(s["err"], err)
        s["diff"] += diff
        s["ref"] += ref
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        for k, v in extra.items():
            s[k] = s.get(k, 0) + v

    for fn, args, (li, hits) in rec.calls["K2-stash"]:
        (li_p, hits_p), plain_ms = _synced_ms(
            lambda: mk.li_mega_stash_plain(*args))
        same = hits[0] == hits_p[0]
        uv_off = sum(int((a[same] != b[same]).sum())
                     for a, b in zip(hits[1:], hits_p[1:]))
        diff = (li - li_p).abs()
        note("K2-stash", float(diff.max()), float(diff.sum()),
             float(li_p.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=li.shape[0], hits=same.numel(),
             ids_off=int((~same).sum()), uv_off=uv_off)
    k4_calls = rec.calls["K4"]
    require(len(k4_calls) == len(rec.calls["K3"]),
            "train-frame: K3 and K4 launches differ")
    groups = ("table", "light", "misc", "o", "d")
    k4 = {g: [0.0, 0.0] for g in groups}
    for (fn3, args, out), (fn4, args4, grads) in zip(rec.calls["K3"],
                                                     k4_calls):
        ct = args4[-1]
        require(all(a.data_ptr() == b.data_ptr()
                    if isinstance(a, torch.Tensor) else a == b
                    for a, b in zip(args, args4[:-1])),
                "train-frame: K4 ran on other inputs than K3")
        ref, ref_grads, fwd_ms, bwd_ms = _plain_shade(args, ct)
        diff = (out - ref).abs()
        note("K3", float(diff.max()), float(diff.sum()),
             float(ref.abs().sum()), cuda_ms(lambda: fn3(*args), 3), fwd_ms,
             lanes=out.shape[0])
        again = fn4(*args4)
        spread = max(float((a - b).abs().max()
                           / a.abs().max().clamp_min(1e-30))
                     for a, b in zip(grads[:3], again[:3]))
        err = 0.0
        for g, a, r in zip(groups, grads, ref_grads):
            k4[g][0] += float((a - r).abs().sum())
            k4[g][1] += float(r.abs().sum())
            err = max(err, float((a - r).abs().max()))
        note("K4", err, 0.0, 0.0, cuda_ms(lambda: fn4(*args4), 3), bwd_ms,
             lanes=out.shape[0])
        stats["K4"]["spread"] = max(stats["K4"].get("spread", 0.0), spread)
    for fn, args, out in rec.calls["K2-pair"]:
        ref, plain_ms = _synced_ms(lambda: mk.li_mega_pair_plain(*args))
        diff = (out - ref).abs()
        note("K2-pair", float(diff.max()), float(diff.sum()),
             float(ref.abs().sum()), cuda_ms(lambda: fn(*args), 3), plain_ms,
             lanes=out.shape[0], valid=int(args[9].sum()))
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        require(k in stats, f"train-frame: the step launched no {k}")

    rels = {}
    for k in ("K2-stash", "K3", "K2-pair"):
        s = stats[k]
        rels[k] = s["diff"] / max(s["ref"], 1e-30)
    k4_rel = {g: (d / r if r > 0 else d) for g, (d, r) in k4.items()}
    s = stats["K2-stash"]
    id_match = 1.0 - s["ids_off"] / s["hits"]
    log("train-frame", **{
        f"{k}": (f"launches:{v['launches']},lanes:{v['lanes']},"
                 f"max_abs_err:{v['err']:.3e},ms:{v['ms']:.4f},"
                 f"plain_ms:{v['plain_ms']:.1f}")
        for k, v in stats.items()},
        stash_id_match=f"{id_match:.6f}", stash_uv_off=s["uv_off"],
        rel_l1=",".join(f"{k}:{v:.3e}" for k, v in rels.items()),
        K4_rel_l1=",".join(f"{g}:{v:.3e}" for g, v in k4_rel.items()),
        K4_run_to_run_rel=f"{stats['K4']['spread']:.3e}",
        pair_valid=stats["K2-pair"]["valid"])
    require(rels["K2-stash"] < 1e-3 and rels["K2-pair"] < 1e-3,
            "train-frame: a K2 mode's rel L1 vs plain >= 1e-3")
    require(id_match >= 0.999 and s["uv_off"] == 0,
            "train-frame: K2-stash hits differ")
    require(rels["K3"] < 1e-5, "train-frame: K3 rel L1 vs plain >= 1e-5")
    require(all(v < 1e-4 for v in k4_rel.values()),
            "train-frame: a K4 cotangent group's rel L1 vs autograd >= 1e-4")
    for k, s in stats.items():
        kernels[k].update(max_abs_err=max(kernels[k]["max_abs_err"],
                                          s["err"]),
                          ms=s["ms"], plain_ms=s["plain_ms"])


def train_step_fn(integrator, scene):
    """A closure that takes one training step on ``scene``."""
    params, apply_params, pixel_loss = train_setup(scene)
    return lambda: integrator.loss_and_grad(scene, params, apply_params,
                                            pixel_loss, 0, SEED)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "psdr_jit_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(psdr_jit_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import psdr_jit_tpu_torch as pt
    from psdr_jit_tpu_torch.ops import _cuda
    from psdr_jit_tpu_torch.ops import intersect as ix
    from psdr_jit_tpu_torch.ops import megakernel as mk
    from psdr_jit_tpu_torch.integrator.base import (CHUNK_LANES,
                                                    interior_lane_setup)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    kernels = {}

    # ---- 1. card and build ------------------------------------------------
    log("card", nvidia_smi=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = (lib_path.parent / "ptxas.txt").read_text()
    regs = [ln.strip() for ln in ptxas.splitlines()
            if "registers" in ln or "spill" in ln]
    log("build", seconds=f"{build_s:.2f}", lib=lib_path.relative_to(ROOT))
    for ln in regs:
        print(f"[build] ptxas: {ln}")

    arrays = np.load(SCENE_NPZ)
    scene = pt.Scene.from_arrays(arrays, device=dev)
    W, H, SPP = scene.opts.width, scene.opts.height, scene.opts.spp
    require((W, H, SPP) == FRAME, f"{SCENE_NPZ.name} holds the {FRAME} frame")
    n_pix = W * H
    sd = scene.configure()
    tri = sd.tri
    tables = mk.build_tables(sd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 2. K1 vs plain ---------------------------------------------------
    picks = pixel_center_rays(sd, W, H, dev)
    _, sampler, samples = interior_lane_setup(
        W, H, 2, SEED, torch.arange(n_pix, device=dev))
    cam = sd.sensors[0].sample_primary_ray(samples)
    po, pd = on_plane_rays(tables[1], 1 << 18, gen, dev)
    lo, hi = sd.lower, sd.upper
    ro = lo + (hi - lo) * torch.rand((1 << 17, 3), generator=gen, device=dev)
    rd = torch.nn.functional.normalize(
        torch.randn((1 << 17, 3), generator=gen, device=dev), dim=-1)
    o1 = torch.cat([picks.o, cam.o, po, ro]).contiguous()
    d1 = torch.cat([picks.d, cam.d, pd, rd]).contiguous()
    n1 = o1.shape[0]
    tri_tab, box_tab = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
    t_c, id_c, uv_c = ix.intersect_cuda(tri_tab, box_tab, o1, d1)
    id_p, _, uv_p, t_p = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2,
                                                 o1, d1)
    torch.cuda.synchronize()
    # the plain sweep visits every triangle: equal bits mean K1's per-ray
    # cluster culling changed no hit
    bitwise = (torch.equal(t_c, t_p) and torch.equal(id_c, id_p)
               and torch.equal(uv_c, uv_p))
    same = id_c == id_p
    both = same & (id_c >= 0)
    t_err = (t_c - t_p).abs()[both]
    t_rel = (t_err / t_p[both].abs()).max().item()
    ties = ~same
    # a mismatch must be a tie: both hit, at the same distance
    tie_ok = bool(((id_c[ties] >= 0) & (id_p[ties] >= 0)
                   & ((t_c[ties] - t_p[ties]).abs()
                      <= 1e-5 * t_p[ties].abs())).all())
    match = same.float().mean().item()
    k1_ms_main = cuda_ms(lambda: ix.intersect_cuda(
        tri_tab, box_tab, picks.o.contiguous(), picks.d.contiguous()), 50)
    k1_ms = cuda_ms(lambda: ix.intersect_cuda(tri_tab, box_tab, o1, d1), 20)
    k1_plain_ms = cuda_ms(lambda: ix.ray_intersect_brute(
        tri.p0, tri.e1, tri.e2, o1, d1), 5)
    log("K1", rays=n1, bitwise_equal_to_plain=bitwise,
        id_match=f"{match:.6f}", mismatches=int(ties.sum()),
        mismatches_are_ties=tie_ok, t_max_rel=f"{t_rel:.3e}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
        ms_pick_rays=f"{k1_ms_main:.4f}")
    require(match >= 0.999 and tie_ok, "K1: ids differ beyond f32 ties")
    require(t_rel <= 1e-5, "K1: t differs beyond rtol 1e-5")
    kernels["K1"] = dict(
        name="K1 closest-hit sweep", route="cuda",
        source="psdr_jit_tpu_torch/csrc/intersect.cu",
        replaces="psdr_jit_tpu/ops/intersect_pallas.py:174",
        max_abs_err=float(t_err.max()) if t_err.numel() else 0.0,
        ms=k1_ms, plain_ms=k1_plain_ms)

    # ---- 3. K2 vs plain on a 4096-pixel crop of the frame ------------------
    crop = torch.arange(H // 2 * W, (H // 2 + 8) * W, device=dev)
    m, sampler, samples = interior_lane_setup(W, H, SPP, SEED, crop)
    ray = sd.sensors[0].sample_primary_ray(samples)
    o2, d2 = ray.o.contiguous(), ray.d.contiguous()
    act = torch.ones(o2.shape[0], dtype=torch.bool, device=dev)
    args = (*tables, o2, d2, act, sampler.lane, sampler.seed_value, DEPTH,
            sampler.cnt)
    li_k = mk.li_mega_cuda(*args)
    li_p = mk.li_mega_plain(*args)
    torch.cuda.synchronize()
    k2_rel = rel_l1(li_k, li_p)
    k2_err = float((li_k - li_p).abs().max())
    k2_crop_ms = cuda_ms(lambda: mk.li_mega_cuda(*args), 20)
    k2_crop_plain_ms = cuda_ms(lambda: mk.li_mega_plain(*args), 3)
    log("K2", lanes=o2.shape[0], depth=DEPTH, rel_l1=f"{k2_rel:.3e}",
        max_abs_err=f"{k2_err:.3e}", finite=bool(torch.isfinite(li_k).all()),
        ms=f"{k2_crop_ms:.4f}", plain_ms=f"{k2_crop_plain_ms:.4f}")
    require(bool(torch.isfinite(li_k).all()), "K2: non-finite radiance")
    require(k2_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3")

    # K2 alone at the frame's shape, each renderC chunk's launch, against
    # its plain version on the same inputs
    step = CHUNK_LANES // SPP
    k2_frame_ms = k2_frame_plain_ms = 0.0
    frame_err = frame_diff = frame_ref = 0.0
    for s in range(0, n_pix, step):
        m, sampler, samples = interior_lane_setup(
            W, H, SPP, SEED, torch.arange(s, min(s + step, n_pix),
                                          device=dev))
        ray = sd.sensors[0].sample_primary_ray(samples)
        args = (*tables, ray.o.contiguous(), ray.d.contiguous(),
                torch.ones(m * SPP, dtype=torch.bool, device=dev),
                sampler.lane, sampler.seed_value, DEPTH, sampler.cnt)
        li_p = mk.li_mega_plain(*args)
        diff = (mk.li_mega_cuda(*args) - li_p).abs()
        frame_err = max(frame_err, float(diff.max()))
        frame_diff += float(diff.sum())
        frame_ref += float(li_p.abs().sum())
        k2_frame_ms += cuda_ms(lambda: mk.li_mega_cuda(*args), 5)
        k2_frame_plain_ms += cuda_ms(lambda: mk.li_mega_plain(*args), 1)
    frame_rel = frame_diff / max(frame_ref, 1e-30)
    log("K2-frame", lanes=n_pix * SPP, rel_l1=f"{frame_rel:.3e}",
        max_abs_err=f"{frame_err:.3e}", ms=f"{k2_frame_ms:.3f}",
        plain_ms=f"{k2_frame_plain_ms:.3f}")
    require(frame_rel < 1e-3, "K2: rel L1 vs plain >= 1e-3 on the frame")
    kernels["K2"] = dict(
        name="K2 detached Li megakernel", route="cuda",
        source="psdr_jit_tpu_torch/csrc/megakernel.cu",
        replaces="psdr_jit_tpu/ops/megakernel.py:138",
        max_abs_err=max(k2_err, frame_err), ms=k2_frame_ms,
        plain_ms=k2_frame_plain_ms)

    # ---- 3b. K2 pair and stash, K3, K4 vs plain on 131,072-lane crops ------
    edge_scene = pt.Scene.from_arrays(arrays, device=dev)
    edge_scene.opts.sppe = SPPE
    train_kernel_phases(sd, edge_scene.configure(), tables, dev, gen, kernels)

    # ---- 4. golden 32x32 render ---------------------------------------------
    small = pt.Scene.from_arrays(arrays, device=dev)
    small.opts = pt.RenderOption(32, 32, 4, 0, 0)
    img32 = pt.PathTracer(2).renderC(small, 0, seed=0).cpu().numpy()
    golden = np.load(GOLDEN)
    g_rel = float(np.abs(img32 - golden).sum() / np.abs(golden).sum())
    g_frac = float((np.abs(img32 - golden).max(-1) > 1e-3).mean())
    log("golden", rel_l1=f"{g_rel:.3e}", frac_pixels_off=f"{g_frac:.4f}")
    require(g_rel < 5e-3 and g_frac < 0.1, "golden: 32x32 render off")

    # ---- 5. the main path at full size -------------------------------------
    integrator = pt.PathTracer(DEPTH)
    n_chunks = -(-n_pix // (CHUNK_LANES // SPP))
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        its = scene.unit_ray_intersect(picks.o, picks.d)
        img = integrator.renderC(scene, 0, seed=SEED)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    log("main-path", K1_LAUNCHES=launches["K1"], K2_LAUNCHES=launches["K2"],
        chunks=n_chunks, picks_hit=f"{its.valid.float().mean().item():.4f}",
        plain_calls=plain.count)
    require(launches["K1"] == 1, "main path: K1 was not launched once")
    require(launches["K2"] == n_chunks, "main path: K2 launches != chunks")
    require(plain.count == 0, "main path: a plain version ran")
    require(tuple(img.shape) == (n_pix, 3), "renderC: wrong shape")
    require(bool(torch.isfinite(img).all()), "renderC: non-finite pixels")
    require(float(img.abs().sum()) > 0, "renderC: black image")
    require(its.valid.float().mean().item() > 0.5,
            "picking: most pixel rays missed the box")

    img_plain = render_plain(sd, scene.opts, SEED, DEPTH, CHUNK_LANES)
    f_rel = rel_l1(img, img_plain)
    rows = torch.arange(H // 4 * W, (H // 4 + 1) * W, device=dev)
    crop_img = integrator.renderC(scene, 0, seed=SEED, pix_id=rows)
    crop_exact = torch.equal(crop_img, img[rows])
    render_ms = wall_ms(lambda: integrator.renderC(scene, 0, seed=SEED), 5)
    plain_ms = wall_ms(lambda: render_plain(
        sd, scene.opts, SEED, DEPTH, CHUNK_LANES), 3)
    rays = n_pix * SPP * (1 + 2 * DEPTH)
    log("frame", mean=f"{img.mean().item():.6f}", rel_l1_vs_plain=f"{f_rel:.3e}",
        crop_bitwise=crop_exact, ms=f"{render_ms:.2f}",
        plain_ms=f"{plain_ms:.2f}",
        mrays_per_s=f"{rays / render_ms / 1e3:.1f}",
        plain_mrays_per_s=f"{rays / plain_ms / 1e3:.1f}")
    require(f_rel < 1e-3, "frame: rel L1 vs the plain path >= 1e-3")
    require(crop_exact, "frame: crop rows differ from the full frame")

    # ---- 6. a 64x64 training step: the kernels against the plain path -------
    steps = {}
    for name, device in (("kernels", dev), ("plain", torch.device("cpu"))):
        small = pt.Scene.from_arrays(arrays, device=device)
        small.opts = pt.RenderOption(64, 64, 8, 8, 0)
        step = train_step_fn(integrator, small)
        t0 = time.perf_counter()
        steps[name] = [x if isinstance(x, dict) else x.cpu()
                       for x in step()]
        steps[name][1] = {k: v.cpu() for k, v in steps[name][1].items()}
        steps[name].append((time.perf_counter() - t0) * 1e3)
    (loss_k, g_k, img_k, ms_k), (loss_p, g_p, img_p, ms_p) = (
        steps["kernels"], steps["plain"])
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    img_rel = rel_l1(img_k, img_p)
    g_rel = {k: rel_l1(g_k[k], g_p[k]) for k in g_p}
    log("train-64", spp=8, sppe=8, depth=DEPTH, loss_rel=f"{loss_rel:.3e}",
        image_rel_l1=f"{img_rel:.3e}",
        grad_rel_l1=",".join(f"{k}:{v:.3e}" for k, v in g_rel.items()),
        ms=f"{ms_k:.1f}", plain_cpu_ms=f"{ms_p:.1f}")
    require(loss_rel < 1e-4 and img_rel < 1e-4,
            "train-64: loss or image differs from the plain path")
    require(all(v < 1e-3 for v in g_rel.values()),
            "train-64: a gradient differs from the plain path by >= 1e-3")
    require(all(float(g.abs().sum()) > 0 for g in g_p.values()),
            "train-64: a parameter got no gradient")

    # ---- 7. the training main path at full size -----------------------------
    train_scene = pt.Scene.from_arrays(arrays, device=dev)
    train_scene.opts.sppe = SPPE
    step = train_step_fn(integrator, train_scene)
    train_frame_phase(step, kernels)
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        _cuda.reset_launches()
        loss, grads, img_t = step()
        torch.cuda.synchronize()
        launches_t = dict(_cuda.LAUNCHES)
    log("main-path-train", **{f"{k}_LAUNCHES": v for k, v in
                              launches_t.items()},
        plain_calls=plain.count)
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        require(launches_t[k] > 0, f"training main path: {k} not launched")
    require(plain.count == 0, "training main path: a plain version ran")
    require(launches_t["K2-stash"] == launches_t["K3"] == launches_t["K4"],
            "training main path: stash, K3 and K4 launches differ")
    require(tuple(img_t.shape) == (n_pix, 3), "train: wrong image shape")
    require(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values()),
        "train: non-finite loss or gradient")
    require(all(float(g.abs().sum()) > 0 for g in grads.values()),
            "train: a parameter got no gradient")
    # the step's image is the attached Li (K3 over K2-stash's hits): the
    # frame's radiance up to the stash's bilinear bounce origins
    t_rel = rel_l1(img_t, img)
    require(t_rel < 1e-3, "train: image differs from renderC's frame")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = wall_ms(step, 3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log("train", size=f"{W}x{H}", spp=SPP, sppe=SPPE, depth=DEPTH,
        loss=f"{float(loss):.6e}",
        grad_l1=",".join(f"{k}:{float(g.abs().sum()):.4e}"
                         for k, g in grads.items()),
        image_rel_l1_vs_frame=f"{t_rel:.3e}", step_ms=f"{step_ms:.2f}",
        peak_gb=f"{peak_gb:.3f}")

    record = {"kernels": (
        [{**kernels[k], "launches": launches[k]} for k in ("K1", "K2")]
        + [{**kernels[k], "launches": launches_t[k]}
           for k in ("K2-pair", "K2-stash", "K3", "K4")])}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
