"""psdr_jit_tpu_torch's CUDA kernels against their plain PyTorch versions.

The tests marked ``gpu`` need a CUDA card and skip without one. This file
imports no JAX (the card's machine has none): run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

The kernels are built without FMA contraction (their fmas are explicit and
the plain versions write the same ones), so K2 in all three modes (at 32
and 172 triangles, and on a case of exact ties through each of its two
sweeps) and K3 must agree with their plain versions to f32 rounding; K4
sums its table cotangents across a warp, then with float atomics in no
fixed order, so it agrees with autograd of the plain K3 to a reordered
sum. K1, K5 and K6, the walk of one tree, equal their plain versions and
the unculled sweep bit for bit (K1 at 32 and 492 triangles, with dead
lanes, and on exact ties). The
unmarked tests check, on any machine, that the CPU path is the plain
version, that the kernel launchers refuse what they cannot run instead
of falling back, and that each kernel's PyTorch operator has a fake
version that gives its wrapper's shapes and types; on the card,
``torch.library.opcheck`` holds each operator and ``torch.func.jvp`` of
renderD runs through them.
"""

import os

import numpy as np
import pytest
import torch

import psdr_jit_tpu_torch as pt
from chip_smoke import (K1_GALLERY, edge_rays, envmap_arrays, envmap_setup,
                        func_jvp, gallery_arrays, mixed_rays,
                        renderd_tangent, swapped_children, tie_case,
                        train_setup)
from psdr_jit_tpu_torch.integrator import base
from psdr_jit_tpu_torch.integrator.base import interior_lane_setup
from psdr_jit_tpu_torch.ops import _cuda
from psdr_jit_tpu_torch.ops import bvh
from psdr_jit_tpu_torch.ops import intersect as ix
from psdr_jit_tpu_torch.ops import megakernel as mk
from psdr_jit_tpu_torch.ops import shade_mega as sm

HERE = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(HERE, "data", "cbox_scene.npz")
GOLDEN = os.path.join(HERE, "golden_cbox32.npy")


def _scene(device, width=32, height=32, spp=4):
    sc = pt.Scene.from_arrays(np.load(NPZ), device=device)
    sc.opts = pt.RenderOption(width, height, spp, 0, 0)
    sc.configure()
    return sc


def _camera_rays(sd, spp, seed, pix):
    _, sampler, samples = interior_lane_setup(
        sd.sensors[0].width, sd.sensors[0].height, spp, seed, pix)
    ray = sd.sensors[0].sample_primary_ray(samples)
    return ray.o.contiguous(), ray.d.contiguous(), sampler


def _train(sc, depth, seed=3):
    """One training step with gradients to the four parameters of the
    JAX package's tests (``chip_smoke.train_setup``)."""
    return pt.PathTracer(depth).loss_and_grad(sc, *train_setup(sc),
                                              seed=seed)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().sum() / b.abs().sum().clamp_min(1e-30))


def _on_plane_rays(box, n, device):
    """Axis-aligned rays with origins on cluster box planes."""
    rng = np.random.default_rng(0)
    bx = box.cpu().numpy()
    c = rng.integers(0, bx.shape[1], n)
    o = rng.uniform(bx[:3, c].T, bx[3:, c].T)
    ax = rng.integers(0, 3, n)
    o[np.arange(n), ax] = bx[ax + 3 * rng.integers(0, 2, n), c]
    d = np.zeros((n, 3))
    d[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    return (torch.tensor(o, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


# ---- on any machine ---------------------------------------------------------

def test_cpu_path_is_plain_and_launches_nothing():
    sc = _scene("cpu")
    sd = sc.data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 4, 1, torch.arange(200))
    act = torch.ones(o.shape[0], dtype=torch.bool)
    _cuda.reset_launches()
    args = (*tables, o, d, act, sampler.lane, 1, 2, sampler.cnt)
    assert torch.equal(mk.li_mega(*args), mk.li_mega_plain(*args))
    pt.PathTracer(2).renderC(sc)
    sc.unit_ray_intersect(o, d)
    sc.opts = pt.RenderOption(8, 8, 2, 2, 0)
    loss, grads, _ = _train(sc, 2)
    assert torch.isfinite(loss) and all(g.abs().sum() > 0
                                        for g in grads.values())
    assert set(_cuda.LAUNCHES) == {"K1", "K2", "K2-pair", "K2-stash", "K3",
                                   "K4", "K5", "K6"}
    assert not any(_cuda.LAUNCHES.values())


def test_cuda_launchers_refuse_cpu_tensors():
    sd = _scene("cpu").data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 1, 0, torch.arange(16))
    act = torch.ones(16, dtype=torch.bool)
    tree = ix.routing_tree(sd.tri.p0, sd.tri.e1, sd.tri.e2)
    with pytest.raises(ValueError, match="CUDA"):
        bvh.walk_cuda(tree, o, d, act, kernel="K1")
    with pytest.raises(ValueError, match="CUDA"):
        ix.sweep_cuda(tables[0], tables[1], o, d, act)
    with pytest.raises(ValueError, match="CUDA"):
        mk.li_mega_cuda(*tables, o, d, act, sampler.lane, 0, 1, sampler.cnt)
    with pytest.raises(ValueError, match="CUDA"):
        mk.li_mega_pair_cuda(*tables, o, d, o, d, act, sampler.lane, 0, 1,
                             sampler.cnt)
    with pytest.raises(ValueError, match="CUDA"):
        mk.li_mega_stash_cuda(*tables, o, d, act, sampler.lane, 0, 1,
                              sampler.cnt)
    table, light, misc = sm.attached_tables(sd)
    _, (ids, us, vs) = mk.li_mega_stash(*tables, o, d, act, sampler.lane, 0,
                                        1, sampler.cnt)
    lane = mk._lane_i32(sampler.lane)
    with pytest.raises(ValueError, match="CUDA"):
        sm.shade_cuda(table, light, misc, ids, us, vs, o, d, act, lane, 0, 1,
                      sampler.cnt)
    with pytest.raises(ValueError, match="CUDA"):
        sm.shade_adjoint_cuda(table, light, misc, ids, us, vs, o, d, act,
                              lane, 0, 1, sampler.cnt, False, o)


def _gallery(device, n_spheres, subdiv, width=16, spp=2):
    sc = pt.Scene.from_arrays(gallery_arrays(width, width, spp, n_spheres,
                                             subdiv), device=device)
    sc.configure()
    return sc


def test_large_scene_launchers_refuse_cpu_tensors():
    sd = _gallery("cpu", 2, 2).data
    o, d, act = mixed_rays(sd, 64, torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    tree = ix.routing_tree(sd.tri.p0, sd.tri.e1, sd.tri.e2)
    with pytest.raises(ValueError, match="CUDA"):
        bvh.walk_cuda(tree, o, d, act, kernel="K5")
    with pytest.raises(ValueError, match="CUDA"):
        bvh.walk_cuda(bvh.build_bvh(sd.tri.p0, sd.tri.e1, sd.tri.e2), o, d,
                      act)
    small = bvh.build_bvh(sd.tri.p0[:100], sd.tri.e1[:100], sd.tri.e2[:100])
    with pytest.raises(ValueError, match="513..4096 triangles"):
        bvh.walk_cuda(small, o, d, act, kernel="K5")


OPS = ("k1_sweep", "walk", "k2", "k2_pair", "k2_stash", "k3", "k4")


def _op_case(name, sd):
    """``(operator, arguments, plain)`` of each kernel's operator on the
    box's 32x32 camera rays (spp 4, depth 2) on ``sd``'s device;
    ``plain()`` gives what its wrapper returns on these inputs, from the
    plain versions (CPU tensors)."""
    tri = sd.tri
    o, d, sampler = _camera_rays(sd, 4, 3, torch.arange(
        32 * 32, device=tri.p0.device))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    act[::7] = False
    lane = mk._lane_i32(sampler.lane)
    if name == "k1_sweep":
        def plain():
            tid, _, uv, t = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2,
                                                   o, d, act)
            return t, tid, uv

        return ix.k1_sweep_op, (*ix.pack_triangles(tri.p0, tri.e1, tri.e2),
                                o, d, act), plain
    if name == "walk":
        tree = ix.routing_tree(tri.p0, tri.e1, tri.e2)

        def plain():
            tid, _, uv, t = bvh.ray_intersect_bvh_plain(tree, o, d, act)
            return t, tid, uv, torch.zeros((o.shape[0], 2),
                                           dtype=torch.int32)

        return bvh.walk_op, (tree.tri4, tree.node, tree.root, o, d, act,
                             "K1", True), plain
    tables = [t.detach() for t in mk.build_tables(sd)]
    schedule = (act, sampler.lane, 3, 2, sampler.cnt)
    k2 = (*tables, o, d, o, d, act, lane, 3, 2, sampler.cnt, False)
    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros(0),
             torch.zeros(0))
    if name == "k2":
        return mk.k2_op, (*k2, 0, 2), lambda: (
            mk.li_mega_plain(*tables, o, d, *schedule), *empty)
    if name == "k2_pair":
        return mk.k2_op, (*k2, 1, 0), lambda: (
            mk.li_mega_pair_plain(*tables, o, d, o, d, *schedule), *empty)
    stash = mk.li_mega_stash(*tables, o, d, *schedule)
    if name == "k2_stash":
        return mk.k2_op, (*k2, 2, 2), lambda: (stash[0], *stash[1])
    table, light, misc = (t.detach().contiguous()
                          for t in sm.attached_tables(sd))
    k3 = (table, light, misc, o, d, *stash[1], act, lane, 3, 2, sampler.cnt,
          False)
    if name == "k3":
        return sm.k3_op, k3, lambda: sm.li_attached_plain(
            table, light, misc, *stash[1], o, d, *schedule)
    ct = torch.ones_like(o)

    def plain():
        leaves = [x.clone().requires_grad_()
                  for x in (table, light, misc, o, d)]
        out = sm.li_attached_plain(*leaves[:3], *stash[1], *leaves[3:],
                                   *schedule)
        grads = torch.autograd.grad(out, leaves, ct, allow_unused=True)
        return tuple(torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads))

    return sm.k4_op, (*k3, ct), plain


@pytest.mark.parametrize("name", OPS)
def test_operator_fake_matches_wrapper(name):
    """Each kernel's operator (``torch.library.custom_op``): run on
    ``meta`` tensors, its fake version gives the shapes and dtypes that
    its wrapper returns (here from the plain versions), with no build and
    no card; on CPU tensors it has no kernel and raises (the CPU path
    calls the plain versions, never an operator)."""
    op, args, plain = _op_case(name, _scene("cpu").data)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    got, want = op(*meta), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
    with pytest.raises(NotImplementedError):
        op(*args)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means an error, never a quiet move to the plain path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda._nvcc()


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["cbox", "gallery"])
def test_k1_matches_plain_bitwise(cuda, scene):
    """K1 at 32 and 492 triangles (the Cornell box, swept, and
    ``K1_GALLERY``, walked) through the routing entry, on camera rays,
    axis-aligned rays on cluster planes and the secondary-edge stand-ins
    with their dead lanes: one K1 launch, the unculled sweep's hits bit for
    bit, dead lanes missing. The scene's tree (``SceneData.bvh``), built on
    the host by the kernel library, equals numpy's build bit for bit."""
    if scene == "cbox":
        sd = _scene(cuda).data
        co, cd, _ = _camera_rays(sd, 16, 3, torch.arange(32 * 32,
                                                         device=cuda))
    else:
        sd = pt.Scene.from_arrays(gallery_arrays(**K1_GALLERY),
                                  device=cuda).configure()
        co, cd = _gallery_camera(sd, cuda)
    tri = sd.tri
    _, box = ix.pack_triangles(tri.p0, tri.e1, tri.e2)
    po, pd = _on_plane_rays(box, 1 << 15, cuda)
    eo, ed, ea = edge_rays(sd, 1 << 15, torch.Generator(cuda).manual_seed(4),
                           cuda)
    o = torch.cat([co, po, eo]).contiguous()
    d = torch.cat([cd, pd, ed]).contiguous()
    act = torch.cat([torch.ones(co.shape[0] + po.shape[0], dtype=torch.bool,
                                device=cuda), ea])
    before = dict(_cuda.LAUNCHES)
    out = ix.ray_intersect_detached(tri.p0, tri.e1, tri.e2, pt.Ray(o, d),
                                    act, sd.bvh)
    assert _cuda.LAUNCHES["K1"] == before["K1"] + 1
    assert sum(_cuda.LAUNCHES.values()) == sum(before.values()) + 1
    brute = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2, o, d, act)
    for x, y in zip(out, brute):
        assert torch.equal(x, y)
    assert not out[1][~act].any() and out[1].float().mean() > 0.3
    cpu = bvh.build_sah_bvh(*(x.cpu() for x in (tri.p0, tri.e1, tri.e2)))
    assert sd.bvh.depth == cpu.depth
    for name in ("tri4", "node", "root"):  # links are bit-cast: compare bits
        assert torch.equal(getattr(sd.bvh, name).cpu().view(torch.int32),
                           getattr(cpu, name).view(torch.int32))


def _gallery_camera(sd, device):
    """Jittered camera rays of a 128x128 frame of ``sd``'s sensor."""
    _, _, samples = interior_lane_setup(128, 128, 1, 0, torch.arange(
        128 * 128, device=device))
    ray = sd.sensors[0].sample_primary_ray(samples)
    return ray.o.contiguous(), ray.d.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n_tri, n_pairs", [(160, 16), (496, 40)])
def test_k1_tie_case_bitwise(cuda, n_tri, n_pairs):
    """Exact ties (``tie_case``) through K1's sweep (160 triangles) and its
    walk (496): the lowest id of equal distances, as the unculled sweep
    keeps; the walk also with every node's children swapped."""
    tp0, te1, te2, ro, rd, low = (torch.from_numpy(x).to(cuda) for x in
                                  tie_case(n_tri=n_tri, n_pairs=n_pairs))
    act = torch.ones(ro.shape[0], dtype=torch.bool, device=cuda)
    brute = ix.ray_intersect_brute(tp0, te1, te2, ro, rd)
    assert (brute[0] == low.to(torch.int32)).float().mean() > 0.5
    before = _cuda.LAUNCHES["K1"]
    out = ix.ray_intersect_detached(tp0, te1, te2, pt.Ray(ro, rd), act)
    assert _cuda.LAUNCHES["K1"] == before + 1
    for x, y in zip(out, brute):
        assert torch.equal(x, y)
    if n_tri > ix.SWEEP_MAX_TRIS:
        tree = ix.routing_tree(tp0, te1, te2)
        t, ids, uv = bvh.walk_cuda(swapped_children(tree), ro, rd, act,
                                   kernel="K1")
        for x, y in zip((ids, ids >= 0, uv, t), brute):
            assert torch.equal(x, y)


@pytest.mark.gpu
def test_k1_refuses_bad_input(cuda):
    sd = _scene(cuda).data
    tree = sd.bvh
    o = torch.zeros((8, 3), device=cuda)
    act = torch.ones(8, dtype=torch.bool, device=cuda)
    tab = torch.zeros((9, 16), device=cuda)
    box = torch.zeros((6, 1), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ix.sweep_cuda(tab, box, o, o.double(), act)
    with pytest.raises(ValueError, match="contiguous"):
        ix.sweep_cuda(tab, box, o, torch.zeros((3, 8), device=cuda).T, act)
    with pytest.raises(ValueError, match="multiple of 16"):
        ix.sweep_cuda(torch.zeros((9, 20), device=cuda), box, o, o, act)
    with pytest.raises(ValueError, match="bool"):
        ix.sweep_cuda(tab, box, o, o, act.int())
    with pytest.raises(ValueError, match="dtype"):
        bvh.walk_cuda(tree, o, o.double(), act, kernel="K1")
    with pytest.raises(ValueError, match="contiguous"):
        bvh.walk_cuda(tree, o, torch.zeros((3, 8), device=cuda).T, act,
                      kernel="K1")
    with pytest.raises(ValueError, match="bool"):
        bvh.walk_cuda(tree, o, o, act.int(), kernel="K1")
    big = _gallery(cuda, 4, 2).data.bvh
    with pytest.raises(ValueError, match="K1 takes 1..512 triangles"):
        bvh.walk_cuda(big, o, o, act, kernel="K1")


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_k2_matches_plain(cuda, depth):
    sd = _scene(cuda).data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 16, 5, torch.arange(32 * 32,
                                                         device=cuda))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    act[::5] = False
    args = (*tables, o, d, act, sampler.lane, 5, depth, sampler.cnt)
    before = _cuda.LAUNCHES["K2"]
    out = mk.li_mega(*args)
    assert _cuda.LAUNCHES["K2"] == before + 1
    ref = mk.li_mega_plain(*args)
    assert torch.isfinite(out).all() and (out[::5] == 0).all()
    if depth == 0:
        assert torch.equal(out, ref)
    else:
        rel = float((out - ref).abs().sum() / ref.abs().sum())
        assert rel < 1e-3, rel


@pytest.mark.gpu
def test_render_on_card(cuda, monkeypatch):
    """The 32x32 golden render on the card, one K2 launch per chunk, and a
    crop equal to the full frame's rows."""
    sc = _scene(cuda)
    integ = pt.PathTracer(2)
    monkeypatch.setattr(base, "CHUNK_LANES", 1024)
    _cuda.reset_launches()
    img = integ.renderC(sc, 0, seed=0)
    assert _cuda.LAUNCHES["K2"] == 4
    golden = np.load(GOLDEN)
    diff = np.abs(img.cpu().numpy() - golden)
    assert diff.sum() / np.abs(golden).sum() < 5e-3
    assert (diff.max(-1) > 1e-3).mean() < 0.1
    crop = torch.arange(100, 700, 3, device=cuda)
    assert torch.equal(integ.renderC(sc, 0, seed=0, pix_id=crop), img[crop])


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3])
def test_k2_pair_and_stash_match_plain(cuda, depth):
    sd = _scene(cuda).data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 16, 5, torch.arange(32 * 32,
                                                         device=cuda))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    act[::5] = False
    o2, d2 = o.flip(0).contiguous(), d.flip(0).contiguous()
    pair = (*tables, o, d, o2, d2, act, sampler.lane, 5, depth, sampler.cnt)
    before = dict(_cuda.LAUNCHES)
    out = mk.li_mega_pair(*pair)
    ref = mk.li_mega_pair_plain(*pair)
    assert _cuda.LAUNCHES["K2-pair"] == before["K2-pair"] + 1
    assert torch.isfinite(out).all() and (out[::5] == 0).all()
    assert _rel(out, ref) < 1e-3
    stash = (*tables, o, d, act, sampler.lane, 5, depth, sampler.cnt)
    li, (ids, us, vs) = mk.li_mega_stash(*stash)
    li_p, (ids_p, us_p, vs_p) = mk.li_mega_stash_plain(*stash)
    assert _cuda.LAUNCHES["K2-stash"] == before["K2-stash"] + 1
    assert ids.shape == (1 + 2 * depth, o.shape[0])
    assert _rel(li, li_p) < 1e-3
    same = ids == ids_p
    assert same.float().mean() > 0.999
    assert torch.equal(us[same], us_p[same]) and torch.equal(vs[same],
                                                             vs_p[same])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["pair", "stash"])
def test_k2_at_172_triangles(cuda, mode):
    """K2 pair and stash at the top of its scope, the 172-triangle gallery
    (eleven clusters), against the plain versions: every stashed hit and
    its barycentrics equal (but for f32 ties), the radiance within 1e-3."""
    sd = _gallery(cuda, 2, 1, width=32, spp=8).data
    assert sd.tri.p0.shape[0] == 172 and mk.applicable(sd)
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 8, 2, torch.arange(32 * 32,
                                                        device=cuda))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    act[::5] = False
    tail = (act, sampler.lane, 2, 3, sampler.cnt)
    if mode == "pair":
        args = (*tables, o, d, o.flip(0).contiguous(), d.flip(0).contiguous(),
                *tail)
        out, ref = mk.li_mega_pair(*args), mk.li_mega_pair_plain(*args)
        assert torch.isfinite(out).all() and (out[::5] == 0).all()
        assert _rel(out, ref) < 1e-3
        return
    args = (*tables, o, d, *tail)
    li, (ids, us, vs) = mk.li_mega_stash(*args)
    li_p, (ids_p, us_p, vs_p) = mk.li_mega_stash_plain(*args)
    assert _rel(li, li_p) < 1e-3
    same = ids == ids_p
    assert same.float().mean() > 0.999
    assert torch.equal(us[same], us_p[same]) and torch.equal(vs[same],
                                                             vs_p[same])


@pytest.mark.gpu
@pytest.mark.parametrize("coherent_sweeps", [1, 0],
                         ids=["warp_decided", "compacted"])
def test_k2_tie_case(cuda, coherent_sweeps):
    """K2 in stash mode at depth 0, used as a closest hit, on the tie case
    cut to 180 triangles, through each of its two sweeps: the unculled
    sweep's hits bit for bit, the lowest id of equal distances."""
    p0, e1, e2, ro, rd, low = (torch.from_numpy(x).to(cuda) for x in
                               tie_case(n_tri=180, n_pairs=60, seed=3))
    tri, box = ix.pack_triangles(p0, e1, e2)
    n = ro.shape[0]
    _, (ids, us, vs) = mk._launch_k2(
        "K2-stash", tri, box,
        torch.zeros((mk.ATTR_ROWS, tri.shape[1]), device=cuda),
        torch.zeros((mk.LIGHT_ROWS, 1), device=cuda),
        torch.zeros(2, device=cuda), ro, rd, None,
        torch.ones(n, dtype=torch.bool, device=cuda),
        torch.arange(n, device=cuda), 0, 0, 0, False,
        coherent_sweeps=coherent_sweeps)
    t, want, u, v = ix.sweep_plain(tri, ro.unbind(-1), rd.unbind(-1))
    assert torch.equal(ids[0], want) and torch.equal(us[0], u)
    assert torch.equal(vs[0], v)
    assert (want == low.to(torch.int32)).float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_k3_k4_match_plain(cuda, depth):
    """K3 against li_attached_plain, K4 against its autograd."""
    sd = _scene(cuda).data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 16, 7, torch.arange(32 * 32,
                                                         device=cuda))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    act[::13] = False
    _, hits = mk.li_mega_stash(*tables, o, d, act, sampler.lane, 7, depth,
                               sampler.cnt)
    tabs = [t.detach().contiguous() for t in sm.attached_tables(sd)]
    before = dict(_cuda.LAUNCHES)
    leaves = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    out = sm.li_attached(*leaves[:3], *hits, leaves[3], leaves[4], act,
                         sampler.lane, 7, depth, sampler.cnt)
    ref_in = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    ref = sm.li_attached_plain(*ref_in[:3], *hits, ref_in[3], ref_in[4],
                               act, sampler.lane, 7, depth, sampler.cnt)
    assert _cuda.LAUNCHES["K3"] == before["K3"] + 1
    assert torch.isfinite(out).all()
    assert _rel(out, ref) < 1e-5
    ct = torch.randn(out.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(depth))
    out.backward(ct)
    ref.backward(ct)
    assert _cuda.LAUNCHES["K4"] == before["K4"] + 1
    for name, a, b in zip(("table", "light", "misc", "o", "d"), leaves,
                          ref_in):
        if b.grad is None:
            assert a.grad is None or not a.grad.any(), name
            continue
        assert torch.isfinite(a.grad).all(), name
        assert _rel(a.grad, b.grad) < 1e-4, name


@pytest.mark.gpu
def test_sqrt_correctly_rounded_on_card(cuda):
    """``core.math.safe_sqrt`` gives the same bits on the card, where it
    takes torch's float32 root, as on the CPU, where it rounds the float64
    root once (torch's float32 ``sqrt`` on the CPU is not correctly
    rounded)."""
    from psdr_jit_tpu_torch.core.math import safe_rsqrt, safe_sqrt

    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(2)) * 2
    assert torch.equal(safe_sqrt(x), torch.sqrt(x.double()).float())
    x[:5] = torch.tensor([0.0, -1.0, 1e-30, 4.0, 1e30])  # clamped below
    for fn in (safe_sqrt, safe_rsqrt):
        assert torch.equal(fn(x.to(cuda)).cpu(), fn(x)), fn.__name__


@pytest.mark.gpu
def test_secondary_edge_step_on_card(cuda):
    """loss_and_grad with the secondary-edge term through the kernels
    against the same step on the CPU: the image bit for bit (K1 is, and
    the PyTorch glue runs the same IEEE operations on both devices), the
    loss and gradients up to the order of their sums; K1 launched three
    times a chunk."""
    opts = pt.RenderOption(32, 32, 4, 4, 8)
    sc = _scene(cuda, 32, 32, 4)
    sc.opts = opts
    _cuda.reset_launches()
    loss, grads, img = _train(sc, 2)
    assert _cuda.LAUNCHES["K1"] == 3
    cpu = _scene("cpu", 32, 32, 4)
    cpu.opts = opts
    loss_p, grads_p, img_p = _train(cpu, 2)
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    assert torch.equal(img.cpu(), img_p)
    for k, g in grads_p.items():
        assert _rel(grads[k], g) < 1e-5, k


@pytest.mark.gpu
def test_envmap_step_on_card(cuda):
    """loss_and_grad of BASELINE config #3's stand-in (5,132 triangles, a
    512x1024 map, Microfacet) through K6 against the same step on the CPU:
    only the last bits of ``sin``, ``cos``, ``atan2``, ``acos`` and
    ``exp2`` differ between the two (``[envmap-64]`` of chip_smoke.py
    measured 3.6e-7 in the loss and 3.5e-5 in a gradient); K6 launched 12
    times (3 an interior chunk, 6 a primary-edge chunk, 3 a
    secondary-edge chunk)."""
    steps = []
    for device in (cuda, "cpu"):
        sc = pt.Scene.from_arrays(envmap_arrays(32, 32, 4, 4, 4),
                                  device=device)
        sc.configure()
        _cuda.reset_launches()
        steps.append(pt.PathTracer(1).loss_and_grad(sc, *envmap_setup(sc),
                                                    seed=3))
        if device == cuda:
            assert _cuda.LAUNCHES["K6"] == 12
            assert sum(_cuda.LAUNCHES.values()) == 12
    (loss, grads, img), (loss_p, grads_p, img_p) = steps
    assert abs(float(loss) - float(loss_p)) < 1e-5 * abs(float(loss_p))
    assert _rel(img.cpu(), img_p) < 1e-5
    for k, g in grads_p.items():
        assert float(g.abs().sum()) > 0 and _rel(grads[k], g) < 1e-3, k


@pytest.mark.gpu
def test_training_step_on_card(cuda):
    """loss_and_grad through the kernels against the same step on the CPU
    (the plain versions), with every kernel of the step launched."""
    sc = _scene(cuda, 32, 32, 4)
    sc.opts = pt.RenderOption(32, 32, 4, 4, 0)
    _cuda.reset_launches()
    loss, grads, img = _train(sc, 2)
    launches = dict(_cuda.LAUNCHES)
    for k in ("K2-stash", "K3", "K4", "K2-pair"):
        assert launches[k] > 0, k
    cpu = _scene("cpu", 32, 32, 4)
    cpu.opts = pt.RenderOption(32, 32, 4, 4, 0)
    loss_p, grads_p, img_p = _train(cpu, 2)
    assert abs(float(loss) - float(loss_p)) < 1e-4 * abs(float(loss_p))
    assert _rel(img.cpu(), img_p) < 1e-4
    for k, g in grads_p.items():
        assert grads[k].device == g.device
        assert _rel(grads[k], g) < 1e-3, k


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["one", "distinct", "stash"])
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_k4_hit_patterns(cuda, depth, pattern):
    """K4 against autograd of the plain K3 under three hit patterns of
    32,768 lanes (a warp is one pixel's 32 samples): every lane on the
    same hits (its cotangents all go to the same rows: the most
    contention), every lane of a warp on a different triangle (no two
    lanes share a row), and K2 stash's own hits."""
    sd = _scene(cuda).data
    tables = mk.build_tables(sd)
    o, d, sampler = _camera_rays(sd, 32, 11, torch.arange(32 * 32,
                                                          device=cuda))
    act = torch.ones(o.shape[0], dtype=torch.bool, device=cuda)
    act[::13] = False
    _, hits = mk.li_mega_stash(*tables, o, d, act, sampler.lane, 11, depth,
                               sampler.cnt)
    ids, us, vs = hits
    tabs = [t.detach().contiguous() for t in sm.attached_tables(sd)]
    if pattern == "one":
        # a lane whose hits are all valid; at depth 0 one that sees the
        # light, so that its camera hit gets a cotangent
        ok = (ids >= 0).all(0) & act
        if depth == 0:
            ok &= tabs[0][ids[0].clamp(min=0).long(), sm.ROW_ISEM] > 0.5
        j = int(torch.nonzero(ok)[0])
        ids, us, vs = (x[:, j:j + 1].expand_as(x).contiguous()
                       for x in hits)
    elif pattern == "distinct":
        f = sd.tri.p0.shape[0]
        lane = torch.arange(ids.shape[1], device=cuda)
        ids = torch.stack([(lane + 7 * k) % f for k in range(ids.shape[0])]
                          ).to(torch.int32)
    leaves = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    ref_in = [x.clone().requires_grad_() for x in (*tabs, o, d)]
    args = (ids, us, vs)
    out = sm.li_attached(*leaves[:3], *args, leaves[3], leaves[4], act,
                         sampler.lane, 11, depth, sampler.cnt)
    ref = sm.li_attached_plain(*ref_in[:3], *args, ref_in[3], ref_in[4],
                               act, sampler.lane, 11, depth, sampler.cnt)
    assert torch.isfinite(out).all() and _rel(out, ref) < 1e-5
    ct = torch.randn(out.shape, device=cuda, generator=torch.Generator(
        cuda).manual_seed(depth))
    before = _cuda.LAUNCHES["K4"]
    out.backward(ct)
    ref.backward(ct)
    assert _cuda.LAUNCHES["K4"] == before + 1
    for name, a, b in zip(("table", "light", "misc", "o", "d"), leaves,
                          ref_in):
        if b.grad is None or not b.grad.any():
            assert a.grad is None or not a.grad.any(), name
            continue
        assert torch.isfinite(a.grad).all(), name
        assert _rel(a.grad, b.grad) < 1e-4, (name, _rel(a.grad, b.grad))


@pytest.mark.gpu
def test_k6_tie_case_bitwise(cuda):
    """K6 on the tie case (``chip_smoke.tie_case``: duplicated triangles
    hit at equal distances), in the tree as built and with every node's
    children swapped: the lowest id, bit for bit as the plain traversal
    and the unculled sweep."""
    p0, e1, e2, ro, rd, low = (torch.from_numpy(x).to(cuda)
                               for x in tie_case())
    act = torch.ones(ro.shape[0], dtype=torch.bool, device=cuda)
    h = bvh.build_bvh(p0, e1, e2)
    brute = ix.ray_intersect_brute(p0, e1, e2, ro, rd, act)
    assert (brute[0] == low.to(torch.int32)).float().mean() > 0.5
    for tree in (h, swapped_children(h)):
        t, ids, uv = bvh.walk_cuda(tree, ro, rd, act)
        plain = bvh.ray_intersect_bvh_plain(tree, ro, rd, act)
        for x, y, z in zip((ids, ids >= 0, uv, t), plain, brute):
            assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.gpu
def test_k5_tie_case_bitwise(cuda):
    """K5 on the tie case at 3,000 triangles, in its tree as built and with
    every node's children swapped: the lowest id, bit for bit as the
    unculled sweep."""
    p0, e1, e2, ro, rd, low = (torch.from_numpy(x).to(cuda)
                               for x in tie_case(3000))
    act = torch.ones(ro.shape[0], dtype=torch.bool, device=cuda)
    h = ix.routing_tree(p0, e1, e2)
    brute = ix.ray_intersect_brute(p0, e1, e2, ro, rd, act)
    assert (brute[0] == low.to(torch.int32)).float().mean() > 0.5
    for tree in (h, swapped_children(h)):
        t, ids, uv = bvh.walk_cuda(tree, ro, rd, act, kernel="K5")
        for x, y in zip((ids, ids >= 0, uv, t), brute):
            assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("n_spheres, subdiv, kernel", [(4, 2, "K5"),
                                                       (12, 2, "K5"),
                                                       (4, 3, "K6"),
                                                       (80, 3, "K6")])
def test_k5_k6_match_plain_bitwise(cuda, n_spheres, subdiv, kernel):
    """K5 (1,292 and 3,852 triangles) and K6 (5,132 and 102,412) against
    their plain versions and the unculled sweep, bit for bit, through the
    routing entry."""
    sd = _gallery(cuda, n_spheres, subdiv).data
    tri = sd.tri
    o, d, act = mixed_rays(sd, 1 << 16,
                           torch.Generator(cuda).manual_seed(5), cuda)
    before = dict(_cuda.LAUNCHES)
    out = ix.ray_intersect_detached(tri.p0, tri.e1, tri.e2, pt.Ray(o, d),
                                    act)
    assert _cuda.LAUNCHES[kernel] == before[kernel] + 1
    assert sum(_cuda.LAUNCHES.values()) == sum(before.values()) + 1
    brute = ix.ray_intersect_brute(tri.p0, tri.e1, tri.e2, o, d, act)
    plain = (brute if kernel == "K5" else
             bvh.ray_intersect_bvh_plain(sd.bvh, o, d, act))
    for x, y, z in zip(out, plain, brute):
        assert torch.equal(x, y) and torch.equal(y, z)
    assert not out[1][~act].any() and out[1].float().mean() > 0.5


@pytest.mark.gpu
def test_gallery_render_on_card(cuda, monkeypatch):
    """renderC of the 5,132-triangle gallery through K6 (five launches a
    chunk at depth 2), against the same render on the CPU's plain path,
    and a crop equal to the frame's rows."""
    monkeypatch.setattr(base, "GENERAL_CHUNK_LANES", 128)
    sc = _gallery(cuda, 4, 3)
    integ = pt.PathTracer(2)
    _cuda.reset_launches()
    img = integ.renderC(sc, 0, seed=0)
    assert _cuda.LAUNCHES["K6"] == 5 * 4
    assert sum(_cuda.LAUNCHES.values()) == 5 * 4
    ref = integ.renderC(_gallery("cpu", 4, 3), 0, seed=0)
    assert torch.isfinite(img).all() and img.abs().sum() > 0
    assert _rel(img.cpu(), ref) < 1e-4
    crop = torch.arange(20, 200, 7, device=cuda)
    assert torch.equal(integ.renderC(sc, 0, seed=0, pix_id=crop), img[crop])


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPS)
def test_operator_opcheck(cuda, name):
    """``torch.library.opcheck`` of each kernel's operator at the box's
    shapes: its schema (no input mutated), its fake version against the
    kernel, its autograd registration and its AOT dispatch; K3 with its
    differentiable inputs requiring grad, so K4 runs as its backward."""
    op, args, _ = _op_case(name, _scene(cuda).data)
    if name == "k3":
        args = tuple(a.clone().requires_grad_() if i < 5 else a
                     for i, a in enumerate(args))
    torch.library.opcheck(op, args)


@pytest.mark.gpu
def test_func_jvp_matches_forward_ad_on_card(cuda):
    """``torch.func.jvp`` of renderD on the card (the box at 32x32, spp 4,
    sppe 4, sppse 4, depth 2) along the light's translation: the kernels
    are operators, so functorch's tensors never reach a launch, and the
    primal and tangent equal ``torch.autograd.forward_ad``'s to the order
    of the splats' float atomics (rel L1 1e-6)."""
    sc = _scene(cuda)
    sc.opts = pt.RenderOption(32, 32, 4, 4, 4)
    setup = train_setup(sc)
    params, apply_params, _ = setup
    integ = pt.PathTracer(2)
    p_f, t_f = renderd_tangent(integ, sc, setup, "tx", 1.0)
    _cuda.reset_launches()
    p_j, t_j = func_jvp(integ, sc, lambda v: apply_params(
        {**params, "tx": v}), params["tx"], 1.0)
    assert _cuda.LAUNCHES["K1"] > 0 and _cuda.LAUNCHES["K2-pair"] > 0
    assert float(t_f.abs().sum()) > 0
    assert _rel(p_j, p_f) < 1e-6 and _rel(t_j, t_f) < 1e-6
