"""K7, the closest hit rebuilt from the closest-hit kernels' payload
(``ops/hit_rebuild.py``, ``csrc/hit_rebuild.cu``), against the plain
rebuild (``SceneData._rebuild_plain``).

The tests marked ``gpu`` need a CUDA card and skip without one. This file
imports no JAX: run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_hit_rebuild.py

On the card, on ``chip_smoke.mixed_rays`` (every seventh lane dead) of the
Cornell box (32 triangles), the 492- and 102,412-triangle galleries, the
UV-mapped box (``has_uv``) and the box with a per-vertex BSDF
(``has_pv``), in path and solid mode: K7 equals the plain rebuild bit for
bit; K7-jvp equals forward-mode AD of it to f32 rounding; K7-vjp's rays'
cotangents equal autograd's to f32 rounding, and its tables' row sums,
float atomics (shared-memory partials up to 512 rows, global atomics
above), are as close to the float64 adjoint as autograd's are; on the
UV-mapped box also with the corner UVs differentiated. The unmarked tests
check, on any machine, that the CPU path is the plain rebuild and launches
no K7, and that K7's launchers refuse CPU tensors.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import psdr_jit_tpu_torch as pt
from chip_smoke import (K1_GALLERY, PlainCalls, bsdf_cbox_arrays,
                        gallery_arrays, k7_adjoint_errors, k7_adjoint_ok,
                        k7_args, k7_case, k7_fields, k7_jvp_args,
                        k7_plain_jvp, rel_l1, table_scene,
                        textured_cbox_arrays)
from psdr_jit_tpu_torch.core.types import Ray
from psdr_jit_tpu_torch.ops import _cuda
from psdr_jit_tpu_torch.ops import hit_rebuild
from psdr_jit_tpu_torch.utils import profiling
from torch_threads import _one_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "cbox_scene.npz")
LANES = 1 << 16
SCENES = ("cbox", "gallery492", "gallery102k", "textured", "pv")


def _arrays(name):
    if name == "cbox":
        return dict(np.load(NPZ))
    if name == "gallery492":
        return gallery_arrays(**K1_GALLERY)
    if name == "gallery102k":
        return gallery_arrays(16, 16, 2, 80, 3)
    if name == "textured":
        return textured_cbox_arrays(16, 16, 2, 0, 0, tex=(16, 8))
    return bsdf_cbox_arrays("pv", 16, 16, 2, 0, 0)


_SCENES = {}


def _scene_data(name, device):
    """The scene's data on ``device``, built once a module."""
    key = (name, str(device))
    if key not in _SCENES:
        sc = pt.Scene.from_arrays(_arrays(name), device=device)
        _SCENES[key] = sc.configure()
    return _SCENES[key]


def _case(name, device, seed=0):
    sd = _scene_data(name, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return sd, gen, *k7_case(sd, LANES, gen, torch.device(device))


# ---- on any machine -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["path", "solid"])
def test_cpu_path_is_plain_and_launches_no_k7(mode):
    """On the CPU ``ray_intersect`` rebuilds the hit in PyTorch, equal to
    the plain rebuild of its own payload, and launches nothing."""
    sd, _, ray, active, payload = _case("cbox", "cpu")
    _cuda.reset_launches()
    its = sd.ray_intersect(ray, active, mode=mode)
    assert torch.equal(its.tri_id, payload[0])
    want = sd._rebuild_plain(ray, *payload, mode)
    for a, b in zip(k7_fields(its, mode == "solid", False),
                    k7_fields(want, mode == "solid", False)):
        assert torch.equal(a, b)
    assert torch.equal(its.mesh_id, want.mesh_id)
    assert not any(_cuda.LAUNCHES.values())


@pytest.mark.parametrize("launcher", ["rebuild_cuda", "rebuild_tangent_cuda",
                                      "rebuild_adjoint_cuda"])
def test_k7_launchers_refuse_cpu_tensors(launcher):
    """K7's launchers raise on CPU tensors, never fall back."""
    sd, _, ray, _, payload = _case("cbox", "cpu")
    args = k7_args(sd, ray, payload, True)
    if launcher == "rebuild_cuda":
        call = (args,)
    elif launcher == "rebuild_tangent_cuda":
        call = (k7_jvp_args(args, None, (None, None)),)
    else:
        call = ((*args[:9], [None] * len(hit_rebuild.FIELDS)),)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(hit_rebuild, launcher)(*call[0])


# ---- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "solid"])
@pytest.mark.parametrize("scene", SCENES)
def test_k7_matches_plain_bitwise(cuda, scene, mode):
    """K7 through ``ray_intersect`` (one launch; the span counts every lane
    ``fused``) against the plain rebuild of the same payload: every field
    bit for bit, with dead lanes and misses."""
    sd, _, ray, active, payload = _case(scene, cuda)
    assert sd.has_uv == (scene == "textured")
    assert sd.has_pv == (scene == "pv")
    solid = mode == "solid"
    before = dict(_cuda.LAUNCHES)
    with profiling.recorder() as rec:
        got = sd.ray_intersect(ray, active, mode=mode)
        counters = rec.totals()["counters"]["hits"]
    assert _cuda.LAUNCHES["K7"] == before["K7"] + 1
    assert counters["fused"] == counters["rays"] == LANES
    want = sd._rebuild_plain(ray, *payload, mode)
    for name, a, b in zip(hit_rebuild.FIELDS,
                          k7_fields(got, solid, sd.has_uv),
                          k7_fields(want, solid, sd.has_uv)):
        assert torch.equal(a, b), name
    for name in ("tri_id", "valid", "mesh_id", "face_indices", "uv",
                 "dp_du", "dp_dv"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not bool(payload[1].all()) and bool(payload[1].any())


# the textured box with its corner UVs differentiated too
DIFF_CASES = [(s, False) for s in SCENES] + [("textured", True)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "solid"])
@pytest.mark.parametrize("scene,uv_diff", DIFF_CASES)
def test_k7_jvp_matches_forward_ad(cuda, scene, uv_diff, mode):
    """K7-jvp along dense tangents of the face table, the rays and, with
    ``uv_diff``, the corner UVs against forward-mode AD of the plain
    rebuild (rel L1 1e-5 a field)."""
    sd, gen, ray, _, payload = _case(scene, cuda, seed=1)
    solid = mode == "solid"
    args = k7_args(sd, ray, payload, solid)
    table = args[0]
    table_t = torch.randn(table.shape, generator=gen, device=cuda)
    ray_t = (torch.randn(ray.o.shape, generator=gen, device=cuda),
             torch.randn(ray.d.shape, generator=gen, device=cuda))
    uvt_t = (torch.randn(args[2].shape, generator=gen, device=cuda)
             if uv_diff else None)
    got = hit_rebuild.rebuild_tangent_cuda(*k7_jvp_args(args, table_t, ray_t,
                                                        uvt_t))
    want = k7_plain_jvp(sd, table, table_t, ray, ray_t, payload, solid,
                        uvt_t)
    for name, a, b in zip(hit_rebuild.FIELDS, got, want):
        assert a.shape == b.shape, name
        assert rel_l1(a, b) < 1e-5, name


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "solid"])
@pytest.mark.parametrize("scene,uv_diff", [
    ("cbox", False), ("gallery492", False), ("gallery102k", False),
    ("textured", False), ("textured", True)])
def test_k7_vjp_matches_autograd(cuda, scene, uv_diff, mode):
    """K7-vjp for dense cotangents of every field against autograd of the
    plain rebuild (``chip_smoke.k7_adjoint_ok``): the rays' cotangents, one
    a lane, within 1e-5 rel L1 of autograd's; the table's row sums (shared
    memory at 32 and 492 rows, global atomics at 102,412), and the corner
    UVs' with ``uv_diff``, no further from the float64 adjoint than twice
    autograd's, or than the rounding of a float32 sum of a row's lanes
    where both lie below it."""
    sd, gen, ray, _, payload = _case(scene, cuda, seed=2)
    solid = mode == "solid"
    args = k7_args(sd, ray, payload, solid)
    cts = [torch.randn(s, generator=gen, device=cuda)
           for s in hit_rebuild._shapes(LANES, solid, sd.has_uv)]
    got = hit_rebuild.rebuild_adjoint_cuda(*args[:9], cts, uv_diff)
    err = k7_adjoint_errors(got, sd, args[0], ray, payload, solid, cts,
                            uv_diff)
    assert got[0].abs().sum() > 0
    assert not uv_diff or got[3].abs().sum() > 0
    assert k7_adjoint_ok(err), err


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "solid"])
def test_k7_through_autograd_and_forward_ad(cuda, mode):
    """``ray_intersect`` on attached tables and rays: reverse mode runs
    K7-vjp, forward mode K7-jvp, and each equals the plain rebuild's to
    f32 rounding (rel L1 1e-5; the table by its float64 adjoint's
    bound)."""
    import torch.autograd.forward_ad as fwAD

    sd, gen, ray, _, payload = _case("cbox", cuda, seed=3)
    solid = mode == "solid"
    o = ray.o.clone().requires_grad_()
    before = dict(_cuda.LAUNCHES)
    its = sd._rebuild_k7(Ray(o, ray.d), *payload, solid)
    its_p = sd._rebuild_plain(Ray(o, ray.d), *payload, mode)
    w = torch.randn(its.p.shape, generator=gen, device=cuda)
    (g,) = torch.autograd.grad((its.p * w).sum() + its.t.sum(), o)
    (g_p,) = torch.autograd.grad((its_p.p * w).sum() + its_p.t.sum(), o)
    assert _cuda.LAUNCHES["K7-vjp"] == before["K7-vjp"] + 1
    assert rel_l1(g, g_p) < 1e-5
    with fwAD.dual_level():
        o_t = torch.randn(ray.o.shape, generator=gen, device=cuda)
        r = Ray(fwAD.make_dual(ray.o, o_t), ray.d)
        t = fwAD.unpack_dual(sd._rebuild_k7(r, *payload, solid).wi).tangent
        t_p = fwAD.unpack_dual(sd._rebuild_plain(r, *payload, mode).wi
                               ).tangent
    assert _cuda.LAUNCHES["K7-jvp"] == before["K7-jvp"] + 1
    assert rel_l1(t, t_p) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["path", "solid"])
def test_k7_differentiates_corner_uvs(cuda, mode):
    """``ray_intersect`` on the UV-mapped box whose corner UVs carry a
    gradient or a tangent runs K7, K7-vjp and K7-jvp (no plain version):
    the UVs' gradient is no further from the float64 adjoint than twice
    autograd's of the plain rebuild, and the tangents of the texture
    coordinates, UV tangents, frame and local direction equal forward-mode
    AD's (rel L1 1e-5)."""
    import torch.autograd.forward_ad as fwAD

    sd, gen, ray, active, payload = _case("textured", cuda, seed=4)
    solid = mode == "solid"
    uvt = sd.tri_uv.detach()
    w = [torch.randn(s, generator=gen, device=cuda)
         for s in ((LANES, 2), (LANES, 3), (LANES, 3), (LANES, 3))]

    def loss(its):
        return sum((x.reshape(w_.shape) * w_.to(x.dtype)).sum()
                   for x, w_ in zip((its.uv, its.dp_du, its.sh_frame.s,
                                     its.wi), w))

    def uv_grad(rebuild, dtype=torch.float32):
        leaf = uvt.to(dtype).clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(rebuild(leaf)), leaf)
        return g

    def plain64(leaf):
        table = hit_rebuild.face_table(sd.tri).detach().double()
        sd64 = table_scene(sd, table, leaf.reshape(-1, 6))
        return sd64._rebuild_plain(
            Ray(ray.o.double(), ray.d.double()), *payload, mode)

    before = dict(_cuda.LAUNCHES)
    with PlainCalls() as plain:
        g = uv_grad(lambda leaf: dataclasses.replace(
            sd, tri_uv=leaf).ray_intersect(ray, active, mode=mode))
        with fwAD.dual_level():
            uvt_t = torch.randn(uvt.shape, generator=gen, device=cuda)
            its = dataclasses.replace(
                sd, tri_uv=fwAD.make_dual(uvt, uvt_t)).ray_intersect(
                ray, active, mode=mode)
            tangents = [fwAD.unpack_dual(x).tangent for x in (
                its.uv, its.dp_du, its.sh_frame.s, its.wi)]
    assert plain.count == 0
    assert {k: _cuda.LAUNCHES[k] - before[k] for k in
            ("K7", "K7-jvp", "K7-vjp")} == {"K7": 2, "K7-jvp": 1,
                                            "K7-vjp": 1}
    g_p = uv_grad(lambda leaf: dataclasses.replace(
        sd, tri_uv=leaf)._rebuild_plain(ray, *payload, mode))
    g64 = uv_grad(plain64, torch.float64)
    assert g.abs().sum() > 0
    assert rel_l1(g.double(), g64) <= max(
        2 * rel_l1(g_p.double(), g64), 1e-6)
    with fwAD.dual_level():
        its_p = dataclasses.replace(
            sd, tri_uv=fwAD.make_dual(uvt, uvt_t))._rebuild_plain(
            ray, *payload, mode)
        want = [fwAD.unpack_dual(x).tangent for x in (
            its_p.uv, its_p.dp_du, its_p.sh_frame.s, its_p.wi)]
    for a, b in zip(tangents, want):
        assert rel_l1(a, b) < 1e-5
