"""Texture coordinates and textured BSDFs of psdr_jit_tpu_torch against the
JAX package's, on the CPU: the hit's ``uv``, ``dp_du``, ``dp_dv`` and
UV-aligned shading frame, the UV-seam rule of the primary edges, the
texture's UV transform gradients (``tests/test_texture_transforms.py``'s
cases through the port), the routing of textured scenes, and the slice:
BASELINE config #4's UV-mapped Cornell box (``chip_smoke.
textured_cbox_arrays``: a textured diffuse ``white`` and a textured
Microfacet tall block) at 16x16, spp 4, ``PathTracer(2)``, with 16x16 and
8x8 textures: renderC, the forward-mode renderD tangent along the albedo
texture and one training step with gradients to the three textures and
the radiance.

Both packages draw the same samples (``pcg4d``), so each comparison is
lane for lane. The JAX side runs with ``MEGA_MODE`` "off" and the exact
f32 edge adjoint (``SPLAT_TRANSPOSE = "rows"``). The slice's comparisons
run in a process of their own whose XLA emits no fused multiply-add
(``sliced``), with the port tracing the JAX package's camera rays and
taking its Moller-Trumbore values for the camera hit (``_jax_rays``):
the two packages order the camera transform's and a dot product's sums
differently. Each bound is stated beside its measured value.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import (forward_mode, textured_cameras, textured_cbox_arrays,
                        textured_textures, QUAD_UV)
from psdr_jit_tpu.core.bitmap import Bitmap as JBitmap
from psdr_jit_tpu.core.math import (
    ray_intersect_triangle as j_ray_intersect_triangle)
from psdr_jit_tpu.core.types import Ray as JRay
from psdr_jit_tpu.ops import image as jimage
from psdr_jit_tpu.ops import megakernel as jmk
from psdr_jit_tpu_torch.core import transform as txf
from psdr_jit_tpu_torch.core.bitmap import Bitmap
from psdr_jit_tpu_torch.core.types import Ray
from psdr_jit_tpu_torch.ops import megakernel as mk
from psdr_jit_tpu_torch.ops import shade_mega as sm
from psdr_jit_tpu_torch.scene import scene as tscene
from psdr_jit_tpu_torch.sensor.sensor import SensorData
from scenes import make_cbox
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

W, SPP, DEPTH, SEED = 16, 4, 2, 3
TEX = (16, 8)
TARGET = np.random.default_rng(0).random((W * W, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _jax_modes(fn):
    old = jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE
    jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = "off", "rows"
    try:
        return fn()
    finally:
        jmk.MEGA_MODE, jimage.SPLAT_TRANSPOSE = old


def _jax_textured_box(w=W, spp=SPP, tex=TEX, sppe=SPP):
    """``textured_cbox_arrays``'s scene built through the JAX package's
    API: ``make_cbox``, every quad's UVs, the textures and the three
    cameras."""
    jsc = make_cbox(width=w, height=w, spp=spp, sppe=sppe, sppse=sppe)
    for m in jsc.meshes:
        n_quads = m.num_vertices // 4
        m.load_raw(m.vertex_positions_raw, m.face_indices,
                   np.tile(np.asarray(QUAD_UV, np.float32), (n_quads, 1)),
                   m.face_indices)
    maps = textured_textures(tex)
    jsc.bsdfs[2].reflectance = JBitmap.from_array(maps["albedo"])
    jsc.add_BSDF(psdr.MicrofacetBSDF((0.04, 0.04, 0.04), maps["block"],
                                     maps["roughness"]), "tall")
    jsc.meshes[2].bsdf_id = 5
    for m in textured_cameras()[1:]:
        cam = psdr.PerspectiveCamera(39.0, 1e-6, 1e7)
        cam.to_world = m
        jsc.add_Sensor(cam)
    return jsc


@pytest.fixture(scope="module")
def textured():
    """``(JAX scene, port scene)`` of the slice, both configured."""
    jsc = _jax_textured_box()
    jsc.configure()
    sc = pt.Scene.from_arrays(textured_cbox_arrays(W, W, SPP, SPP, SPP,
                                                   TEX), device=CPU)
    sc.configure()
    return jsc, sc


@contextlib.contextmanager
def _jax_rays(jsc):
    """Make the port trace the JAX package's camera rays and take its
    Moller-Trumbore values for the camera hit's solid-angle
    re-intersection, evaluated op by op (the two packages order the
    camera transform's and a dot product's sums differently), each with
    the port's autograd graph (the cameras carry no parameter here)."""
    jsensors = jax.lax.stop_gradient(jsc.data).sensors
    port_ray = SensorData.sample_primary_ray
    port_hit = tscene.ray_intersect_triangle

    def camera(self, samples, diff=True):
        ray = port_ray(self, samples, diff)
        tw = self.to_world.detach().numpy()
        (js,) = [s for s in jsensors if np.array_equal(s.to_world, tw)]
        with jax.disable_jit():
            j = js.sample_primary_ray(jnp.asarray(samples.detach().numpy()))
        return Ray(_t(j.o) + (ray.o - ray.o.detach()),
                   _t(j.d) + (ray.d - ray.d.detach()))

    def hit(p0, e1, e2, ray):
        uv, t = port_hit(p0, e1, e2, ray)
        a = [jnp.asarray(x.detach().numpy())
             for x in (p0, e1, e2, ray.o, ray.d)]
        with jax.disable_jit():
            juv, jt = j_ray_intersect_triangle(*a[:3], JRay(*a[3:]))
        return _t(juv) + (uv - uv.detach()), _t(jt) + (t - t.detach())

    SensorData.sample_primary_ray, tscene.ray_intersect_triangle = camera, hit
    try:
        yield
    finally:
        SensorData.sample_primary_ray = port_ray
        tscene.ray_intersect_triangle = port_hit


def test_textured_arrays_match_jax_api(textured, sliced):
    """``chip_smoke.textured_cbox_arrays`` (numpy, for the card's machine,
    which has no JAX) equals ``interop.scene_to_arrays`` of the same scene
    built through the JAX package's API, key by key and bit for bit; the
    port rebuilds it with its UVs, textures and cameras."""
    jsc, sc = textured
    want = pt.scene_to_arrays(jsc)
    got = textured_cbox_arrays(W, W, SPP, SPP, SPP, TEX)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(m.has_uv for m in sc.meshes) and sc.data.has_uv
    assert sc.bsdfs[2].reflectance.resolution == (TEX[0], TEX[0])
    assert not sc.bsdfs[5].roughness.is_constant
    assert len(sc.sensors) == 4


# ---------------------------------------------------------------------------
# hits, UV frames and UV seams
# ---------------------------------------------------------------------------

def _seam_scene():
    """A JAX scene of a strip of three 1x3 quads over eight shared vertices
    in the plane z = 0, seen face on: the first two quads' UVs meet at a seam
    (their shared edge has no shared UV row), the third quad's UVs are
    collapsed to one point (``det == 0``: the frame of the normal); a
    textured diffuse, an area light and edges on, sppe 2."""
    sc = psdr.Scene()
    sc.opts.width = sc.opts.height = 16
    sc.opts.spp = sc.opts.sppe = 2
    cam = psdr.PerspectiveCamera(45.0, 1e-3, 1e3)
    cam.to_world = np.asarray([[-1.0, 0, 0, 1.5], [0, 1, 0, 1.5],
                               [0, 0, -1, 4.0], [0, 0, 0, 1]], np.float32)
    sc.add_Sensor(cam)
    tex = np.random.default_rng(5).random((8, 8, 3)).astype(np.float32)
    sc.add_BSDF(psdr.DiffuseBSDF(JBitmap.from_array(tex)), "tex")
    sc.add_BSDF(psdr.DiffuseBSDF([0.0] * 3), "black")
    strip = psdr.Mesh()
    strip.use_face_normals = False
    verts = np.asarray([[x, y, 0.0] for y in (0, 3) for x in (0, 1, 2, 3)],
                       np.float32)
    faces = np.asarray([[0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                        [2, 6, 7], [2, 7, 3]], np.int32)
    uvs = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0],     # quad 0
                      [0.1, 0.2], [0.3, 0.9], [0.8, 0.7], [0.9, 0.1],
                      [0.5, 0.5]], np.float32)            # quad 2
    face_uvs = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7],
                           [8, 8, 8], [8, 8, 8]], np.int32)
    strip.load_raw(verts, faces, uvs, face_uvs)
    sc.add_Mesh(strip, None, "tex")
    light = psdr.Mesh()
    light.use_face_normals = True
    light.enable_edges = False
    light.load_raw(np.asarray([[1, 1.3, 2], [2, 1.3, 2], [2, 1.7, 2],
                               [1, 1.7, 2]], np.float32),
                   np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    sc.add_Mesh(light, None, "black", psdr.AreaLight([5.0] * 3))
    return sc


@pytest.fixture(scope="module")
def seam():
    jsc = _seam_scene()
    jsc.configure()
    sc = pt.Scene.from_arrays(pt.scene_to_arrays(jsc), device=CPU)
    sc.configure()
    return jsc, sc


@pytest.mark.parametrize("scene", ["box", "seam"])
def test_hit_uv_and_frame_match_jax(textured, seam, scene):
    """The hit's ``uv``, ``dp_du``, ``dp_dv`` and shading frame against
    JAX ``SceneData.ray_intersect`` (path mode) on 4,096 camera rays of
    the textured box (shared-corner quads, det != 0 everywhere) and of the
    seam strip (a seam and a collapsed, det == 0, quad), eagerly on both
    sides. Hit ids equal; measured rel L1 at most: uv 9.2e-8, dp_du and
    dp_dv 0, the frame's s and t 1.3e-8, n 0, wi 3.6e-8 (bound 1e-6)."""
    jsc, sc = textured if scene == "box" else seam
    rng = np.random.default_rng(7)
    samples = torch.from_numpy(rng.random((4096, 2)).astype(np.float32))
    ray = sc.data.sensors[0].sample_primary_ray(samples, diff=False)
    its = sc.data.ray_intersect(ray)
    jits = jax.lax.stop_gradient(jsc.data).ray_intersect(
        JRay(jnp.asarray(ray.o.numpy()), jnp.asarray(ray.d.numpy())))
    np.testing.assert_array_equal(its.tri_id.numpy(), np.asarray(jits.tri_id))
    ok = its.valid.numpy()
    assert ok.mean() > 0.5
    pairs = {"uv": (its.uv, jits.uv), "dp_du": (its.dp_du, jits.dp_du),
             "dp_dv": (its.dp_dv, jits.dp_dv),
             "s": (its.sh_frame.s, jits.sh_frame.s),
             "t": (its.sh_frame.t, jits.sh_frame.t),
             "n": (its.sh_frame.n, jits.sh_frame.n), "wi": (its.wi, jits.wi)}
    for k, (a, b) in pairs.items():
        a, b = a.detach().numpy()[ok], np.asarray(b)[ok]
        assert _rel(a, b) < 1e-6, (k, _rel(a, b))
    if scene == "seam":
        # the collapsed quad keeps the normal's frame: dp_du = 0 there
        flat = ok & (its.tri_id.numpy() >= 4)
        assert flat.any() and not its.dp_du.numpy()[flat].any()
        assert np.abs(its.dp_du.numpy()[ok & ~flat]).sum() > 0


def test_tri_uv_follows_the_morton_order():
    """Above 256 faces the scene compile permutes the triangles into the
    Morton order of their centroids; each face's UVs go with it: the
    port's ``tri_uv`` equals the JAX package's, row for row, on a 20x8
    grid of quads (320 faces) with per-vertex UVs added to the seam
    strip's scene (328 faces)."""
    sc = _seam_scene()
    n = 20
    xs, ys = np.meshgrid(np.linspace(-2, 2, n + 1), np.linspace(0, 1, 9))
    verts = np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, -0.5)],
                     -1).astype(np.float32)
    q = (np.arange(8)[:, None] * (n + 1) + np.arange(n)[None]).ravel()
    faces = np.concatenate([np.stack([q, q + n + 1, q + n + 2], -1),
                            np.stack([q, q + n + 2, q + 1], -1)]).astype(
        np.int32)
    grid = psdr.Mesh()
    grid.load_raw(verts, faces, verts[:, :2] * 0.25 + 0.5, faces)
    sc.add_Mesh(grid, None, "tex")
    sc.opts.sppe = 0
    sc.configure()
    tsc = pt.Scene.from_arrays(pt.scene_to_arrays(sc), device=CPU)
    sd = tsc.configure()
    assert tsc._tri_perm is not None and sd.tri_uv.shape == (328, 3, 2)
    np.testing.assert_array_equal(sd.tri_uv.numpy(),
                                  np.asarray(sc.data.tri_uv))
    np.testing.assert_array_equal(sd.tri.p0.numpy(),
                                  np.asarray(sc.data.tri.p0))


def test_uv_seam_is_a_primary_edge(seam):
    """The primary-edge table of the seam strip equals JAX
    ``build_primary_edges``': its screen lengths bit for bit, the seam
    (the edge of vertices 1 and 5) kept though it is no silhouette, the
    diagonals inside a quad (two shared UV rows) dropped, and the edge
    between the second and the collapsed quad (no shared UV row) kept."""
    jsc, sc = seam
    ei = sc.meshes[0]._edge_rows
    got = sc.data.sensors[0].edge_info.edge_length.numpy()
    want = np.asarray(jsc.data.sensors[0].edge_info.edge_length)
    np.testing.assert_array_equal(got, want)
    ends = [tuple(r[:2]) for r in ei]
    assert got[ends.index((1, 5))] > 0 and got[ends.index((2, 6))] > 0
    assert got[ends.index((0, 5))] == 0 and got[ends.index((1, 6))] == 0


# ---------------------------------------------------------------------------
# the UV transform's gradients (tests/test_texture_transforms.py)
# ---------------------------------------------------------------------------

def _smooth_tex(n=16):
    y, x = np.mgrid[0:n, 0:n] / n
    tex = np.stack([np.sin(2 * np.pi * x), np.cos(2 * np.pi * y),
                    x * y], -1).astype(np.float32) * 0.5 + 0.5
    return tex


def test_uv_translate_gradient():
    """d/d trans of a textured lookup against central differences (the
    JAX test's bounds: rtol 5e-2, atol 1e-3)."""
    b = Bitmap.from_array(_smooth_tex())
    uv = _t(np.random.default_rng(0).uniform(0.2, 0.8, (512, 2)).astype(
        np.float32))

    def loss(t):
        b.trans = t
        return b.eval(uv).sum()

    t0 = torch.zeros(2, requires_grad=True)
    (g,) = torch.autograd.grad(loss(t0), t0)
    eps = 1e-3
    for k in range(2):
        v = torch.zeros(2)
        v[k] = eps
        fd = (float(loss(v)) - float(loss(-v))) / (2 * eps)
        np.testing.assert_allclose(float(g[k]), fd, rtol=5e-2, atol=1e-3)


def test_uv_rotation_scale_gradient():
    """d/d rot and d/d scale against central differences (rtol 5e-2, atol
    1e-2, as the JAX test)."""
    b = Bitmap.from_array(_smooth_tex())
    uv = _t(np.random.default_rng(1).uniform(0.3, 0.7, (512, 2)).astype(
        np.float32))

    def loss(rot, scale):
        b.rot, b.scale = rot, scale
        return b.eval(uv).sum()

    r0 = torch.tensor(0.3, requires_grad=True)
    s0 = torch.tensor(1.2, requires_grad=True)
    g_rot, g_scale = torch.autograd.grad(loss(r0, s0), (r0, s0))
    eps = 1e-3
    fd_rot = (float(loss(torch.tensor(0.3 + eps), torch.tensor(1.2)))
              - float(loss(torch.tensor(0.3 - eps), torch.tensor(1.2)))) / (
        2 * eps)
    fd_scale = (float(loss(torch.tensor(0.3), torch.tensor(1.2 + eps)))
                - float(loss(torch.tensor(0.3), torch.tensor(1.2 - eps)))) / (
        2 * eps)
    np.testing.assert_allclose(float(g_rot), fd_rot, rtol=5e-2, atol=1e-2)
    np.testing.assert_allclose(float(g_scale), fd_scale, rtol=5e-2,
                               atol=1e-2)


def test_textured_floor_uv_translate_in_render():
    """The UV translation's gradient through a full renderD of a UV-mapped
    floor under an orthographic camera (16x16, spp 4), reverse mode,
    against central differences of the same render (rtol 0.15, atol 1e-4,
    as the JAX test); the gradient reaches the bitmap through the scene
    compile's parameter map."""
    sc = pt.Scene(device=CPU)
    sc.opts = pt.RenderOption(16, 16, 4, 0, 0)
    cam = pt.OrthographicCamera(0.1, 100.0)
    cam.to_world = txf.look_at(torch.tensor([0.0, 0.0, 10.0]),
                               torch.tensor([0.0, 0.0, 0.0]),
                               torch.tensor([0.0, 1.0, 0.0]))
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF(Bitmap.from_array(_smooth_tex())), "tex")
    sc.add_BSDF(pt.DiffuseBSDF([0.0] * 3), "black")
    floor = pt.Mesh()
    floor.use_face_normals = True
    floor.load_raw(
        np.asarray([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                   np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        uvs=np.asarray([[0.1, 0.1], [0.9, 0.1], [0.9, 0.9], [0.1, 0.9]],
                       np.float32),
        face_uvs=np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    sc.add_Mesh(floor, None, "tex")
    light = pt.Mesh()
    light.use_face_normals = True
    light.enable_edges = False
    light.load_raw(np.asarray([[-0.3, -0.3, 4], [0.3, -0.3, 4],
                               [0.3, 0.3, 4], [-0.3, 0.3, 4]], np.float32),
                   np.asarray([[0, 2, 1], [0, 3, 2]], np.int32))
    sc.add_Mesh(light, None, "black", pt.AreaLight([60.0] * 3))
    sc.configure()
    integ = pt.PathTracer(1)
    bmp = sc.param_map["BSDF[id=tex]"].reflectance

    def loss(t):
        bmp.trans = t
        return integ.renderD(sc, 0, seed=0).mean()

    t0 = torch.zeros(2, requires_grad=True)
    (g,) = torch.autograd.grad(loss(t0), t0)
    eps = 5e-3
    fd = (float(loss(torch.tensor([eps, 0.0])))
          - float(loss(torch.tensor([-eps, 0.0])))) / (2 * eps)
    assert torch.isfinite(g).all() and abs(float(g[0])) > 0
    np.testing.assert_allclose(float(g[0]), fd, rtol=0.15, atol=1e-4)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_textured_scene_leaves_the_megakernels(textured, monkeypatch):
    """A textured scene takes none of K2, K3 and K4 (their entries raise
    here) in renderC and in a training step; the same UV-mapped box with
    the textures replaced by constants still takes K2 (single and pair),
    K2 stash and K3 (their plain versions, on the CPU)."""
    sc = pt.Scene.from_arrays(textured_cbox_arrays(8, 8, 1, 1, 0, TEX),
                              device=CPU)
    assert not mk.applicable(sc.configure()) and not sm.applicable(sc.data)
    calls = []
    for mod, name in ((mk, "li_mega"), (mk, "li_mega_pair"),
                      (mk, "li_mega_stash"), (sm, "li_attached")):
        def count(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, count)
    pt.PathTracer(2).renderC(sc, 1, seed=0)
    tex = sc.bsdfs[2].reflectance.data

    def apply(p):
        sc.bsdfs[2].reflectance.data = p["alb"]

    _, g, _ = pt.PathTracer(2).loss_and_grad(
        sc, {"alb": tex.clone()}, apply, lambda rows, pix: rows.sum(-1))
    assert not calls and float(g["alb"].abs().sum()) > 0
    const = textured_cbox_arrays(8, 8, 1, 1, 0, TEX)
    const["bsdf.2.reflectance.data"] = np.full((1, 1, 3), 0.9, np.float32)
    del const["bsdf.5.type"]
    for name in ("specularReflectance", "diffuseReflectance", "roughness"):
        del const[f"bsdf.5.{name}.data"], const[f"bsdf.5.{name}.uv"]
    const["bsdf.5.reflectance"] = np.full(3, 0.5, np.float32)
    sc = pt.Scene.from_arrays(const, device=CPU)
    assert sc.configure().has_uv and mk.applicable(sc.data)
    pt.PathTracer(2).renderC(sc, 0, seed=0)
    pt.PathTracer(2).loss_and_grad(
        sc, {"alb": sc.bsdfs[2].reflectance.data.clone()},
        apply, lambda rows, pix: rows.sum(-1))
    assert set(calls) == {"li_mega", "li_mega_pair", "li_mega_stash",
                          "li_attached"}


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------

TEXTURE_PARAMS = {"alb": (2, "reflectance"), "blk": (5, "diffuseReflectance"),
                  "rough": (5, "roughness")}
RENDERC_SENSORS = (0, 2)
# XLA's CPU code generation limited to AVX, which has no fused multiply-add:
# the JAX package then rounds every product as the port does
SLICE_XLA_FLAGS = "--xla_cpu_max_isa=AVX"


def _slice_params(sc):
    """The slice's start: every texture at 0.5, the radiance x 1.5 (numpy
    arrays, for both packages)."""
    p = {k: np.full(np.shape(getattr(sc.bsdfs[j], name).data), 0.5,
                    np.float32) for k, (j, name) in TEXTURE_PARAMS.items()}
    p["rad"] = (1.5 * np.asarray(sc.emitters[0].radiance)).astype(np.float32)
    return p


def _direction(shape):
    return np.random.default_rng(8).standard_normal(shape).astype(np.float32)


def _jax_slice(jsc):
    """The JAX package's renderC from ``RENDERC_SENSORS``, renderD's primal
    and forward-mode tangent along ``_direction`` of the albedo texture,
    and the training step from ``_slice_params``, as numpy arrays."""
    integ = psdr.PathTracer(DEPTH)
    out = {f"renderC_{s}": np.asarray(_jax_modes(
        lambda: integ.renderC(jsc, s, seed=SEED))) for s in RENDERC_SENSORS}
    refl = jsc.bsdfs[2].reflectance
    base = refl.data

    def jr(d):
        refl.data = base + d
        return integ.renderD(jsc, 0, seed=SEED)

    try:
        primal, tangent = _jax_modes(lambda: jax.jvp(
            jr, (jnp.zeros_like(base),),
            (jnp.asarray(_direction(np.shape(base))),)))
    finally:
        refl.data = base
    out["primal"], out["tangent"] = primal, tangent
    tgt = jnp.asarray(TARGET)
    saved = {k: getattr(jsc.bsdfs[j], name).data
             for k, (j, name) in TEXTURE_PARAMS.items()}

    def apply(p):
        for k, (j, name) in TEXTURE_PARAMS.items():
            getattr(jsc.bsdfs[j], name).data = p[k]
        jsc.emitters[0].radiance = p["rad"]

    rad = jsc.emitters[0].radiance
    try:
        loss, grads, img = _jax_modes(lambda: integ.loss_and_grad(
            jsc, {k: jnp.asarray(v) for k, v in _slice_params(jsc).items()},
            apply, lambda rows, pix: jnp.sum(jnp.square(rows - tgt[pix]), -1),
            seed=SEED))
    finally:
        apply({**saved, "rad": rad})
    out["loss"], out["image"] = loss, img
    out.update({f"grad_{k}": v for k, v in grads.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _port_slice(sc):
    """The port's side of :func:`_jax_slice`."""
    integ = pt.PathTracer(DEPTH)
    out = {f"renderC_{s}": integ.renderC(sc, s, seed=SEED)
           for s in RENDERC_SENSORS}
    refl = sc.bsdfs[2].reflectance

    def set_data(v):
        refl.data = v

    out["primal"], out["tangent"] = forward_mode(
        integ, sc, set_data, refl.data.clone(), _direction(refl.data.shape),
        seed=SEED)
    p0 = _slice_params(sc)

    def apply(p):
        for k, (j, name) in TEXTURE_PARAMS.items():
            getattr(sc.bsdfs[j], name).data = p[k]
        sc.emitters[0].radiance = p["rad"]

    tgt = _t(TARGET)
    loss, grads, out["image"] = integ.loss_and_grad(
        sc, pt.params_to_torch(p0, device=CPU), apply,
        lambda rows, pix: ((rows - tgt[pix]) ** 2).sum(-1), seed=SEED)
    out["loss"] = loss
    out.update({f"grad_{k}": v for k, v in grads.items()})
    return {k: v.detach().numpy() for k, v in out.items()}


def slice_results(path):
    """Both packages' slice (sppe = sppse = 0: the edge terms move with
    geometry only, so no texture or radiance gradient has one), the port
    tracing the JAX package's rays (:func:`_jax_rays`); saved to ``path``
    (``.npz``, keys ``jax/...`` and ``port/...``). Run by :func:`sliced`
    in a process of its own."""
    jsc = _jax_textured_box(sppe=0)
    jsc.configure()
    sc = pt.Scene.from_arrays(textured_cbox_arrays(W, W, SPP, 0, 0, TEX),
                              device=CPU)
    sc.configure()
    torch.set_num_threads(1)
    with _jax_rays(jsc):
        port = _port_slice(sc)
    ref = _jax_slice(jsc)
    np.savez(path, **{f"jax/{k}": v for k, v in ref.items()},
             **{f"port/{k}": v for k, v in port.items()})


@pytest.fixture(scope="module")
def sliced(tmp_path_factory):
    """``(jax, port)`` dicts of :func:`slice_results`, computed once in a
    process whose XLA emits no fused multiply-add (``SLICE_XLA_FLAGS``,
    read when XLA starts, so not in this process, whose XLA other modules
    share): XLA's CPU compiler contracts multiply-adds inside jitted
    functions, which moves hit points by an ulp and flips a few grazing
    shadow tests of the box (7.9e-4 rel L1 in renderD's primal; the JAX
    package's jitted and op-by-op renderD differ by 8.4e-4). Started by
    the module's first test, collected by the first slice test."""
    path = tmp_path_factory.mktemp("texture_slice") / "slice.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        filter(None, (os.environ.get("XLA_FLAGS"), SLICE_XLA_FLAGS))))
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "import test_torch_texture as t; t.slice_results({!r})").format(
                ROOT, HERE, str(path))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    cache = []

    def result():
        if not cache:
            assert proc.wait(timeout=900) == 0, "the slice's process failed"
            with np.load(path) as z:
                cache.extend({k[len(side) + 1:]: z[k] for k in z.files
                              if k.startswith(side + "/")}
                             for side in ("jax", "port"))
        return cache

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_slice_renderC_matches_jax(sliced):
    """renderC of the textured box from two of its sensors (measured rel
    L1 2.4e-6 and 6.6e-7, bound 1e-5)."""
    ref, out = sliced()
    for s in RENDERC_SENSORS:
        jimg = ref[f"renderC_{s}"]
        assert float(np.abs(jimg).sum()) > 0
        assert _rel(out[f"renderC_{s}"], jimg) < 1e-5, s


def test_slice_renderD_tangent_matches_jax(sliced):
    """renderD's forward-mode gradient image along a seeded direction of
    the albedo texture: measured rel L1 primal 1.1e-7 (bound 1e-5),
    tangent 6.1e-7 (bound 2e-3)."""
    ref, out = sliced()
    assert float(np.abs(ref["tangent"]).sum()) > 0
    assert _rel(out["primal"], ref["primal"]) < 1e-5
    assert _rel(out["tangent"], ref["tangent"]) < 2e-3


def test_slice_step_matches_jax(sliced):
    """One training step of the L2 loss against a seeded target, with
    gradients to the three textures and the radiance, from the slice's
    start (textures 0.5, radiance x 1.5): measured rel loss 1.1e-7, image
    4.0e-8 (bounds 1e-5), gradients albedo 5.3e-7, block 1.0e-6,
    roughness 1.2e-6, radiance 2.6e-8 (bounds 1e-4)."""
    ref, out = sliced()
    jl = float(ref["loss"])
    assert abs(float(out["loss"]) - jl) / abs(jl) < 1e-5
    assert _rel(out["image"], ref["image"]) < 1e-5
    for k in (*TEXTURE_PARAMS, "rad"):
        want = ref[f"grad_{k}"]
        assert out[f"grad_{k}"].shape == want.shape, k
        assert np.abs(want).sum() > 0, k
        assert _rel(out[f"grad_{k}"], want) < 1e-4, k
