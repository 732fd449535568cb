"""The reference-compatible surface of psdr_jit_tpu_torch (the JAX
package's ``__init__`` and ``tests/test_api_compat.py``) on the CPU.

Each test of ``tests/test_api_compat.py`` has its counterpart here on the
port, and the new methods are held against the JAX package on the same
inputs, eagerly (no jitted JAX function is compiled):

* ``Mesh.edge_indices()`` equal; ``vertex_normals`` within 1e-6 (measured
  6e-8); ``set_transform``/``append_transform`` of meshes, cameras and the
  environment map give the same ``to_world_left``/``to_world_right`` and
  the same world vertices (within 1e-6 rel: the two stacks multiply in
  float32 on different backends; measured 0);
* each BSDF object's ``eval``, ``sample`` and ``pdf`` on 64 seeded lanes
  at ``tests/test_torch_bsdfs.py``'s bounds (validity and ``eta``
  bitwise; samples and pdfs 1e-6 rel L1, eval 2e-6), ``eval`` attached to
  the parameters, ``sample`` and ``pdf`` detached;
* ``tri_perm_staleness`` before and after a transform within 1e-5 (the
  cluster boxes' areas are summed in float32 centroids on both sides;
  measured 0), and ``refresh_tri_perm``'s return value equal;
* ``DiscreteDistribution.sum`` and ``pmf_normalized`` within 1e-6.

Besides: ``configure(active_sensors=[0])`` leaves sensor 1 without
primary-edge tables and sensor 0's step bitwise unchanged, and an
inactive sensor's renderD is its renderD without the primary-edge term
(the JAX package skips the term where a sensor has no tables); an
environment map's orientation gradient flows through ``set_transform``
(``tests/test_texture_transforms.py``'s finite-difference check at its
bounds); ``utils.profiling`` logs and writes a trace; every sub-package
of the port is packaged.
"""

import json
import os
import tomllib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from psdr_jit_tpu.core import transform as jxf
from psdr_jit_tpu_torch.core import transform as txf
from psdr_jit_tpu_torch.utils import profiling
from scenes import _icosphere, make_cbox
from test_torch_bsdfs import BOUND, EVAL_BOUND, JIts, _pair, _unit
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUAD = (np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
N = 64  # lanes of the BSDF methods' comparison


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def _cbox(w=8, spp=2, sppe=0, sppse=0):
    return pt.Scene.from_arrays(pt.scene_to_arrays(make_cbox(
        width=w, height=w, spp=spp, sppe=sppe, sppse=sppse)), device=CPU)


def test_module_surface():
    """Every name of the JAX package's ``__all__`` and of the reference's
    binding list (psdr.cpp:100-441), and the class hierarchy."""
    missing = [n for n in psdr.__all__ if not hasattr(pt, n)]
    assert not missing, missing
    for name in ("Object", "RayC", "RayD", "FrameC", "FrameD",
                 "InteractionC", "InteractionD", "IntersectionC",
                 "IntersectionD", "SampleRecordC", "SampleRecordD",
                 "PositionSampleC", "PositionSampleD", "SensorDirectSample",
                 "Bitmap1fD", "Bitmap3fD", "DiscreteDistribution",
                 "EdgeSortOption", "AQ_Option", "drjit_test", "drjit_memory",
                 "optix_jit_test", "transform", "__version__"):
        assert hasattr(pt, name), name
    assert pt.__version__ == psdr.__version__
    for cls in (pt.Mesh, pt.BSDF, pt.Emitter, pt.Sensor, pt.Scene,
                pt.Integrator):
        assert issubclass(cls, pt.Object), cls
    for sub, base in ((pt.DiffuseBSDF, pt.BSDF), (pt.NormalMapBSDF, pt.BSDF),
                      (pt.AreaLight, pt.Emitter),
                      (pt.EnvironmentMap, pt.Emitter),
                      (pt.PerspectiveCamera, pt.Sensor),
                      (pt.OrthographicCamera, pt.Sensor),
                      (pt.PathTracer, pt.Integrator),
                      (pt.FieldExtractionIntegrator, pt.Integrator)):
        assert issubclass(sub, base), sub
    assert pt.EdgeSortOption() == pt.EdgeSortOption(False, 180.0, 90.0, 1, 1)
    assert pt.AQ_Option().num_x == 1
    m = pt.Mesh().load_raw(*QUAD)
    m.m_id = "quad"
    assert m.id == "quad" and m.type_name() == "Mesh"
    assert repr(m) == m.to_string() == "Mesh[nv=4, nf=2, id=quad]"
    assert pt.DiffuseBSDF().to_string() == psdr.DiffuseBSDF().to_string()
    assert repr(pt.EnvironmentMap()) == "EnvironmentMap[]"


def test_sampler_seed_spelling():
    """``Sampler.seed`` as the reference spells it and the JAX package's
    ``seed_``: the same streams, and the JAX package's draws bitwise."""
    lanes = np.arange(8, dtype=np.uint32) * 977
    a = pt.Sampler().seed(torch.from_numpy(lanes.astype(np.int64)))
    b = pt.Sampler()
    b.seed_(torch.from_numpy(lanes.astype(np.int64)))
    ref = psdr.Sampler().seed(jnp.asarray(lanes))
    first = a.next_1d().numpy()
    np.testing.assert_array_equal(first, b.next_1d().numpy())
    np.testing.assert_array_equal(first, np.asarray(ref.next_1d()))
    np.testing.assert_array_equal(a.next_2d().numpy(),
                                  np.asarray(ref.next_2d()))


def test_smoke_functions():
    """The smoke checks on the CPU; without a card the default device
    raises, as the entry points do."""
    assert pt.drjit_test(device="cpu")
    assert pt.drjit_memory(device="cpu")
    assert pt.optix_jit_test(device="cpu")
    if not torch.cuda.is_available():
        for f in (pt.drjit_test, pt.drjit_memory, pt.optix_jit_test):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                f()


def test_render_arg_conventions():
    """seed=-1 uses scene.seed; batch_pix is an alias for pix_id."""
    sc = _cbox()
    sc.seed = 3
    sc.configure()
    integ = pt.PathTracer(1)
    a = integ.renderC(sc, 0, seed=3)
    np.testing.assert_array_equal(integ.renderC(sc, 0, seed=-1).numpy(),
                                  a.numpy())
    crop = integ.renderC(sc, 0, seed=3, batch_pix=torch.arange(4, 10))
    np.testing.assert_array_equal(crop.numpy(), a[4:10].numpy())


def test_scene_load_string_method():
    xml = """
<scene version="0.5.0">
    <sensor type="perspective">
        <float name="fov" value="40"/>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
</scene>
"""
    sc = pt.Scene(device="cpu")
    sc.load_string(xml, auto_configure=False)
    assert sc.opts.width == 8 and len(sc.sensors) == 1
    assert sc.num_sensors == 1 and sc.get_num_emitters() == 0
    assert not sc.is_ready()


def test_unit_ray_intersect():
    """``unit_ray_intersectAD`` hits what ``unit_ray_intersect`` hits, its
    ``t`` within 1e-4 rel, and carries the geometry's gradient."""
    sc = _cbox()
    sc.configure()
    assert sc.is_ready()
    o = np.asarray([[278.0, 273.0, -500.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    its = sc.unit_ray_intersect(o, d)
    assert bool(its.valid[0]) and float(its.t[0]) > 100.0
    assert its.is_valid() is its.valid
    # the hit mesh moved along the ray by dz: dt/ddz = 1
    mesh = sc.meshes[int(its.mesh_id[0])]
    dz = torch.zeros((), requires_grad=True)
    base = mesh.to_world_raw
    mesh.to_world_raw = base + torch.nn.functional.pad(dz.reshape(1, 1),
                                                       (3, 0, 2, 1))
    its_ad = sc.unit_ray_intersectAD(o, d)
    mesh.to_world_raw = base
    np.testing.assert_allclose(float(its_ad.t[0]), float(its.t[0]),
                               rtol=1e-4)
    (g,) = torch.autograd.grad(its_ad.t.sum(), dz)
    assert float(g) == pytest.approx(1.0, rel=1e-4)


def test_mesh_reference_attrs():
    m = pt.Mesh()
    m.load_raw(*QUAD)
    m.use_face_normal = True  # reference spelling
    assert m.use_face_normals is True
    np.testing.assert_allclose(m.vertex_normals.numpy(), [[0, 0, 1]] * 4,
                               atol=1e-6)
    ps = m.sample_position(np.full((16, 2), 0.5, np.float32))
    assert ps.is_valid.all()
    np.testing.assert_allclose(ps.pdf.numpy(), 1.0, rtol=1e-5)
    ps = m.sample_position(np.full((16, 2), 0.5, np.float32),
                           active=torch.arange(16) < 4)
    assert int(ps.is_valid.sum()) == 4
    m.vertex_positions = m.vertex_positions_raw * 2.0  # reference alias
    assert float(m.vertex_positions_raw.max()) == 2.0


def test_vertex_normals_and_edges_match_jax():
    """``vertex_normals`` within 1e-6 and ``edge_indices()`` equal on an
    icosphere and the Cornell box's meshes."""
    v, f = _icosphere(2)
    v = (v * np.float32([1.0, 0.7, 1.3])).astype(np.float32)
    pairs = [(psdr.Mesh().load_raw(v, f), pt.Mesh().load_raw(v, f))]
    jbox = make_cbox(width=8, height=8)
    pairs += list(zip(jbox.meshes, _cbox().meshes))
    for jm, tm in pairs:
        ei = tm.edge_indices()
        assert ei.dtype == np.int32 and ei.shape == (tm.num_edges, 4)
        np.testing.assert_array_equal(ei, jm.edge_indices())
    jm, tm = pairs[0]
    np.testing.assert_allclose(tm.vertex_normals.numpy(),
                               np.asarray(jm.vertex_normals), atol=1e-6)


def test_bitmap_reference_attrs(tmp_path):
    b = pt.Bitmap3fD((0.25, 0.5, 0.75))
    b.translate = (0.1, 0.2)
    b.rotate = 0.3
    np.testing.assert_allclose(b.trans.numpy(), [0.1, 0.2], rtol=1e-6)
    np.testing.assert_allclose(float(b.rot), 0.3, rtol=1e-6)
    np.testing.assert_allclose(b.rotate.numpy(), b.rot.numpy())
    b.fill((0.4, 0.2, 0.1))
    assert b.is_constant and b.data.shape == (1, 1, 3)
    uv = torch.rand(5, 2, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(b.eval1(uv).numpy(), 0.4, rtol=1e-6)
    img = np.random.default_rng(0).uniform(0, 1, (4, 6, 3)).astype(
        np.float32)
    jb = psdr.Bitmap3fD(img)
    tb = pt.Bitmap3fD(img)
    for x in (jb, tb):
        x.translate, x.rotate = (0.1, 0.2), 0.3
    np.testing.assert_allclose(tb.eval1(uv).numpy(),
                               np.asarray(jb.eval1(jnp.asarray(uv.numpy()))),
                               rtol=1e-5)
    from psdr_jit_tpu_torch import native
    if native.available():
        path = str(tmp_path / "t.exr")
        native.write_exr(path, img)
        np.testing.assert_allclose(pt.Bitmap3fD(path).data.numpy(), img,
                                   rtol=1e-6)
        assert pt.EnvironmentMap(path).radiance.resolution == (6, 4)


def test_collocated_m_intensity():
    c = pt.CollocatedIntegrator(100.0)
    np.testing.assert_allclose(c.m_intensity.numpy(), [100.0] * 3)
    c.m_intensity = 5.0
    np.testing.assert_allclose(c.intensity.numpy(), [5.0] * 3)


def test_perspective_intrinsic_ctor():
    cam = pt.PerspectiveCamera(1.0, 1.2, 0.5, 0.5, 1e-3, 1e4)
    assert cam.use_intrinsic and cam.fx == 1.0 and cam.fy == 1.2
    assert cam.configure_data(16, 16).sample_to_camera.shape == (4, 4)


def test_render_option_positional_ctors():
    o = pt.RenderOption(512, 512, 32)
    assert (o.width, o.height, o.spp, o.sppe, o.sppse) == (512, 512, 32, 32,
                                                           32)
    o = pt.RenderOption(512, 256, 32, 8)
    assert (o.spp, o.sppe, o.sppse) == (32, 8, 8)
    o = pt.RenderOption(512, 256, 32, 8, 4)
    assert (o.spp, o.sppe, o.sppse) == (32, 8, 4)
    o = pt.RenderOption()
    assert (o.width, o.height, o.spp) == (128, 128, 1)


def test_mesh_edge_indices_accessors():
    m = pt.Mesh()
    m.load_raw(*QUAD)
    ei = m.edge_indices()
    assert ei.shape == (5, 4) and ei.dtype == np.int32
    assert set(map(tuple, ei[:, :2])) == {(0, 1), (1, 2), (0, 2), (2, 3),
                                          (0, 3)}
    m.valid_edge_indices = ei[:2, :2]  # user-writable, unused internally
    assert m.valid_edge_indices.shape == (2, 2)
    assert m.num_edges == 5


def test_add_envmap_filename_overload(tmp_path):
    """``add_EnvironmentMap(filename, to_world, scale)`` and the one-map
    rule (the port raises ValueError where the JAX package asserts)."""
    from psdr_jit_tpu_torch import native
    if not native.available():
        pytest.skip("the port's host library (g++, zlib) is unavailable")
    img = np.random.default_rng(1).uniform(0, 1, (4, 8, 3)).astype(np.float32)
    path = str(tmp_path / "env.exr")
    native.write_exr(path, img)
    sc = pt.Scene(device="cpu")
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 2.0
    sc.add_EnvironmentMap(path, t, 3.0)
    np.testing.assert_allclose(float(sc.emitter_env.scale), 3.0)
    np.testing.assert_allclose(sc.emitter_env.to_world_raw.numpy(), t)
    np.testing.assert_allclose(sc.emitter_env.radiance.data.numpy(), img,
                               rtol=1e-6)
    with pytest.raises(ValueError):
        sc.add_EnvironmentMap(pt.EnvironmentMap())


def test_add_normalmap_bsdf():
    sc = _cbox()
    n = sc.add_normalmap_BSDF(pt.Bitmap3fD((0.5, 0.5, 1.0)),
                              pt.DiffuseBSDF([0.5] * 3), "nm")
    assert sc.bsdf_ids[n] == "nm" and "BSDF[id=nm]" in sc.param_map
    nm = sc.bsdfs[n]
    assert isinstance(nm, pt.NormalMapBSDF)
    assert isinstance(nm.bsdf, pt.DiffuseBSDF)
    # a normal-map BSDF passed as the map gives its map
    m = sc.add_normalmap_BSDF(nm, pt.DiffuseBSDF(), "nm2", twoSide=True)
    assert sc.bsdfs[m].nmap is nm.nmap and sc.bsdfs[m].twoSide


def test_transforms_match_jax():
    """``set_transform`` and ``append_transform`` (left and right) of a
    mesh, both cameras and the environment map leave the JAX package's
    stacks and world vertices."""
    rng = np.random.default_rng(5)
    v, f = _icosphere(1)
    mats = [np.asarray(jxf.translate(jnp.asarray(rng.uniform(-2, 2, 3))))
            @ np.asarray(jxf.rotate(jnp.asarray(rng.standard_normal(3)),
                                    float(rng.uniform(0, 90))))
            for _ in range(4)]
    mats = [m.astype(np.float32) for m in mats]
    objs = [(psdr.Mesh().load_raw(v, f), pt.Mesh().load_raw(v, f)),
            (psdr.PerspectiveCamera(40.0), pt.PerspectiveCamera(40.0)),
            (psdr.OrthographicCamera(), pt.OrthographicCamera())]
    for jo, to in objs:
        for o, arr in ((jo, jnp.asarray), (to, torch.from_numpy)):
            o.set_transform(arr(mats[0]))
            o.set_transform(arr(mats[1]), left=False)
            o.append_transform(arr(mats[2]))
            o.append_transform(arr(mats[3]), left=False)
        for name in ("to_world_left", "to_world_right"):
            np.testing.assert_allclose(getattr(to, name).numpy(),
                                       np.asarray(getattr(jo, name)),
                                       rtol=1e-6, atol=1e-6)
    jm, tm = objs[0]
    np.testing.assert_allclose(
        tm.configure_data().vertex_positions.numpy(),
        np.asarray(jm.configure_data().vertex_positions), rtol=1e-6,
        atol=1e-6)
    je, te = psdr.EnvironmentMap(), pt.EnvironmentMap()
    je.set_transform(jnp.asarray(mats[0]))
    te.set_transform(torch.from_numpy(mats[0]))
    np.testing.assert_array_equal(te.to_world_left.numpy(),
                                  np.asarray(je.to_world_left))


BSDF_KINDS = ("diffuse", "microfacet", "conductor", "dielectric-2s", "pv",
              "normalmap-microfacet")


def _bsdf_pair(kind, rng):
    if kind == "diffuse":
        return psdr.DiffuseBSDF((0.6, 0.5, 0.4)), pt.DiffuseBSDF(
            (0.6, 0.5, 0.4))
    if kind == "microfacet":
        args = ((0.1, 0.2, 0.3), (0.4, 0.3, 0.2), 0.35)
        return psdr.MicrofacetBSDF(*args), pt.MicrofacetBSDF(*args)
    return _pair(kind, rng)


def _lanes(rng):
    """64 seeded lanes: ``wi`` and ``wo`` over the whole sphere, ``rnd3``,
    ``uv``, barycentrics, vertex ids of the per-vertex tables' 10 rows and
    ``dp_du``."""
    bc = rng.random((N, 2)).astype(np.float32)
    flip = bc.sum(-1) > 1.0
    bc[flip] = 1.0 - bc[flip]
    return dict(wi=_unit(rng, N), wo=_unit(rng, N),
                rnd3=rng.random((N, 3)).astype(np.float32),
                uv=rng.uniform(-0.3, 1.3, (N, 2)).astype(np.float32), bc=bc,
                face_indices=rng.integers(0, 10, (N, 3)).astype(np.int32),
                dp_du=rng.standard_normal((N, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", BSDF_KINDS)
def test_bsdf_methods_match_jax(kind):
    """``eval``, ``sample`` and ``pdf`` of each BSDF object on 64 seeded
    lanes against the JAX package's methods: validity and ``eta``
    bitwise, samples and pdfs within 1e-6 rel L1, eval within 2e-6
    (measured at most 3e-7); ``eval`` is attached to the BSDF's
    parameters, ``sample`` and ``pdf`` are not; ``anisotropic`` and
    ``to_string`` as the JAX package's."""
    rng = np.random.default_rng(60 + BSDF_KINDS.index(kind))
    jb, tb = _bsdf_pair(kind, rng)
    lanes = _lanes(rng)
    keys = ("wi", "uv", "bc", "face_indices", "dp_du")
    jits = JIts(**{k: jnp.asarray(lanes[k]) for k in keys})
    tits = types.SimpleNamespace(**{k: torch.from_numpy(lanes[k])
                                    for k in keys})
    act = np.ones(N, bool)
    act[::7] = False
    jact, tact = jnp.asarray(act), torch.from_numpy(act)
    jwo, two = jnp.asarray(lanes["wo"]), torch.from_numpy(lanes["wo"])
    jr, tr = jnp.asarray(lanes["rnd3"]), torch.from_numpy(lanes["rnd3"])
    jbs, tbs = jb.sample(jits, jr, jact), tb.sample(tits, tr, tact)
    np.testing.assert_array_equal(tbs.is_valid.numpy(),
                                  np.asarray(jbs.is_valid))
    ok = np.asarray(jbs.is_valid)
    assert ok.mean() > 0.2, kind
    np.testing.assert_array_equal(tbs.eta.numpy()[ok],
                                  np.asarray(jbs.eta)[ok])
    rels = {"wo": _rel(tbs.wo.numpy()[ok], np.asarray(jbs.wo)[ok]),
            "pdf_s": _rel(tbs.pdf.numpy()[ok], np.asarray(jbs.pdf)[ok]),
            "pdf": _rel(tb.pdf(tits, two, tact).numpy(),
                        np.asarray(jb.pdf(jits, jwo, jact))),
            "eval": _rel(tb.eval(tits, two, tact).detach().numpy(),
                         np.asarray(jb.eval(jits, jwo, jact)))}
    bounds = {"wo": BOUND, "pdf_s": BOUND, "pdf": BOUND, "eval": EVAL_BOUND}
    assert all(v < bounds[k] for k, v in rels.items()), (kind, rels)
    assert tb.anisotropic() == jb.anisotropic()
    assert tb.to_string() == jb.to_string() or kind != "diffuse"
    # attached eval, detached sample and pdf (bsdf.py:22-38)
    if kind == "pv":
        tb.diffuseReflectance = tb.diffuseReflectance.clone(
        ).requires_grad_()
        param = tb.diffuseReflectance
    else:
        bm = (tb.reflectance if kind == "diffuse" else tb.bsdf.roughness
              if kind.startswith("normalmap") else tb.roughness
              if kind == "microfacet" else tb.alpha_u)
        bm.data = bm.data.clone().requires_grad_()
        param = bm.data
    val = tb.eval(tits, two, tact)
    (g,) = torch.autograd.grad(val.sum(), param)
    assert float(g.abs().sum()) > 0
    assert not tb.sample(tits, tr, tact).pdf.requires_grad
    assert not tb.pdf(tits, two, tact).requires_grad


def test_discrete_distribution_accessors_match_jax():
    mass = np.random.default_rng(7).uniform(0, 2, 37).astype(np.float32)
    jd = psdr.DiscreteDistribution.init(jnp.asarray(mass))
    td = pt.DiscreteDistribution.init(torch.from_numpy(mass))
    np.testing.assert_allclose(float(td.sum), float(jd.sum), rtol=1e-6)
    np.testing.assert_allclose(td.pmf_normalized().numpy(),
                               np.asarray(jd.pmf_normalized()), rtol=1e-6)


def _sphere_scenes():
    """Three icospheres (960 faces, above the Morton threshold) in the JAX
    package and in the port, the port's configured."""
    v, f = _icosphere(2)
    js, ts = psdr.Scene(), pt.Scene(device="cpu")
    ts.add_Sensor(pt.PerspectiveCamera(40.0))
    ts.add_BSDF(pt.DiffuseBSDF(), "d")
    for i in range(3):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = (3.0 * i, 0.5 * i, 10.0)
        js.add_Mesh(psdr.Mesh().load_raw(v, f), t)
        ts.add_Mesh(pt.Mesh().load_raw(v, f), t, "d")
    ts.opts = pt.RenderOption(8, 8, 1, 0, 0)
    ts.configure()
    # the JAX package's configure() sets this permutation; its eager
    # scene compile is not needed for the staleness, which reads only it
    js._tri_perm = js._compute_tri_perm()
    return js, ts


def test_tri_perm_staleness_matches_jax():
    """The staleness of the Morton order within 1e-5 of the JAX package's
    before and after moving a sphere through the other two, and
    ``refresh_tri_perm``'s answers the same."""
    js, ts = _sphere_scenes()
    np.testing.assert_array_equal(ts._tri_perm, np.asarray(js._tri_perm))
    assert ts.tri_perm_staleness() == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(ts.tri_perm_staleness(),
                               js.tri_perm_staleness(), rtol=1e-5)
    move = np.array(jxf.translate(jnp.asarray([-6.0, 0.0, 0.0])),
                    np.float32)
    js.meshes[2].append_transform(jnp.asarray(move))
    ts.meshes[2].append_transform(torch.from_numpy(move))
    stale = ts.tri_perm_staleness()
    assert stale > 1.0
    np.testing.assert_allclose(stale, js.tri_perm_staleness(), rtol=1e-5)
    assert ts.refresh_tri_perm(stale * 2) is js.refresh_tri_perm(stale * 2)
    assert ts.refresh_tri_perm(1.0) is js.refresh_tri_perm(1.0) is True
    np.testing.assert_array_equal(ts._tri_perm, np.asarray(js._tri_perm))
    assert ts._data is None and ts.tri_perm_staleness() == pytest.approx(1.0)
    assert ts.data.tri.p0.shape[0] == 960  # rebuilt on the new order


def test_configure_active_sensors():
    """``configure(active_sensors=[0])``: primary-edge tables for sensor 0
    only; sensor 0's training step bitwise the step with every sensor
    active; an inactive sensor's renderD is its renderD without the
    primary-edge term (the JAX package skips a sensor without tables)."""
    from chip_smoke import train_setup

    sc = _cbox(w=8, spp=2, sppe=2, sppse=2)
    cam = pt.PerspectiveCamera(39.0, 1e-6, 1e7)
    cam.to_world = txf.look_at([100.0, 300.0, -700.0], [278.0, 274.4, 279.6],
                               [0.0, 1.0, 0.0])
    sc.add_Sensor(cam)
    integ = pt.PathTracer(2)
    params, apply_params, loss = train_setup(sc)

    def run():
        step = integ.loss_and_grad(sc, params, apply_params, loss, 0, 1)
        return step, integ.renderD(sc, 1, seed=1)

    sc.configure()
    assert [s.edge_info is not None for s in sc.data.sensors] == [True, True]
    (l_a, g_a, i_a), d_a = run()
    sc.configure(active_sensors=[0])
    assert [s.edge_info is not None for s in sc.data.sensors] == [True,
                                                                  False]
    assert [s.edge_info is not None for s in sc.configure_data(
        sc._active_sensors).sensors] == [True, False]
    (l_o, g_o, i_o), d_o = run()
    assert torch.equal(l_a, l_o) and torch.equal(i_a, i_o)
    for k in g_a:
        assert torch.equal(g_a[k], g_o[k]), k
    sc.opts.sppe = 0
    sc.configure()
    np.testing.assert_array_equal(d_o.detach().numpy(),
                                  integ.renderD(sc, 1, seed=1).detach()
                                  .numpy())
    assert sc._active_sensors is None


def test_envmap_set_transform_gradient():
    """An environment map's orientation is differentiable through
    ``set_transform``: the reverse-mode gradient of the mean renderD of a
    plane under a textured sky along a rotation about a horizontal axis
    matches central differences (JAX
    ``tests/test_texture_transforms.py``'s bounds, rtol 0.2, atol 1e-4)."""
    tex = np.random.default_rng(2).uniform(0.1, 2.0, (8, 16, 3)).astype(
        np.float32)
    sc = pt.Scene(device="cpu")
    sc.opts = pt.RenderOption(32, 32, 32, 0, 0)  # the JAX test's sizes
    cam = pt.OrthographicCamera(0.1, 100.0)
    cam.to_world = txf.look_at([0.0, 0.0, 10.0], [0.0, 0.0, 0.0],
                               [0.0, 1.0, 0.0])
    sc.add_Sensor(cam)
    sc.add_BSDF(pt.DiffuseBSDF([0.6] * 3), "rho")
    plane = pt.Mesh()
    plane.use_face_normals = True
    plane.enable_edges = False
    plane.load_raw(np.asarray([[-5, -5, 0], [5, -5, 0], [5, 5, 0],
                               [-5, 5, 0]], np.float32), QUAD[1])
    sc.add_Mesh(plane, None, "rho")
    sc.add_EnvironmentMap(pt.EnvironmentMap(tex))
    sc.configure()
    env, integ = sc.emitters[0], pt.PathTracer(1)

    def loss(angle):
        env.set_transform(txf.rotate([1.0, 0.0, 0.0], angle))
        return torch.mean(integ.renderD(sc, 0, seed=0))

    a = torch.tensor(10.0, requires_grad=True)
    (g,) = torch.autograd.grad(loss(a), a)
    eps = 0.5
    with torch.no_grad():
        fd = (float(loss(torch.tensor(10.0 + eps)))
              - float(loss(torch.tensor(10.0 - eps)))) / (2 * eps)
    assert np.isfinite(float(g)) and abs(fd) > 1e-4
    np.testing.assert_allclose(float(g), fd, rtol=0.2, atol=1e-4)


def test_profiling(tmp_path, capsys):
    """``log_time`` prints the reference's lines where ``log_level > 0``
    (configure and the renders) and ``trace`` writes a Chrome trace of
    the block."""
    sc = _cbox()
    sc.opts.log_level = 1
    sc.configure()
    pt.PathTracer(1).renderC(sc, 0)
    out = capsys.readouterr().out
    assert "Configured in " in out and "Rendered in " in out
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
    assert prof.key_averages() is not None


def test_port_packages_are_listed():
    """Every sub-package of the port (a directory with ``__init__.py``) is
    in ``pyproject.toml``'s packages, and the host library's source in
    its package-data."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        conf = tomllib.load(f)["tool"]["setuptools"]
    found = set()
    base = os.path.join(ROOT, "psdr_jit_tpu_torch")
    for d, _, files in os.walk(base):
        if "__init__.py" in files and "build" not in d:
            rel = os.path.relpath(d, ROOT).replace(os.sep, ".")
            found.add(rel)
    assert found and found <= set(conf["packages"]), found - set(
        conf["packages"])
    assert "hostops.cpp" in conf["package-data"]["psdr_jit_tpu_torch.native"]
