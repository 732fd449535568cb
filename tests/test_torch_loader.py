"""File loading in psdr_jit_tpu_torch against the JAX package: the XML
scene loader (``load_file``, ``Scene.load_file``/``load_string``), OBJ
meshes (``Mesh.load``/``dump``, ``Scene.add_Mesh(path)``) and image files
(``Bitmap1f``/``Bitmap3f(path)``, ``EnvironmentMap(path)``), on files each
test writes under its temporary directory.

A scene loaded by both packages is compared through
``interop.scene_to_arrays``, key by key: bitwise, except the transforms
that the loader composes from several nodes or computes through
``sin``/``cos``/``sqrt`` (``lookat``, ``rotate``), whose float32 rounding
differs by backend, within 2 ulp (measured: bitwise). A render of the
loaded scene is held to the JAX package's within the bound of
``tests/test_torch_render.py`` (relative L1 below 5e-3, fewer than 10% of
pixels off by more than 1e-3).
"""

import os

import numpy as np
import pytest
import torch

import psdr_jit_tpu as psdr
import psdr_jit_tpu_torch as pt
from chip_smoke import cbox_files, envmap_arrays, envmap_files
from psdr_jit_tpu.core import transform as jxf
from psdr_jit_tpu_torch.utils.image import write_image, write_pfm
from test_loader import FLOOR_OBJ, LIGHT_OBJ, XML
from torch_threads import _one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")  # the entry points default to the card
NPZ = os.path.join(os.path.dirname(__file__), "data", "cbox_scene.npz")
TRANSFORMS = ("to_world_raw", "to_world_left", "to_world_right")
VN_ATOL = 3e-7  # vertex normals' components, which are at most 1

# tests/test_loader.py's ordering, paths and texture case: a shape names a
# BSDF defined later, the sensor's transform is not named "toWorld", and
# textures resolve against the scene's directory
ORDER_XML = """
<scene version="0.5.0">
    <shape type="obj">
        <string name="filename" value="quad.obj"/>
        <ref id="later_mat"/>
    </shape>
    <shape type="obj">
        <string name="filename" value="quad.obj"/>
        <ref id="metal"/>
        <transform name="toWorld">
            <rotate y="1" angle="30"/>
            <scale x="2" y="1" z="0.5"/>
            <translate x="0.25" y="-1" z="3"/>
        </transform>
    </shape>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="to_world">
            <translate x="0" y="0" z="-5"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="8"/>
            <integer name="height" value="8"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="later_mat">
        <texture name="reflectance" type="bitmap">
            <string name="filename" value="alb.pfm"/>
        </texture>
    </bsdf>
    <bsdf type="roughconductor" id="metal">
        <texture name="alpha" type="bitmap">
            <string name="filename" value="alpha.pfm"/>
        </texture>
        <rgb name="k" value="1, 2, 3"/>
    </bsdf>
    <bsdf type="roughdielectric" id="glass">
        <float name="alpha" value="0.2"/>
        <float name="intIOR" value="1.33"/>
        <float name="extIOR" value="1.1"/>
    </bsdf>
    <bsdf type="normalmap" id="bumpy">
        <rgb name="normalmap" value="0.5, 0.6, 1"/>
        <bsdf type="microfacet">
            <float name="roughness" value="0.4"/>
        </bsdf>
    </bsdf>
    <emitter type="envmap">
        <string name="filename" value="sky.exr"/>
        <float name="scale" value="2.5"/>
        <transform name="toWorld">
            <rotate x="1" z="1" angle="20"/>
        </transform>
    </emitter>
</scene>
"""


def _assert_arrays_match(ja, ta):
    """``scene_to_arrays`` of both scenes: the same keys, equal arrays;
    transforms within 2 ulp."""
    assert sorted(ja) == sorted(ta)
    for k, ref in ja.items():
        got = ta[k]
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        if k.rsplit(".", 1)[-1] in TRANSFORMS:
            ulp = np.spacing(np.maximum(np.abs(ref), np.abs(got)))
            assert (np.abs(got - ref) <= 2 * ulp).all(), k
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    (d / "floor.obj").write_text(FLOOR_OBJ)
    (d / "light.obj").write_text(LIGHT_OBJ)
    (d / "scene.xml").write_text(XML)
    return d


@pytest.fixture(scope="module")
def loaded(scene_dir):
    path = str(scene_dir / "scene.xml")
    return psdr.load_file(path), pt.load_file(path, device=CPU)


def test_load_file_matches_jax(loaded):
    jsc, sc = loaded
    assert sc.device == CPU
    assert (sc.opts.width, sc.opts.height, sc.opts.spp) == (24, 16, 2)
    assert (len(sc.sensors), len(sc.bsdfs), len(sc.meshes),
            len(sc.emitters)) == (1, 4, 2, 1)
    assert sorted(sc.param_map) == sorted(jsc.param_map)
    assert isinstance(sc.param_map["BSDF[id=metal]"], pt.RoughConductorBSDF)
    md = sc.meshes[0].configure_data()
    assert float(md.vertex_positions[:, 0].max()) == pytest.approx(2.0)
    _assert_arrays_match(pt.scene_to_arrays(jsc), pt.scene_to_arrays(sc))


def test_loaded_scene_renders_like_jax(loaded):
    jsc, sc = loaded
    for s in (jsc, sc):
        s.opts.width = s.opts.height = 16
        s.opts.spp = 2
    jsc.configure()
    ref = np.asarray(psdr.PathTracer(2).renderC(jsc, 0, seed=1))
    img = pt.PathTracer(2).renderC(sc, 0, seed=1).numpy()
    assert img.shape == (256, 3) and np.isfinite(img).all()
    assert ref.max() > 0
    rel = np.abs(img - ref).sum() / np.abs(ref).sum()
    frac = (np.abs(img - ref).max(-1) > 1e-3).mean()
    assert rel < 5e-3, rel
    assert frac < 0.1, frac


@pytest.fixture(scope="module")
def order_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("order")
    (d / "quad.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vt 0 1\nf 1/1 2/2 3/3 4/4\n")
    rng = np.random.default_rng(11)
    write_pfm(str(d / "alb.pfm"), rng.random((4, 6, 3)).astype(np.float32))
    write_pfm(str(d / "alpha.pfm"),
              rng.uniform(0.1, 0.5, (3, 5, 3)).astype(np.float32))
    write_image(str(d / "sky.exr"),
                rng.uniform(0, 4, (8, 16, 3)).astype(np.float32))
    (d / "scene.xml").write_text(ORDER_XML)
    return d


@pytest.mark.parametrize("how", ["load_file", "Scene.load_file"])
def test_ordering_paths_and_textures_match_jax(order_dir, how):
    """tests/test_loader.py's review cases through both packages, from
    another working directory: later BSDF references, a sensor transform
    of another name, textures beside the scene file, textured
    roughconductor alpha, roughdielectric indices, a normal map's nested
    BSDF, an envmap's file, scale and transform, composed transforms."""
    path = str(order_dir / "scene.xml")
    cwd = os.getcwd()
    try:
        os.chdir(order_dir.parent)
        jsc = psdr.load_file(path)
        if how == "load_file":
            sc = pt.load_file(os.path.relpath(path), device=CPU)
        else:
            sc = pt.Scene(device=CPU)
            sc.load_file(os.path.relpath(path), auto_configure=False)
    finally:
        os.chdir(cwd)
    assert sc._data is None
    assert abs(float(sc.sensors[0].to_world_raw[2, 3]) + 5) < 1e-6
    refl = sc.param_map["BSDF[id=later_mat]"].reflectance
    assert refl.resolution == (6, 4)
    alpha = sc.param_map["BSDF[id=metal]"].alpha_u
    assert alpha.resolution == (5, 3) and alpha.channels == 1
    assert isinstance(sc.param_map["BSDF[id=bumpy]"].bsdf, pt.MicrofacetBSDF)
    env = sc.emitter_env
    assert env.radiance.resolution == (16, 8) and float(env.scale) == 2.5
    assert sc.meshes[0].has_uv
    _assert_arrays_match(pt.scene_to_arrays(jsc), pt.scene_to_arrays(sc))


def test_scene_load_string_and_add_mesh_path(scene_dir):
    """``Scene.load_string`` configures unless told not to, and
    ``Scene.add_Mesh`` takes an OBJ path."""
    cwd = os.getcwd()
    try:
        os.chdir(scene_dir)
        sc = pt.Scene(device=CPU)
        sc.load_string(XML)
        assert sc._data is not None and len(sc.meshes) == 2
        lazy = pt.Scene(device=CPU)
        lazy.load_string(XML, auto_configure=False)
        assert lazy._data is None
        jsc = psdr.Scene()
        jsc.add_BSDF(psdr.DiffuseBSDF([0.3, 0.4, 0.5]), "d")
        jm = jsc.add_Mesh("light.obj", np.eye(4, dtype=np.float32), "d")
        tsc = pt.Scene(device=CPU)
        tsc.add_BSDF(pt.DiffuseBSDF([0.3, 0.4, 0.5]), "d")
        tm = tsc.add_Mesh("light.obj", np.eye(4, dtype=np.float32), "d")
    finally:
        os.chdir(cwd)
    assert isinstance(tm, pt.Mesh) and tm.bsdf_id == jm.bsdf_id == 0
    np.testing.assert_array_equal(tm.vertex_positions_raw.numpy(),
                                  np.asarray(jm.vertex_positions_raw))
    np.testing.assert_array_equal(tm.face_indices.numpy(), jm.face_indices)
    np.testing.assert_array_equal(tm._edge_rows, jm._edge_rows)


def _mesh_pair(uv: bool, face_normals: bool):
    rng = np.random.default_rng(21)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    f = np.asarray([[0, 1, 2], [2, 1, 3], [4, 5, 6], [6, 5, 7], [8, 9, 10],
                    [10, 9, 11], [0, 4, 8], [1, 3, 7]], np.int32)
    uvs = rng.random((7, 2)).astype(np.float32) if uv else None
    fuv = rng.integers(0, 7, f.shape).astype(np.int32) if uv else None
    m = np.asarray(jxf.translate([0.5, -2.0, 3.0])
                   @ jxf.rotate([1.0, 2.0, 0.5], 33.0))
    jm, tm = psdr.Mesh(), pt.Mesh()
    for mesh in (jm, tm):
        mesh.use_face_normals = face_normals
        mesh.load_raw(v, f, uvs, fuv)
    jm.to_world_raw = m
    tm.to_world_raw = torch.tensor(m)
    return jm, tm


def _within(line, ref, units: int, atol: float = 0.0):
    """Two ``%.6e`` lines of the same tag whose numbers differ by at most
    ``units`` units of their last printed digit, or by ``atol``."""
    a, b = (np.asarray(x.split()[1:], np.float64) for x in (line, ref))
    unit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(b), 1e-30))) - 6)
    return (line.split()[0] == ref.split()[0] and a.shape == b.shape
            and bool((np.abs(a - b) <= np.maximum(units * unit * 1.0001,
                                                  atol)).all()))


@pytest.mark.parametrize("uv, face_normals",
                         [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("raw", [False, True])
def test_mesh_dump_matches_jax(tmp_path, uv, face_normals, raw):
    """``Mesh.dump`` writes the JAX package's ``%.6e`` text. The raw
    positions, texture coordinates and faces are the same bytes; the
    world-space positions of ``raw=True`` (through either package's
    float32 transform) are the same numbers to one unit of their last
    printed digit (measured: the same bytes). The vertex normals,
    normalised with either backend's reciprocal square root, are within
    3e-7 (measured: 4 or 6 of 12 ``vn`` lines differ, by at most 1e-7 for
    the raw positions and 2e-7 in world space). ``Mesh.load`` reads the
    file back."""
    jm, tm = _mesh_pair(uv, face_normals)
    jp, tp = str(tmp_path / "jax.obj"), str(tmp_path / "port.obj")
    jm.dump(jp, raw=raw)
    tm.dump(tp, raw=raw)
    jt, tt = open(jp).read().splitlines(), open(tp).read().splitlines()
    assert len(tt) == len(jt)
    for line, ref in zip(tt, jt):
        if ref.startswith("vn "):
            assert _within(line, ref, 0, VN_ATOL), (line, ref)
        elif raw and ref.startswith("v "):
            assert _within(line, ref, 1), (line, ref)
        else:
            assert line == ref
    if face_normals and not raw:
        assert tt == jt
    back = pt.Mesh().load(tp)
    assert back.num_faces == tm.num_faces and back.has_uv == uv
    np.testing.assert_array_equal(back.face_indices.numpy(),
                                  tm.face_indices.numpy())
    if not raw:
        np.testing.assert_allclose(back.vertex_positions_raw.numpy(),
                                   tm.vertex_positions_raw.numpy(),
                                   rtol=1e-6)


@pytest.mark.parametrize("suffix", [".npy", ".pfm", ".exr"])
def test_bitmaps_and_envmap_from_files_match_jax(tmp_path, suffix):
    """``Bitmap3f(path)``, ``Bitmap1f(path)`` (the first channel of many),
    ``Bitmap3f`` of a one-channel file (repeated), of a four-channel EXR
    (the first three), and ``EnvironmentMap(path)`` (the first three
    channels) hold the JAX package's data bitwise; a missing file raises
    ``FileNotFoundError``."""
    rng = np.random.default_rng(31)
    files = {3: rng.uniform(0, 5, (5, 7, 3)), 1: rng.uniform(0, 5, (4, 6, 1))}
    if suffix == ".exr":
        files[4] = rng.uniform(0, 5, (6, 3, 4))
    paths = {}
    for c, img in files.items():
        paths[c] = str(tmp_path / f"c{c}{suffix}")
        write_image(paths[c], img.astype(np.float32))
    for c, p in paths.items():
        for make, jmake in ((pt.Bitmap3f, psdr.Bitmap3f),
                            (pt.Bitmap1f, psdr.Bitmap1f)):
            got, ref = make(p), jmake(p)
            assert got.data.dtype == torch.float32
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(ref.data))
        if c > 1:
            got = pt.EnvironmentMap(p).radiance.data.numpy()
            np.testing.assert_array_equal(
                got, np.asarray(psdr.EnvironmentMap(p).radiance.data))
            assert got.shape[-1] == 3
    bm = pt.Bitmap3f().load_openexr(paths[3])
    assert bm.resolution == (7, 5) and bm.channels == 3
    for fn in (pt.Bitmap3f, pt.Bitmap1f, pt.EnvironmentMap):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / f"missing{suffix}"))


@pytest.mark.parametrize("scene", ["cbox", "envmap"])
def test_chip_smoke_scene_files_load_bitwise(tmp_path, scene):
    """The files ``chip_smoke.py`` writes for its loaded paths
    (``cbox_files``: ``tests/data/cbox_scene.npz`` as XML and OBJ;
    ``envmap_files``: ``envmap_arrays``' scene as XML, OBJ and a PIZ EXR)
    load as the same scene, array for array, bit for bit."""
    if scene == "cbox":
        want = dict(np.load(NPZ))
        path = cbox_files(want, tmp_path)
    else:
        want = envmap_arrays(16, 16, 2, 0, 0)
        path = envmap_files(tmp_path, 16, 16, 2)
    got = pt.scene_to_arrays(pt.load_file(str(path), device=CPU))
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "opts":
            np.testing.assert_array_equal(got[k][:3], want[k][:3])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
