"""psdr_jit_tpu_torch's host library (``native/hostops.cpp`` and its ctypes
binding) against its plain numpy and Python versions and against the JAX
package's library, on ``tests/test_native.py``'s cases.

Integer outputs (the edge list, the Morton order, OBJ faces) and float
outputs that are read or written without arithmetic (OBJ vertices, EXR
pixels through ZIP and PIZ, both lossless for FLOAT channels) must match
bitwise. Every file is written under ``tmp_path``.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from psdr_jit_tpu import native as jnative
from psdr_jit_tpu.utils import obj as jobj
from psdr_jit_tpu_torch import native
from psdr_jit_tpu_torch.scene.scene import morton_order
from psdr_jit_tpu_torch.shape.mesh import build_edge_list
from psdr_jit_tpu_torch.utils.obj import load_obj, parse_obj_text, save_obj
from scenes import REF_BALLROOM
from torch_threads import _one_thread  # noqa: F401 (autouse)

PKG = Path(__file__).resolve().parent.parent / "psdr_jit_tpu_torch"
EXR_SHAPES = [(7, 5, 3), (16, 33, 1), (40, 17, 4), (67, 41, 3),
              (200, 130, 3), (33, 17, 1), (32, 64, 4), (1, 7, 3),
              (100, 1, 3)]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    """The JAX package's library, loaded. Its binding builds the library
    beside its source at first use and remembers a failure for the life
    of the process; the test workers all import ``tests/test_native.py``
    at once while collecting, so a worker may have seen the file half
    written. Load it again once it is whole."""
    if not jnative.available():
        jnative._tried = False
    assert jnative.available(), "the JAX package's host library"


def _grid_faces(n: int = 17) -> np.ndarray:
    """``test_native.py``'s grid: (n - 1)^2 quads, two triangles each."""
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            faces.append([i * n + j, (i + 1) * n + j, i * n + j + 1])
            faces.append([(i + 1) * n + j, (i + 1) * n + j + 1,
                          i * n + j + 1])
    return np.asarray(faces, np.int32)


def test_library_builds_under_build_dir():
    """The library is built from the port's own source into the port's
    git-ignored build directory, never beside its source."""
    lib = native.build()
    assert native.available()
    assert lib.name == "libhostops.so"
    assert lib.parent.parent == PKG / "build"
    assert not list((PKG / "native").glob("*.so"))


@pytest.mark.parametrize("shuffle", [False, True])
def test_edge_list_matches_numpy_and_jax(shuffle):
    faces = _grid_faces()
    if shuffle:
        faces = faces[np.random.default_rng(5).permutation(len(faces))]
    got = native.build_edge_list(faces)
    assert got.dtype == np.int32 and got.shape[1] == 5
    np.testing.assert_array_equal(got, build_edge_list(faces))
    np.testing.assert_array_equal(got, jnative.build_edge_list(faces))


def test_morton_order_matches_numpy_and_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    pts[100:200] = pts[0]  # equal codes keep their order
    pts[300:400, 1] = 2.5  # a flat slab
    got = native.morton_order(pts)
    assert sorted(got.tolist()) == list(range(4096))
    np.testing.assert_array_equal(got, morton_order(pts))
    np.testing.assert_array_equal(got, jnative.morton_order(pts))


OBJ_TEXTS = {
    "uv_polygons": """
# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
f 1/1 2/2 3/3 4/4
f -4/-4 -2/-2 -1/-1
""",
    "normals_no_uv": """
v 0.1 -0.2 3.0000001
v 1e-3 2.5e2 -7
v 0.3333333333 0.6666666666 1
v -1 -1 -1
vn 0 0 1
	# an indented comment
f 1//1 2//1 3//1
f 4 1 3 2
f -1 -2 -3
""",
    "uv_without_indices": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                          "f 1 2 3\r\n",
}


@pytest.mark.parametrize("case", sorted(OBJ_TEXTS))
def test_obj_parse_matches_python_and_jax(case):
    text = OBJ_TEXTS[case]
    got = native.parse_obj(text.encode())
    want = parse_obj_text(text)
    ref = jobj.load_obj(text, from_string=True)
    for k in ("vertices", "faces", "uvs", "face_uvs"):
        for other in (want, ref):
            if other[k] is None:
                assert got[k] is None, k
            else:
                assert got[k].dtype == other[k].dtype, k
                np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    if case == "uv_polygons":  # the quad's fan and the negative indices
        np.testing.assert_array_equal(got["faces"],
                                      [[0, 1, 2], [0, 2, 3], [0, 2, 3]])


def test_obj_file_roundtrip(tmp_path):
    verts = np.random.default_rng(7).normal(size=(9, 3)).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [5, 6, 7], [8, 0, 4]],
                       np.int32)
    path = str(tmp_path / "m.obj")
    save_obj(path, verts, faces)
    out = load_obj(path)
    np.testing.assert_allclose(out["vertices"], verts, rtol=1e-6)
    np.testing.assert_array_equal(out["faces"], faces)
    assert out["uvs"] is None and out["face_uvs"] is None


def _image(shape, seed=0):
    img = (np.random.default_rng(seed).normal(size=shape) * 100).astype(
        np.float32)
    img.flat[::7] = 0.0
    return img


@pytest.mark.parametrize("compression", ["zip", "piz"])
@pytest.mark.parametrize("shape", EXR_SHAPES)
def test_exr_roundtrip_bit_exact(tmp_path, compression, shape):
    img = _image(shape)
    path = str(tmp_path / "t.exr")
    native.write_exr(path, img, compression)
    back = native.read_exr(path)
    assert back.dtype == np.float32 and back.shape == img.shape
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("compression", ["zip", "piz"])
def test_exr_cross_reads_with_jax(tmp_path, compression):
    """The port reads what the JAX package's library wrote and the other
    way round, bitwise; the two write the same bytes."""
    img = _image((45, 38, 3), seed=1)
    mine, theirs = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    native.write_exr(mine, img, compression)
    jnative.write_exr(theirs, img, compression=compression)
    np.testing.assert_array_equal(native.read_exr(theirs), img)
    np.testing.assert_array_equal(jnative.read_exr(mine), img)
    assert Path(mine).read_bytes() == Path(theirs).read_bytes()


def test_exr_compresses_smooth_data(tmp_path):
    """PIZ and ZIP really compress (no store-raw fallback) on smooth HDR
    data."""
    y, x = np.mgrid[0:128, 0:128]
    img = np.stack([np.sin(x / 9.0) + y / 64.0, np.cos(y / 7.0),
                    (x + y) / 256.0], -1).astype(np.float32)
    for comp in ("piz", "zip"):
        path = tmp_path / f"{comp}.exr"
        native.write_exr(str(path), img, comp)
        assert path.stat().st_size < img.nbytes
        np.testing.assert_array_equal(native.read_exr(str(path)), img)


def test_piz_corrupt_file_raises(tmp_path):
    path = str(tmp_path / "c.exr")
    native.write_exr(path, np.ones((40, 40, 3), np.float32), "piz")
    data = bytearray(open(path, "rb").read())
    data[-30:] = bytes(30)  # stomp on the Huffman stream
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="EXR read failed"):
        native.read_exr(path)


def test_exr_bad_inputs_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_exr(str(tmp_path / "missing.exr"))
    (tmp_path / "x.exr").write_bytes(b"not an exr file at all")
    with pytest.raises(ValueError, match="not an EXR"):
        native.read_exr(str(tmp_path / "x.exr"))
    with pytest.raises(ValueError, match="compression"):
        native.write_exr(str(tmp_path / "y.exr"), np.ones((2, 2, 3)), "rle")
    with pytest.raises(ValueError, match="H, W"):
        native.write_exr(str(tmp_path / "y.exr"), np.ones((2, 2, 2)))


def test_piz_decodes_openexr_file():
    """A PIZ file written by the OpenEXR library itself (the reference's
    environment map), where the reference's assets are present."""
    if not os.path.exists(REF_BALLROOM):
        pytest.skip("the reference's ballroom_1k.exr is absent")
    img = native.read_exr(REF_BALLROOM)
    assert img.shape == (512, 1024, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and 0.1 < img.mean() < 10.0
    d = np.abs(np.diff(img, axis=1)).mean()
    assert d / img.mean() < 0.3, "decoded image is not spatially smooth"
    np.testing.assert_array_equal(img, jnative.read_exr(REF_BALLROOM))
