"""ctypes binding of the port's host library, ``native/hostops.cpp``.

g++ builds the library at its first use into ``psdr_jit_tpu_torch/build/``
(one directory per hash of the source and the flags), never beside its
source; it needs g++ and zlib's headers. A failed build raises with the
compiler's output: nothing falls back quietly. The plain numpy versions
stay beside the library as its specification, which the tests hold it
against: ``scene.scene.morton_order``, ``shape.mesh.build_edge_list`` and
``utils.obj.parse_obj_text``.

The six functions of the JAX package's host library binding:
:func:`available`, :func:`morton_order`, :func:`build_edge_list`,
:func:`parse_obj`, :func:`read_exr`, :func:`write_exr`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libhostops.so"
# ``write_exr``'s compressions and their codes in the EXR header
COMPRESSION = {"zip": 3, "piz": 4}


def build() -> Path:
    """Compile ``hostops.cpp`` once per hash of the source and the flags;
    returns the library's path. Several processes may build at once: each
    writes its own temporary file and renames it into place."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / f"hostops-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: psdr_jit_tpu_torch's host library "
            "(native/hostops.cpp) is built with g++ and zlib at first "
            "use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_H = ctypes.c_void_p


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded host library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.morton_order.argtypes = [_F32P, ctypes.c_int64, _I32P]
    lib.morton_order.restype = None
    lib.build_edge_list.argtypes = [_I32P, ctypes.c_int64, _I32P]
    lib.build_edge_list.restype = ctypes.c_int64
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.obj_parse.restype = _H
    for fn in ("obj_num_vertices", "obj_num_uvs", "obj_num_faces"):
        getattr(lib, fn).argtypes = [_H]
        getattr(lib, fn).restype = ctypes.c_int64
    lib.obj_has_uv.argtypes = [_H]
    lib.obj_has_uv.restype = ctypes.c_int32
    lib.obj_copy.argtypes = [_H, _F32P, _F32P, _I32P, _I32P]
    lib.obj_copy.restype = None
    lib.obj_free.argtypes = [_H]
    lib.obj_free.restype = None
    lib.exr_load.argtypes = [ctypes.c_char_p]
    lib.exr_load.restype = _H
    for fn in ("exr_width", "exr_height", "exr_num_channels"):
        getattr(lib, fn).argtypes = [_H]
        getattr(lib, fn).restype = ctypes.c_int32
    lib.exr_error.argtypes = [_H]
    lib.exr_error.restype = ctypes.c_char_p
    lib.exr_channel_name.argtypes = [_H, ctypes.c_int32]
    lib.exr_channel_name.restype = ctypes.c_char_p
    lib.exr_copy.argtypes = [_H, _F32P]
    lib.exr_copy.restype = None
    lib.exr_free.argtypes = [_H]
    lib.exr_free.restype = None
    lib.exr_save_ex.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32]
    lib.exr_save_ex.restype = ctypes.c_int32
    return lib


def available() -> bool:
    """Whether the library builds and loads here (g++ and zlib present)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _f32p(a):
    return a.ctypes.data_as(_F32P)


def _i32p(a):
    return a.ctypes.data_as(_I32P)


def morton_order(centroids) -> np.ndarray:
    """Permutation of the rows of ``centroids`` (n, 3) by the 30-bit Morton
    code of each inside their bounding box, stable for equal codes."""
    c = np.ascontiguousarray(centroids, np.float32).reshape(-1, 3)
    out = np.empty(c.shape[0], np.int32)
    library().morton_order(_f32p(c), c.shape[0], _i32p(out))
    return out


def build_edge_list(faces) -> np.ndarray:
    """``(F, 3)`` faces -> ``(E, 5)`` int32 rows ``[v_lo, v_hi, face0,
    face1 (-1 on a boundary), third vertex of face0]``, sorted by
    ``(v_lo, v_hi)``."""
    f = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    out = np.empty((3 * max(f.shape[0], 1), 5), np.int32)
    ne = library().build_edge_list(_i32p(f), f.shape[0], _i32p(out))
    return out[:ne].copy()


def parse_obj(text: bytes) -> dict:
    """OBJ text -> ``{"vertices": (V, 3) float32, "faces": (F, 3) int32,
    "uvs": (T, 2) float32 or None, "face_uvs": (F, 3) int32 or None}``:
    ``v``, ``vt`` and ``f`` lines, polygons fan-triangulated, negative
    indices from the end, normal indices skipped."""
    lib = library()
    handle = lib.obj_parse(text, len(text))
    try:
        nv, nt, nf = (getattr(lib, fn)(handle) for fn in (
            "obj_num_vertices", "obj_num_uvs", "obj_num_faces"))
        has_uv = bool(lib.obj_has_uv(handle)) and nt > 0
        verts = np.empty((nv, 3), np.float32)
        uvs = np.empty((max(nt, 1), 2), np.float32)
        faces = np.empty((max(nf, 1), 3), np.int32)
        face_uvs = np.empty((max(nf, 1), 3), np.int32)
        lib.obj_copy(handle, _f32p(verts), _f32p(uvs), _i32p(faces),
                     _i32p(face_uvs))
    finally:
        lib.obj_free(handle)
    return {"vertices": verts, "faces": faces[:nf],
            "uvs": uvs[:nt] if has_uv else None,
            "face_uvs": face_uvs[:nf] if has_uv else None}


def read_exr(path) -> np.ndarray:
    """A scanline EXR -> (H, W, C) float32, channels R, G, B(, A) where
    the file names them so, else in the file's order."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = library()
    h = lib.exr_load(os.fsencode(path))
    try:
        err = lib.exr_error(h).decode()
        if err:
            raise ValueError(f"EXR read failed for {path!r}: {err}")
        data = np.empty((lib.exr_height(h), lib.exr_width(h),
                         lib.exr_num_channels(h)), np.float32)
        lib.exr_copy(h, _f32p(data))
        names = [lib.exr_channel_name(h, i).decode()
                 for i in range(data.shape[-1])]
    finally:
        lib.exr_free(h)
    # the file lists its channels alphabetically (B, G, R)
    want = [n for n in ("R", "G", "B", "A") if n in names]
    if want and len(want) == len(names):
        data = data[..., [names.index(n) for n in want]]
    return data


def write_exr(path, img, compression: str = "zip") -> None:
    """Write ``img`` (H, W) or (H, W, C), C in 1, 3, 4, as a scanline
    FLOAT EXR, ``compression`` ``"zip"`` or ``"piz"`` (both lossless)."""
    if compression not in COMPRESSION:
        raise ValueError(f"compression {compression!r}: zip or piz")
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"image of shape {img.shape}: (H, W, 1|3|4) "
                         "expected")
    h, w, c = img.shape
    rc = library().exr_save_ex(os.fsencode(path), _f32p(img), w, h, c,
                               COMPRESSION[compression])
    if rc != 0:
        raise ValueError(f"EXR write failed ({rc}) for {path!r}")
