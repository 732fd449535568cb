"""Wavefront OBJ read and write (counterpart of
``psdr_jit_tpu/utils/obj.py``; reference ``mesh.cpp:165-314``, its
tinyobjloader, and ``Mesh::dump``, ``mesh.cpp:469-541``).

:func:`load_obj` parses with the host library (``native.parse_obj``);
:func:`parse_obj_text` is the same parser in Python, the specification
the tests and the card's smoke run hold the library against. Polygons are
fan-triangulated, as tinyobjloader does by default.
"""

from __future__ import annotations

import numpy as np


def load_obj(path_or_text: str, from_string: bool = False) -> dict:
    """Parse an OBJ file (or, with ``from_string``, OBJ text) ->
    ``{"vertices": (V, 3) float32, "faces": (F, 3) int32, "uvs": (T, 2)
    float32 or None, "face_uvs": (F, 3) int32 or None}``."""
    from ..native import parse_obj

    if from_string:
        return parse_obj(path_or_text.encode())
    with open(path_or_text, "rb") as f:
        return parse_obj(f.read())


def parse_obj_text(text: str) -> dict:
    """:func:`load_obj`'s parser in Python: ``v``, ``vt`` and ``f`` lines,
    negative indices counted from the end, normal indices skipped."""
    vertices, uvs, faces, face_uvs = [], [], [], []
    any_uv_idx = False
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v":
            vertices.append([float(parts[1]), float(parts[2]),
                             float(parts[3])])
        elif tag == "vt":
            uvs.append([float(parts[1]), float(parts[2])])
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                comps = tok.split("/")
                vi = int(comps[0])
                vi = vi - 1 if vi > 0 else len(vertices) + vi
                ti = -1
                if len(comps) > 1 and comps[1]:
                    ti = int(comps[1])
                    ti = ti - 1 if ti > 0 else len(uvs) + ti
                    any_uv_idx = True
                corners.append((vi, ti))
            for k in range(1, len(corners) - 1):
                tri = (corners[0], corners[k], corners[k + 1])
                faces.append([c[0] for c in tri])
                face_uvs.append([c[1] for c in tri])
    has_uv = bool(uvs) and any_uv_idx
    return {
        "vertices": np.asarray(vertices, np.float32).reshape(-1, 3),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "uvs": np.asarray(uvs, np.float32).reshape(-1, 2) if has_uv else None,
        "face_uvs": (np.asarray(face_uvs, np.int32).reshape(-1, 3)
                     if has_uv else None),
    }


def save_obj(path: str, vertices, faces, uvs=None, face_uvs=None,
             normals=None, use_face_normals: bool = False):
    """Write an OBJ file in the reference's dump format
    (``mesh.cpp:469-541``): ``%.6e`` coordinates, 1-based indices, vertex
    normals as ``vn`` lines unless ``use_face_normals``."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    with_vn = normals is not None and not use_face_normals
    with open(path, "wt") as f:
        for i, v in enumerate(vertices):
            f.write(f"v {v[0]:.6e} {v[1]:.6e} {v[2]:.6e}\n")
            if with_vn:
                n = normals[i]
                f.write(f"vn {n[0]:.6e} {n[1]:.6e} {n[2]:.6e}\n")
        if uvs is not None:
            for t in np.asarray(uvs, np.float64):
                f.write(f"vt {t[0]:.6e} {t[1]:.6e}\n")
            for i, face in enumerate(faces):
                fu = np.asarray(face_uvs[i]) + 1
                v0, v1, v2 = face + 1
                if with_vn:
                    f.write(f"f {v0}/{fu[0]}/{v0} {v1}/{fu[1]}/{v1} "
                            f"{v2}/{fu[2]}/{v2}\n")
                else:
                    f.write(f"f {v0}/{fu[0]} {v1}/{fu[1]} {v2}/{fu[2]}\n")
        else:
            for face in faces:
                v0, v1, v2 = face + 1
                if with_vn:
                    f.write(f"f {v0}//{v0} {v1}//{v1} {v2}//{v2}\n")
                else:
                    f.write(f"f {v0} {v1} {v2}\n")
