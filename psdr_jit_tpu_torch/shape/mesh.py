"""Triangle meshes (counterpart of ``psdr_jit_tpu/shape/mesh.py``).

World-space triangles from ``load_raw`` and the
``to_world_left @ to_world_raw @ to_world_right`` stack, per-face
:class:`TriangleInfo`, area-weighted vertex normals, and the edge topology
that the primary-edge pass classifies (:func:`build_edge_list`), and the
world-space secondary-edge table built from it (:class:`SecondaryEdgeInfo`).
:meth:`Mesh.configure_data` is differentiable: autograd flows from every
world-space table back to ``vertex_positions_raw`` and the transforms.
:func:`sample_position` samples a point on a mesh uniformly by area (the
area lights' sampling). A mesh may carry texture coordinates
(``load_raw(..., uvs, face_uvs)``): :class:`MeshData` then holds each
face's three UVs (``tri_uv``), which the scene's hits interpolate.
:meth:`Mesh.load` reads an OBJ file and :meth:`Mesh.dump` writes one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import transform as xf
from ..core import warp
from ..core.math import bilinear, cross, norm, normalize, safe_div
from ..core.distribution import DiscreteDistribution
from ..core.object import Object
from ..core.records import PositionSample
from ..ops.gather import gather_rows


def cpu_f32(x) -> torch.Tensor:
    """``x`` as a float32 CPU tensor, inside the autograd graph: the scene
    compile runs on the CPU whatever device its parameters live on."""
    return torch.as_tensor(x, dtype=torch.float32).cpu()


@dataclasses.dataclass
class TriangleInfo:
    """World-space per-face SoA (reference types.h:162-181)."""

    p0: torch.Tensor            # (F, 3)
    e1: torch.Tensor            # (F, 3)
    e2: torch.Tensor            # (F, 3)
    n0: torch.Tensor            # (F, 3) vertex normals at the corners
    n1: torch.Tensor            # (F, 3)
    n2: torch.Tensor            # (F, 3)
    face_normal: torch.Tensor   # (F, 3) unit
    face_area: torch.Tensor     # (F,)
    face_indices: torch.Tensor  # (F, 3) int32


@dataclasses.dataclass
class SecondaryEdgeInfo:
    """World-space silhouette-candidate edges (edge/edge.h:48-70), one row
    an edge of :func:`build_edge_list`."""

    p0: torch.Tensor           # (E, 3) edge start, attached
    e1: torch.Tensor           # (E, 3) edge vector p1 - p0, attached
    n0: torch.Tensor           # (E, 3) face 0's normal
    n1: torch.Tensor           # (E, 3) face 1's normal, 0 on a boundary
    p2: torch.Tensor           # (E, 3) face 0's third vertex
    is_boundary: torch.Tensor  # (E,) bool


@dataclasses.dataclass
class MeshData:
    """Output of :meth:`Mesh.configure_data`."""

    vertex_positions: torch.Tensor  # (V, 3) world space
    tri: TriangleInfo
    total_area: torch.Tensor        # ()
    face_distrb: DiscreteDistribution
    tri_uv: torch.Tensor            # (F, 3, 2) the corners' UVs, 0 without
    sec_edge: Optional[SecondaryEdgeInfo] = None


def build_edge_list(faces) -> np.ndarray:
    """Edge map of a triangle list -> ``(E, 5)`` int32 rows
    ``[v_lo, v_hi, face0, face1 (-1 on a boundary), third vertex of
    face0]``, sorted by ``(v_lo, v_hi)``; face0 is the lowest-index face
    holding the edge (reference mesh.cpp:112-149)."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if f.shape[0] == 0:
        return np.zeros((0, 5), np.int32)
    v0 = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    v1 = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    v2 = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    fid = np.tile(np.arange(f.shape[0], dtype=np.int64), 3)
    lo, hi = np.minimum(v0, v1), np.maximum(v0, v1)
    order = np.lexsort((fid, hi, lo))
    lo, hi, fid, v2 = lo[order], hi[order], fid[order], v2[order]
    key = lo * (f.max() + 1) + hi
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    starts = np.nonzero(first)[0]
    counts = np.diff(np.append(starts, key.shape[0]))
    out = np.full((starts.shape[0], 5), -1, np.int32)
    out[:, 0] = lo[starts]
    out[:, 1] = hi[starts]
    out[:, 2] = fid[starts]
    has2 = counts >= 2
    out[has2, 3] = fid[starts[has2] + 1]
    out[:, 4] = v2[starts]
    return out


def process_mesh(vertex_positions, face_indices):
    """TriangleInfo and area-weighted vertex normals (mesh.cpp:23-62),
    differentiable with respect to ``vertex_positions``."""
    fi = face_indices.long()
    p0 = vertex_positions[fi[:, 0]]
    e1 = vertex_positions[fi[:, 1]] - p0
    e2 = vertex_positions[fi[:, 2]] - p0
    fn = cross(e1, e2)
    fa = norm(fn)
    vals = torch.cat([fn, fa[:, None]], dim=1)
    acc = vertex_positions.new_zeros((vertex_positions.shape[0], 4))
    for k in range(3):
        acc = acc.index_add(0, fi[:, k], vals)
    vertex_normals = normalize(safe_div(acc[:, :3], acc[:, 3:4]))
    tri = TriangleInfo(
        p0=p0, e1=e1, e2=e2,
        n0=vertex_normals[fi[:, 0]],
        n1=vertex_normals[fi[:, 1]],
        n2=vertex_normals[fi[:, 2]],
        face_normal=fn * safe_div(1.0, fa)[:, None],
        face_area=fa * 0.5,
        face_indices=face_indices.to(torch.int32),
    )
    return tri, vertex_normals


class Mesh(Object, xf.TransformStack):
    """User-facing mesh: vertex positions, faces, edge topology and the
    transform stack."""

    def __init__(self):
        self.vertex_positions_raw = torch.zeros((0, 3), dtype=torch.float32)
        self.face_indices = torch.zeros((0, 3), dtype=torch.int32)
        self.vertex_uv = None        # (T, 2) float32, or None
        self.face_uv_indices = None  # (F, 3) int32 rows of vertex_uv
        self._edge_rows = np.zeros((0, 5), np.int32)
        # the reference's user-writable attribute; nothing reads it
        self.valid_edge_indices = np.zeros((0, 2), np.int32)
        self.to_world_raw = torch.eye(4, dtype=torch.float32)
        self.to_world_left = torch.eye(4, dtype=torch.float32)
        self.to_world_right = torch.eye(4, dtype=torch.float32)
        self.use_face_normals = False
        self.enable_edges = True
        self.bsdf_id = -1
        self.emitter_id = -1
        self.id = ""

    # -- the reference's attributes (psdr.cpp:320-338) ---------------------
    def edge_indices(self) -> np.ndarray:
        """``(E, 4)`` int32 rows ``(v0, v1, face0, face1)`` (face1 -1 on a
        boundary): the reference's ``head<4>`` of its edge rows
        (psdr.cpp:337)."""
        return np.ascontiguousarray(self._edge_rows[:, :4])

    @property
    def use_face_normal(self) -> bool:
        return self.use_face_normals

    @use_face_normal.setter
    def use_face_normal(self, v):
        self.use_face_normals = bool(v)

    @property
    def vertex_positions(self):
        """The object-space positions, ``vertex_positions_raw``."""
        return self.vertex_positions_raw

    @vertex_positions.setter
    def vertex_positions(self, v):
        self.vertex_positions_raw = torch.as_tensor(v, dtype=torch.float32)

    @property
    def vertex_normals(self) -> torch.Tensor:
        """Object-space area-weighted vertex normals (mesh.cpp:23-62)."""
        return process_mesh(cpu_f32(self.vertex_positions_raw),
                            self.face_indices)[1]

    def sample_position(self, sample2, active=None) -> PositionSample:
        """A world-space point uniform by area from the uniforms
        ``sample2`` (..., 2) (the reference's Mesh.sample_position)."""
        ps = sample_position(self.configure_data(), cpu_f32(sample2))
        if active is not None:
            ps.is_valid = ps.is_valid & torch.as_tensor(active).cpu()
        return ps

    @property
    def num_vertices(self) -> int:
        return int(self.vertex_positions_raw.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.face_indices.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self._edge_rows.shape[0])

    @property
    def has_uv(self) -> bool:
        return self.vertex_uv is not None

    def load(self, fname: str):
        """Load an OBJ file (``utils.obj.load_obj``): its vertices, faces
        and texture coordinates."""
        from ..utils.obj import load_obj

        data = load_obj(fname)
        return self.load_raw(data["vertices"], data["faces"], data["uvs"],
                             data["face_uvs"])

    def dump(self, fname: str, raw: bool = False):
        """Write the mesh as OBJ in the reference's format (mesh.cpp:
        469-541): the raw vertex positions, or with ``raw`` the world-space
        ones under the transform stack; with ``vn`` vertex normals unless
        the mesh uses face normals."""
        from ..utils.obj import save_obj

        def f32(x):
            return cpu_f32(x).detach()

        verts = f32(self.vertex_positions_raw)
        if raw:
            verts = xf.transform_pos(f32(self.to_world_left)
                                     @ f32(self.to_world_raw)
                                     @ f32(self.to_world_right), verts)
        normals = (None if self.use_face_normals else
                   process_mesh(verts, self.face_indices)[1].numpy())
        uv = (None, None) if self.vertex_uv is None else (
            f32(self.vertex_uv).numpy(), self.face_uv_indices.numpy())
        save_obj(fname, verts.numpy(), self.face_indices.numpy(), *uv,
                 normals=normals, use_face_normals=self.use_face_normals)

    def load_raw(self, vertices, faces, uvs=None, face_uvs=None):
        """Load from arrays (mesh.cpp:74-162): ``uvs`` (T, 2) texture
        coordinates and ``face_uvs`` (F, 3) their rows for each face's
        corners, or neither; builds the edge list when ``enable_edges`` is
        set."""
        self.vertex_positions_raw = torch.as_tensor(
            vertices, dtype=torch.float32).reshape(-1, 3)
        self.face_indices = torch.as_tensor(
            faces, dtype=torch.int32).reshape(-1, 3)
        if uvs is not None and len(uvs):
            self.vertex_uv = torch.as_tensor(
                uvs, dtype=torch.float32).reshape(-1, 2)
            self.face_uv_indices = torch.as_tensor(
                face_uvs, dtype=torch.int32).reshape(-1, 3)
        else:
            self.vertex_uv = self.face_uv_indices = None
        self._edge_rows = (build_edge_list(self.face_indices.numpy())
                           if self.enable_edges
                           else np.zeros((0, 5), np.int32))
        return self

    def configure_data(self, with_edges: bool = False) -> MeshData:
        """Raw parameters -> world-space MeshData on the CPU
        (mesh.cpp:317-382); ``with_edges`` adds the secondary-edge table
        where the mesh has edges enabled."""
        to_world = (cpu_f32(self.to_world_left) @ cpu_f32(self.to_world_raw)
                    @ cpu_f32(self.to_world_right))
        vertex_positions = xf.transform_pos(
            to_world, cpu_f32(self.vertex_positions_raw))
        tri, _ = process_mesh(vertex_positions, self.face_indices)
        sec_edge = None
        if with_edges and self.enable_edges and self.num_edges > 0:
            ei = torch.from_numpy(self._edge_rows.astype(np.int64))
            is_boundary = ei[:, 3] < 0
            p0 = vertex_positions[ei[:, 0]]
            sec_edge = SecondaryEdgeInfo(
                p0=p0,
                e1=vertex_positions[ei[:, 1]] - p0,
                n0=tri.face_normal[ei[:, 2]],
                n1=torch.where(is_boundary[:, None], 0.0, tri.face_normal[
                    torch.clamp(ei[:, 3], min=0)]),
                p2=vertex_positions[ei[:, 4]],
                is_boundary=is_boundary)
        if self.has_uv:
            tri_uv = cpu_f32(self.vertex_uv)[self.face_uv_indices.long()]
        else:
            tri_uv = torch.zeros((self.num_faces, 3, 2))
        return MeshData(
            vertex_positions=vertex_positions,
            tri=tri,
            total_area=torch.sum(tri.face_area),
            face_distrb=DiscreteDistribution.init(tri.face_area),
            tri_uv=tri_uv,
            sec_edge=sec_edge,
        )

    def to_string(self) -> str:
        s = f"Mesh[nv={self.num_vertices}, nf={self.num_faces}"
        if self.id:
            s += f", id={self.id}"
        return s + "]"


def sample_position(mesh_data: MeshData, sample2) -> PositionSample:
    """Uniform-by-area surface sample with sample reuse (mesh.cpp:413-454):
    the first uniform picks the face and is reused for the point. The
    point carries the face's gradients; the Jacobian is the reference's
    material form ``face_area / detach(face_area)`` (mesh.cpp:434), 1 in
    value; the pdf ``1 / total_area`` is detached."""
    idx, _, u0 = mesh_data.face_distrb.sample_reuse(sample2[..., 0])
    st = warp.square_to_uniform_triangle(
        torch.stack([u0, sample2[..., 1]], dim=-1))
    tri = mesh_data.tri
    # one gather of every row the sample reads: millions of lanes share a
    # light's few faces, and gather_rows sums their cotangents by histogram
    rows = gather_rows(torch.cat([tri.p0, tri.e1, tri.e2, tri.face_normal,
                                  tri.face_area[:, None]], dim=1), idx)
    p = bilinear(rows[..., 0:3], rows[..., 3:6], rows[..., 6:9], st)
    face_area = rows[..., 12]
    total = mesh_data.total_area.detach()
    inv_total = safe_div(torch.ones_like(total), total)
    return PositionSample(
        p=p, n=rows[..., 9:12], pdf=inv_total.expand(idx.shape),
        J=safe_div(face_area, face_area.detach()),
        is_valid=torch.ones_like(idx, dtype=torch.bool))
