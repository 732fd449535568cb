"""Configured camera data and the primary-edge machinery (counterpart of
``psdr_jit_tpu/sensor/sensor.py``).

Silhouette edges are kept as the full static edge list with non-silhouette
edges given zero sampling mass, as in the JAX package. Its one-hot
``gather_rows`` (a TPU workaround) are plain index gathers here; their
backward is autograd's ``index_add``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.types import Ray, EPSILON, EDGE_EPSILON
from ..core.math import (detached, dot, normalize, safe_div, safe_sqrt,
                         squared_norm)
from ..core.distribution import DiscreteDistribution
from ..core.object import Object
from ..core.records import SensorDirectSample
from ..core import transform as xf
from ..ops.gather import gather_rows


class Sensor(Object, xf.TransformStack):
    """User-facing camera base: the pose is the stack
    ``to_world_left @ to_world_raw @ to_world_right``."""


@dataclasses.dataclass
class PrimaryEdgeInfo:
    """Screen-space projected silhouette candidates (edge/edge.h:26-41)."""

    p0: torch.Tensor           # (E, 2) sample-space endpoints, attached
    p1: torch.Tensor           # (E, 2)
    edge_normal: torch.Tensor  # (E, 2) detached screen normal
    edge_length: torch.Tensor  # (E,) detached screen length, 0 = masked out
    distrb: DiscreteDistribution


@dataclasses.dataclass
class PrimaryEdgeSample:
    """A point on a projected silhouette edge (edge/edge.h:13-23)."""

    x_dot_n: torch.Tensor  # (N,) attached screen-space normal velocity
    idx: torch.Tensor      # (N,) pixel index, -1 = off screen
    ray_p: Ray             # ray offset +EDGE_EPSILON along the edge normal
    ray_n: Ray             # ray offset -EDGE_EPSILON
    pdf: torch.Tensor      # (N,)


@dataclasses.dataclass
class SensorData:
    """Configured camera, perspective or (``ortho``) orthographic."""

    sample_to_camera: torch.Tensor  # (4, 4)
    to_world: torch.Tensor          # (4, 4), attached pose
    world_to_sample: torch.Tensor   # (4, 4)
    camera_pos: torch.Tensor        # (3,)
    camera_dir: torch.Tensor        # (3,)
    inv_area: torch.Tensor          # ()
    edge_info: Optional[PrimaryEdgeInfo] = None
    width: int = 0
    height: int = 0
    ortho: bool = False

    def sample_primary_ray(self, samples, diff: bool = True) -> Ray:
        """Camera rays through sample-space points ``samples`` (..., 2)
        (perspective.cpp:160-178): from the eye, or (``ortho``) parallel
        rays along the view axis from the near plane. The camera-space
        direction is detached; the pose ``to_world`` carries gradients
        when ``diff``."""
        to_world = self.to_world if diff else self.to_world.detach()
        p3 = torch.cat([samples, torch.zeros_like(samples[..., :1])], dim=-1)
        near_p = xf.transform_pos(self.sample_to_camera.detach(), p3)
        if self.ortho:
            d_cam = torch.zeros_like(near_p)
            d_cam[..., 2] = 1.0
            return Ray(xf.transform_pos(to_world, near_p),
                       xf.transform_dir(to_world, d_cam))
        d_cam = normalize(near_p).detach()
        o = xf.transform_pos(to_world, torch.zeros_like(near_p))
        d = xf.transform_dir(to_world, d_cam)
        return Ray(o, d)

    def sample_direct(self, p) -> SensorDirectSample:
        """Projection of world points ``p`` (..., 3) to the sensor: sample
        position, pixel (-1 off screen) and importance ``W_e``
        (perspective.cpp:181-197), detached."""
        with detached():
            q = xf.transform_pos(self.world_to_sample, p)[..., :2]
            iq = torch.floor(torch.stack([q[..., 0] * float(self.width),
                                          q[..., 1] * float(self.height)],
                                         -1)).to(torch.int64)
            is_valid = ((iq[..., 0] >= 0) & (iq[..., 0] < self.width)
                        & (iq[..., 1] >= 0) & (iq[..., 1] < self.height))
            pixel_idx = torch.where(is_valid,
                                    iq[..., 1] * self.width + iq[..., 0], -1)
            if self.ortho:
                # Parallel projection: |d^2 s / dA| is the constant
                # 1 / A_plane, with no 1 / dist^2 falloff and no ray
                # obliquity. The reference reuses the perspective formula
                # here (orthographic.cpp:185-190), which is wrong for an
                # orthographic camera; the JAX package knowingly differs
                # from it, and so does this port (JAX sensor.py:107-114).
                return SensorDirectSample(
                    q=q, pixel_idx=pixel_idx,
                    sensor_val=self.inv_area.detach().expand(
                        pixel_idx.shape),
                    is_valid=is_valid)
            dir_ = p - self.camera_pos
            dist2 = squared_norm(dir_)
            dir_ = dir_ * safe_div(1.0, safe_sqrt(dist2))[..., None]
            c = safe_div(1.0, dot(self.camera_dir, dir_))
            sensor_val = safe_div(1.0, dist2) * (c * (c * c)) * self.inv_area
        return SensorDirectSample(q=q, pixel_idx=pixel_idx,
                                  sensor_val=sensor_val, is_valid=is_valid)


def _dot2(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def floored_edge_distrb(info: PrimaryEdgeInfo) -> DiscreteDistribution:
    """The table a scene compile samples a large primary-edge set from
    while the geometry moves (JAX scene.py:759-783): the silhouettes'
    lengths plus 1/16 of their total spread over every projected edge by
    length, so that an edge that becomes a silhouette after the last
    ``configure()`` stays sampleable (a non-silhouette draw weighs 0),
    with alias rows. Detached."""
    with detached():
        keep = info.edge_length
        e = info.p1 - info.p0
        raw = safe_sqrt(_dot2(e, e))
        tk = keep.sum()
        tr = torch.clamp(raw.sum(), min=1e-30)
        mass = keep + raw * (torch.where(tk > 0.0, tk, tr) / tr / 16.0)
        return DiscreteDistribution.init(mass).with_alias()


def sample_primary_edge(sensor: SensorData, sample1,
                        u_coin=None) -> PrimaryEdgeSample:
    """Sample a point on a projected silhouette edge
    (perspective.cpp:200-226); ``u_coin`` is the edge table's alias coin
    where it needs one."""
    info = sensor.edge_info
    edge_idx, pdf, u = info.distrb.sample_reuse(sample1, u_coin)
    j = edge_idx.long()
    # gather_rows, an index_select: the backward of ``p0[j]`` is a sorted
    # index_put that walks each edge's run of duplicate samples serially,
    # 44 ms a 2^21-lane chunk on an H100 (PERF.md)
    p0 = gather_rows(info.p0, j)
    p1 = gather_rows(info.p1, j)
    edge_normal = info.edge_normal[j].detach()
    pdf = safe_div(pdf, info.edge_length[j].detach())
    p_diff = p0 * (1.0 - u[..., None]) + p1 * u[..., None]
    p = p_diff.detach()
    x_dot_n = _dot2(p_diff, edge_normal)
    res = torch.tensor([sensor.width, sensor.height], dtype=torch.float32,
                       device=p.device)
    ip = torch.floor(p * res).to(torch.int64)
    valid = ((ip[..., 0] >= 0) & (ip[..., 0] < sensor.width)
             & (ip[..., 1] >= 0) & (ip[..., 1] < sensor.height))
    idx = torch.where(valid, ip[..., 1] * sensor.width + ip[..., 0], -1)
    ray_p = sensor.sample_primary_ray(p + EDGE_EPSILON * edge_normal,
                                      diff=False)
    ray_n = sensor.sample_primary_ray(p - EDGE_EPSILON * edge_normal,
                                      diff=False)
    return PrimaryEdgeSample(x_dot_n=x_dot_n, idx=idx, ray_p=ray_p,
                             ray_n=ray_n, pdf=pdf)


def uv_seams(mesh) -> torch.Tensor:
    """(E,) bool: the edges of a mesh with UVs whose two faces share fewer
    than two UV rows (a texture seam, or a boundary edge), which stay
    primary edges whatever the view (JAX sensor.py:211-226)."""
    fuv = mesh.face_uv_indices.long()
    ei = torch.as_tensor(mesh._edge_rows, dtype=torch.int64)
    fuv1 = fuv[ei[:, 2]]
    fuv2 = fuv[torch.clamp(ei[:, 3], min=0)]
    shared = (fuv1[:, :, None] == fuv2[:, None, :]).any(-1).sum(-1)
    return shared != 2


def build_primary_edges(camera_pos, world_to_sample, mesh_list,
                        mesh_datas, camera_dir=None
                        ) -> Optional[PrimaryEdgeInfo]:
    """Silhouette classification and screen projection of every
    edge-enabled mesh's edges (perspective.cpp:48-151), masked instead of
    compacted. The classification is detached; the projected endpoints
    carry gradients. ``camera_dir`` given (an orthographic camera): the
    faces are classified against the parallel view direction, not the
    eye position (the reference reuses the position form,
    orthographic.cpp:64-66, which misclassifies silhouettes when the
    camera plane is near the scene; JAX sensor.py:173-200)."""
    p0s, p1s, normals, lengths = [], [], [], []
    for mesh, md in zip(mesh_list, mesh_datas):
        if not mesh.enable_edges or mesh.num_edges == 0:
            continue
        ei = torch.as_tensor(mesh._edge_rows, dtype=torch.int64,
                             device=md.vertex_positions.device)
        tri = md.tri
        has_f1 = ei[:, 3] >= 0
        f1 = torch.clamp(ei[:, 3], min=0)
        tp0 = tri.p0.detach()
        tfn = tri.face_normal.detach()
        if camera_dir is not None:
            e0 = (-normalize(camera_dir.detach())).expand(ei.shape[0], 3)
            e1 = e0
        else:
            cam = camera_pos.detach()
            e0 = normalize(cam - tp0[ei[:, 2]])
            e1 = normalize(cam - tp0[f1])
        n0 = tfn[ei[:, 2]]
        n1 = tfn[f1]
        d00 = dot(e0, n0)
        d11 = dot(e1, n1)
        if mesh.use_face_normals:
            skip = has_f1 & (((d00 < EPSILON) & (d11 < EPSILON))
                             | (dot(n0, n1) > 1.0 - EPSILON))
            keep = ~skip
        else:
            keep = (~has_f1) | ((d00 > EPSILON) ^ (d11 > EPSILON))
        if mesh.has_uv:
            keep = keep | uv_seams(mesh).to(keep.device)
        vp = md.vertex_positions
        q0 = xf.transform_pos(world_to_sample, vp[ei[:, 0]])[..., :2]
        q1 = xf.transform_pos(world_to_sample, vp[ei[:, 1]])[..., :2]
        e_scr = (q1 - q0).detach()
        length = safe_sqrt(_dot2(e_scr, e_scr))
        e_unit = e_scr * safe_div(1.0, length)[..., None]
        p0s.append(q0)
        p1s.append(q1)
        normals.append(torch.stack([-e_unit[..., 1], e_unit[..., 0]], -1))
        lengths.append(torch.where(keep, length, 0.0))
    if not p0s:
        return None
    edge_length = torch.cat(lengths)
    return PrimaryEdgeInfo(
        p0=torch.cat(p0s), p1=torch.cat(p1s),
        edge_normal=torch.cat(normals), edge_length=edge_length,
        distrb=DiscreteDistribution.init(edge_length))
