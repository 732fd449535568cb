"""Lat-long environment map (counterpart of
``psdr_jit_tpu/emitter/envmap.py``, reference src/emitter/envmap.cpp).

The scene compile adds an inward-facing box around the scene, the
bounding mesh, whose emitter is the map, so that every ray that leaves the
scene ends on geometry (scene.cpp:435-485). Position sampling draws a
direction from the map's luminance * sin(theta) table and places the point
where that direction leaves the scene's box (envmap.cpp:87-114). The table
has 2(w-1) x 2(h-1) cells; :meth:`Scene.configure` builds it once, with
alias rows above ``SEARCHSORTED_DENSE_MAX`` cells, and caches it on the
map, so that a training step's scene compile, which runs every step,
takes it as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import transform as xf
from ..core.bitmap import Bitmap
from ..core.distribution import HyperCubeDistribution
from ..core.math import (dot, ray_intersect_scene_aabb, rgb2luminance,
                         safe_div, safe_rsqrt, squared_norm)
from ..core.records import PositionSample
from ..core.types import EPSILON, INV_PI, INV_TWO_PI, PI, TWO_PI, Ray
from .emitter import Emitter


class EnvironmentMap(Emitter):
    """``EnvironmentMap(radiance, scale)``: an (H, W, 3) lat-long radiance
    array, a :class:`Bitmap` or an image file's path (its first three
    channels); a constant 1x1 white map by default. A tensor set on it
    keeps its autograd graph."""

    def __init__(self, radiance=None, scale=1.0):
        if radiance is None:
            radiance = Bitmap.from_value((1.0, 1.0, 1.0), 3)
        elif isinstance(radiance, str):
            from ..utils.image import read_image

            radiance = Bitmap.from_array(
                np.ascontiguousarray(read_image(radiance)[..., :3]))
        elif not isinstance(radiance, Bitmap):
            radiance = Bitmap.from_array(radiance)
        self.radiance = radiance
        self.scale = scale
        self.to_world_raw = torch.eye(4, dtype=torch.float32)
        self.to_world_left = torch.eye(4, dtype=torch.float32)
        self.mesh_index = -1  # the bounding mesh, set by the scene compile
        self.id = ""
        # the importance table of the last Scene.configure()
        self._cell_distrb_cache = None

    @property
    def scale(self) -> torch.Tensor:
        return self._scale

    @scale.setter
    def scale(self, value):
        self._scale = torch.as_tensor(value, dtype=torch.float32).reshape(())

    def set_transform(self, m):
        """Set ``to_world_left`` of the map's ``left @ raw`` pose; a tensor
        keeps its autograd graph, so the orientation can be optimised."""
        self.to_world_left = torch.as_tensor(m, dtype=torch.float32)

    def to_string(self) -> str:
        return "EnvironmentMap[]"


def _direction_uv(v):
    """Lat-long coordinates in [0, 1)^2 of local directions ``v``. The pole
    clamp keeps d(acos) finite (the JAX package's)."""
    u = torch.atan2(v[..., 0], -v[..., 2]) * INV_TWO_PI
    w = torch.acos(torch.clamp(v[..., 1], -1.0 + 1e-6, 1.0 - 1e-6)) * INV_PI
    uv = torch.stack([u, w], -1)
    return uv - torch.floor(uv)


def _inv_sin_theta(d):
    s2 = d[..., 0] * d[..., 0] + d[..., 2] * d[..., 2]
    return safe_rsqrt(torch.clamp(s2, min=EPSILON * EPSILON))


@dataclasses.dataclass
class EnvironmentMapData:
    """Configured map. ``sampling_weight`` is its normalized share of the
    emitters' weights; ``lower``/``upper`` the scene's box."""

    radiance: Bitmap
    scale: torch.Tensor             # ()
    to_world: torch.Tensor          # (4, 4)
    from_world: torch.Tensor        # (4, 4)
    cell_distrb: HyperCubeDistribution
    lower: torch.Tensor             # (3,)
    upper: torch.Tensor             # (3,)
    sampling_weight: torch.Tensor   # ()
    mesh_index: int = -1

    def eval(self, its, active):
        """Radiance arriving along the hit's incident direction."""
        wi_world = its.sh_frame.to_world(its.wi)
        return self.eval_direction(-wi_world, active)

    def eval_direction(self, wi, active):
        """Radiance along world directions ``wi`` (envmap.cpp:57-73):
        (..., 3), attached to the texture, the scale, the transform and
        ``wi``."""
        uv = _direction_uv(xf.transform_dir(self.from_world, wi))
        val = self.radiance.eval(uv, flip_v=False, envmap_mode=True) * \
            self.scale
        return torch.where(active[..., None], val, 0.0)

    def sample_direction(self, uv, u_coin=None):
        """A world direction from the cell table and its solid-angle pdf,
        detached (envmap.cpp:117-132); ``u_coin`` is the table's alias coin
        where it needs one."""
        uv, pdf = self.cell_distrb.sample_reuse(uv, u_coin)
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * TWO_PI
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        sin_p, cos_p = torch.sin(phi), torch.cos(phi)
        # the (y, z, -x) axis shuffle of envmap.cpp:123
        d = torch.stack([sin_p * sin_t, cos_t, -(cos_p * sin_t)], -1)
        pdf = torch.where(pdf > EPSILON,
                          pdf * _inv_sin_theta(d) * (0.5 / PI ** 2), pdf)
        return xf.transform_dir(self.to_world.detach(), d), pdf

    def sample_position(self, ref_p, sample2, active,
                        u_coin=None) -> PositionSample:
        """A direction, then the point where it leaves the scene's box from
        ``ref_p`` (envmap.cpp:87-114); detached, ``J = 1``."""
        o = ref_p.detach()
        d, pdf = self.sample_direction(
            sample2.detach(), None if u_coin is None else u_coin.detach())
        t, n, g = ray_intersect_scene_aabb(Ray(o, d), self.lower.detach(),
                                           self.upper.detach())
        return PositionSample(p=o + d * t[..., None], n=n, pdf=pdf * g,
                              J=torch.ones_like(pdf), is_valid=active)

    def sample_position_pdf(self, ref_p, its, active):
        """The density of :meth:`sample_position` at a hit on the bounding
        mesh (envmap.cpp:142-162), times the map's emitter-selection
        probability as area lights have it: the reference leaves that
        factor out, and the JAX package knowingly differs from it
        (JAX envmap.py:147-152), so MIS weights partition unity with
        several emitters. Detached."""
        d = its.p.detach() - ref_p.detach()
        dist2 = squared_norm(d)
        d = d * safe_rsqrt(dist2)[..., None]
        g = safe_div(torch.abs(dot(d, its.n.detach())), dist2)
        d = xf.transform_dir(self.from_world.detach(), d)
        factor = g * _inv_sin_theta(d) * (0.5 / PI ** 2)
        ok = active & (its.mesh_id == self.mesh_index)
        pdf = self.cell_distrb.pdf(_direction_uv(d)) * factor * \
            self.sampling_weight.detach()
        return torch.where(ok, pdf, 0.0)


def build_envmap_distribution(radiance: Bitmap) -> HyperCubeDistribution:
    """The importance table: luminance * sin(theta) at the centres of a
    2(w-1) x 2(h-1) grid, x outermost (cell ``x * height + y``, the
    reference's ``HyperCubeDistribution<2>``), at least 2 x 2 (a constant
    map's table is sin(theta) alone). Detached; built on the texture's
    device (envmap.cpp:17-41)."""
    w0, h0 = radiance.resolution
    width, height = max((w0 - 1) * 2, 2), max((h0 - 1) * 2, 2)
    data = radiance.data.detach()
    idx = torch.arange(width * height, dtype=torch.int32,
                       device=data.device)
    x = (idx // height).to(torch.float32)
    y = (idx % height).to(torch.float32)
    uv = torch.stack([(x + 0.5) / width, (y + 0.5) / height], -1)
    val = Bitmap(data, radiance.scale.detach(), radiance.rot.detach(),
                 radiance.trans.detach()).eval(uv, flip_v=False,
                                               envmap_mode=True)
    theta = (y + 0.5) * (PI / height)
    mass = rgb2luminance(val) * torch.sin(theta)
    return HyperCubeDistribution.init((width, height), mass)
