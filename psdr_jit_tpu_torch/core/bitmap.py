"""Differentiable bitmap textures (counterpart of
``psdr_jit_tpu/core/bitmap.py``, reference src/core/bitmap.cpp).

A :class:`Bitmap` holds ``data`` (H, W, C) float32 and a differentiable
UV transform (``scale``, ``rot``, ``trans``) and evaluates with bilinear
filtering and wrap-around, or in the lat-long environment-map mode
(bitmap.cpp:87-110). A constant is a (1, 1, C) bitmap, which evaluates
by the reference's shortcut (bitmap.cpp:54-59).

The four taps of a lookup are one row of a ``(H*W, 4C)`` table that holds
each texel beside its +1 neighbours in x, in y and in both (the JAX
package's packing), gathered with ``ops.gather.gather_rows``: its backward
sums a texture's cotangents by row, where an advanced-index gather's
backward serialises the many lanes that share a texel on the card.

Image files are not read yet: a path raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.gather import gather_rows


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def eval_bitmap(data, scale, rot, trans, uv, flip_v: bool,
                envmap_mode: bool):
    """Bilinear lookup of ``data`` (H, W, C) at ``uv`` (..., 2) through the
    UV transform: (..., C). Step for step bitmap.cpp:61-131."""
    h, w, nc = data.shape
    if h == 1 and w == 1:
        return data[0, 0].expand(uv.shape[:-1] + (nc,))
    c, s = torch.cos(rot), torch.sin(rot)
    u0, v0 = uv[..., 0] - 0.5, uv[..., 1] - 0.5
    x = u0 * c + v0 * s + 0.5
    y = -u0 * s + v0 * c + 0.5
    if flip_v:
        y = -y
    x = x * scale
    y = y * scale
    x = x - (-0.5 + scale / 2.0)
    y = y + (-0.5 + scale / 2.0)
    x = x + trans[0]
    y = y + trans[1]
    if envmap_mode:
        x = x - 0.5 / w
    x = x - torch.floor(x)
    y = y - torch.floor(y)
    x = x * (w if envmap_mode else w - 1)
    y = y * (h - 1)
    fx, fy = torch.floor(x), torch.floor(y)
    w1x, w1y = x - fx, y - fy
    px, py = fx.to(torch.int64), fy.to(torch.int64)
    if not envmap_mode:
        px = torch.clamp(px, max=w - 2)
    py = torch.clamp(py, max=h - 2)
    px = torch.clamp(px, 0, w - 1)
    py = torch.clamp(py, 0, h - 1)
    # the +1 neighbours pre-shifted: x wraps (the envmap mode's
    # (px + 1) mod w; px + 1 <= w - 1 otherwise), y never reaches the wrap
    rx = torch.roll(data, -1, 1)
    packed = torch.cat([data, rx, torch.roll(data, -1, 0),
                        torch.roll(rx, -1, 0)], -1).reshape(h * w, 4 * nc)
    taps = gather_rows(packed, py * w + px)
    v00, v10 = taps[..., 0:nc], taps[..., nc:2 * nc]
    v01, v11 = taps[..., 2 * nc:3 * nc], taps[..., 3 * nc:4 * nc]
    w0x, w0y = 1.0 - w1x, 1.0 - w1y
    w0x, w1x, w0y, w1y = (a[..., None] for a in (w0x, w1x, w0y, w1y))
    v0 = w0x * v00 + w1x * v10
    v1 = w0x * v01 + w1x * v11
    return w0y * v0 + w1y * v1


@dataclasses.dataclass
class Bitmap:
    """A texture: ``data`` (H, W, C) and its UV transform. Tensors set on
    it keep their autograd graph, so a training step can set them."""

    data: torch.Tensor
    scale: torch.Tensor = 1.0
    rot: torch.Tensor = 0.0
    trans: torch.Tensor = (0.0, 0.0)

    def __post_init__(self):
        self.data = _f32(self.data)
        if self.data.dim() != 3:
            raise ValueError(f"bitmap data of shape {tuple(self.data.shape)}"
                             ": (H, W, C) expected")
        self.scale = _f32(self.scale).reshape(())
        self.rot = _f32(self.rot).reshape(())
        self.trans = _f32(self.trans).reshape(2)

    @staticmethod
    def from_value(value, channels: int) -> "Bitmap":
        arr = _f32(value).reshape(-1)
        if arr.numel() == 1 and channels == 3:
            arr = arr.repeat(3)
        if arr.numel() != channels:
            raise ValueError(f"expected {channels} channels, got "
                             f"{arr.numel()}")
        return Bitmap(arr.reshape(1, 1, channels))

    @staticmethod
    def from_array(array) -> "Bitmap":
        arr = _f32(array)
        return Bitmap(arr[..., None] if arr.dim() == 2 else arr)

    @property
    def resolution(self):
        return (int(self.data.shape[1]), int(self.data.shape[0]))  # (W, H)

    @property
    def channels(self) -> int:
        return int(self.data.shape[-1])

    @property
    def is_constant(self) -> bool:
        return self.data.shape[0] == 1 and self.data.shape[1] == 1

    def eval(self, uv, flip_v: bool = True, envmap_mode: bool = False):
        """The texture at ``uv`` (..., 2): (..., C)."""
        return eval_bitmap(self.data, self.scale, self.rot, self.trans, uv,
                           flip_v, envmap_mode)


def _from(value, channels: int) -> Bitmap:
    if isinstance(value, str):
        raise NotImplementedError(
            f"{value}: image files are not read by the port yet")
    nd = torch.as_tensor(value).dim()
    if nd >= 3 or (nd == 2 and channels == 1):
        return Bitmap.from_array(value)
    return Bitmap.from_value(value, channels)


def Bitmap1f(value=0.0) -> Bitmap:
    """A one-channel bitmap from a scalar or an (H, W[, 1]) array (an image
    path raises)."""
    return _from(value, 1)


def Bitmap3f(value=(0.5, 0.5, 0.5)) -> Bitmap:
    """A three-channel bitmap from an RGB triple or an (H, W, 3) array (an
    image path raises)."""
    return _from(value, 3)
