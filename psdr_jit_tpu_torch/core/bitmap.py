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

:class:`BitmapTable` evaluates a stack of bitmaps lane by lane, each lane
at its own slot and UV: the BSDF dispatch's per-type parameters.

:meth:`Bitmap.load_openexr`, ``Bitmap1f(path)`` and ``Bitmap3f(path)``
read an image file (``utils.image.read_image``: ``.exr``, ``.pfm``,
``.npy``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.gather import gather_rows


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def pack_taps(data):
    """``data`` (H, W, C) as the ``(H*W, 4C)`` table of a lookup's four
    taps: each texel beside its +1 neighbours in x, in y and in both,
    pre-shifted with wrap-around."""
    h, w, nc = data.shape
    rx = torch.roll(data, -1, 1)
    return torch.cat([data, rx, torch.roll(data, -1, 0),
                      torch.roll(rx, -1, 0)], -1).reshape(h * w, 4 * nc)


def _texture_xy(uv, scale, c, s, tx, ty, flip_v: bool):
    """Texture-space ``(x, y)`` of ``uv`` (..., 2) through the UV transform
    (scale, rotation by cos ``c`` and sin ``s``, translation), before
    wrapping (bitmap.cpp:61-86)."""
    u0, v0 = uv[..., 0] - 0.5, uv[..., 1] - 0.5
    x = u0 * c + v0 * s + 0.5
    y = -u0 * s + v0 * c + 0.5
    if flip_v:
        y = -y
    x = x * scale
    y = y * scale
    x = x - (-0.5 + scale / 2.0)
    y = y + (-0.5 + scale / 2.0)
    return x + tx, y + ty


def _blend(taps, w1x, w1y, nc: int):
    """The bilinear blend of a lookup's four taps (``pack_taps`` rows)."""
    v00, v10 = taps[..., 0:nc], taps[..., nc:2 * nc]
    v01, v11 = taps[..., 2 * nc:3 * nc], taps[..., 3 * nc:4 * nc]
    w0x, w0y = 1.0 - w1x, 1.0 - w1y
    w0x, w1x, w0y, w1y = (a[..., None] for a in (w0x, w1x, w0y, w1y))
    v0 = w0x * v00 + w1x * v10
    v1 = w0x * v01 + w1x * v11
    return w0y * v0 + w1y * v1


def eval_bitmap(data, scale, rot, trans, uv, flip_v: bool,
                envmap_mode: bool):
    """Bilinear lookup of ``data`` (H, W, C) at ``uv`` (..., 2) through the
    UV transform: (..., C). Step for step bitmap.cpp:61-131."""
    h, w, nc = data.shape
    if h == 1 and w == 1:
        return data[0, 0].expand(uv.shape[:-1] + (nc,))
    x, y = _texture_xy(uv, scale, torch.cos(rot), torch.sin(rot), trans[0],
                       trans[1], flip_v)
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
    return _blend(gather_rows(pack_taps(data), py * w + px), w1x, w1y, nc)


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

    def fill(self, value):
        """Make the bitmap the constant ``value`` (a 1x1 bitmap of its
        channels)."""
        self.data = _f32(value).reshape(1, 1, -1)

    # the reference's attribute names (psdr.cpp:204-206)
    @property
    def translate(self):
        return self.trans

    @translate.setter
    def translate(self, v):
        self.trans = _f32(v).reshape(2)

    @property
    def rotate(self):
        return self.rot

    @rotate.setter
    def rotate(self, v):
        self.rot = _f32(v).reshape(())

    def load_openexr(self, path: str) -> "Bitmap":
        """Set ``data`` from an image file, keeping the bitmap's channel
        count: the first channel of many for one, the first three of four
        for three, and one channel repeated for three (the reference's
        Bitmap::load_openexr)."""
        from ..utils.image import read_image

        arr = read_image(path)
        if arr.ndim == 2:
            arr = arr[..., None]
        if self.channels == 1 and arr.shape[-1] > 1:
            arr = arr[..., :1]
        elif self.channels == 3 and arr.shape[-1] == 4:
            arr = arr[..., :3]
        elif self.channels == 3 and arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        self.data = torch.from_numpy(np.ascontiguousarray(arr))
        return self

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

    def eval1(self, uv, flip_v: bool = True):
        """The first channel at ``uv`` (..., 2): (...,)."""
        return self.eval(uv, flip_v)[..., 0]


@dataclasses.dataclass
class BitmapTable:
    """A stack of bitmaps of C channels, a slot each, evaluated per lane
    (``flip_v``, not in envmap mode): a constant slot's value is a row of
    ``const`` (the 1x1 shortcut); the textured slots' ``pack_taps`` tables
    are stacked into one ``atlas``, and each lane's four taps are one row
    of it, at its slot's first row, width, height and UV transform. So a
    lookup is one gather whatever the number of textures, with
    :func:`eval_bitmap`'s arithmetic, bit for bit."""

    const: torch.Tensor                   # (n, C); 0 in textured slots
    atlas: Optional[torch.Tensor] = None  # (rows, 4C)
    texel: Optional[torch.Tensor] = None  # (n, 3) int64 first row, W, H
    #                                       (0, 1, 1) in constant slots
    uv_xf: Optional[torch.Tensor] = None  # (n, 5) scale, cos, sin, trans

    @staticmethod
    def build(bitmaps, device) -> "BitmapTable":
        nc = bitmaps[0].channels
        const = torch.stack([b.data.reshape(nc).to(device) if b.is_constant
                             else torch.zeros(nc, device=device)
                             for b in bitmaps])
        if all(b.is_constant for b in bitmaps):
            return BitmapTable(const)
        texel, uv_xf, packs, row = [], [], [], 0
        z5 = torch.zeros(5, device=device)
        for b in bitmaps:
            if b.is_constant:  # a harmless 1x1 lookup, then discarded
                texel.append((0, 1, 1))
                uv_xf.append(z5)
                continue
            w, h = b.resolution
            texel.append((row, w, h))
            row += w * h
            packs.append(pack_taps(b.data.to(device)))
            uv_xf.append(torch.stack([b.scale, torch.cos(b.rot),
                                      torch.sin(b.rot), b.trans[0],
                                      b.trans[1]]).to(device))
        return BitmapTable(const, torch.cat(packs),
                           torch.tensor(texel, dtype=torch.int64,
                                        device=device),
                           torch.stack(uv_xf))

    def eval(self, slot, uv):
        """The value of each lane's slot ``slot`` (int64) at ``uv`` (...,
        2): (..., C)."""
        val = gather_rows(self.const, slot)
        if self.atlas is None:
            return val
        tex = self.texel[slot]
        w, h = tex[..., 1], tex[..., 2]
        xf = gather_rows(self.uv_xf, slot)
        x, y = _texture_xy(uv, *xf.unbind(-1), flip_v=True)
        x = (x - torch.floor(x)) * (w - 1).to(x.dtype)
        y = (y - torch.floor(y)) * (h - 1).to(y.dtype)
        fx, fy = torch.floor(x), torch.floor(y)
        px = torch.minimum(torch.clamp(torch.minimum(
            fx.to(torch.int64), w - 2), min=0), w - 1)
        py = torch.minimum(torch.clamp(torch.minimum(
            fy.to(torch.int64), h - 2), min=0), h - 1)
        taps = gather_rows(self.atlas, tex[..., 0] + py * w + px)
        val_tex = _blend(taps, x - fx, y - fy, val.shape[-1])
        return torch.where((w * h > 1)[..., None], val_tex, val)


def _from(value, channels: int) -> Bitmap:
    if isinstance(value, str):
        return Bitmap.from_value(0.5, channels).load_openexr(value)
    nd = torch.as_tensor(value).dim()
    if nd >= 3 or (nd == 2 and channels == 1):
        return Bitmap.from_array(value)
    return Bitmap.from_value(value, channels)


def Bitmap1f(value=0.0) -> Bitmap:
    """A one-channel bitmap from a scalar, an (H, W[, 1]) array or an
    image file's path (its first channel)."""
    return _from(value, 1)


def Bitmap3f(value=(0.5, 0.5, 0.5)) -> Bitmap:
    """A three-channel bitmap from an RGB triple, an (H, W, 3) array or an
    image file's path."""
    return _from(value, 3)
