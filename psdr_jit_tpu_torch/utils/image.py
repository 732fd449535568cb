"""Image files (counterpart of ``psdr_jit_tpu/utils/image.py``; the
reference reads EXR with tinyexr, ``bitmap_loader.cpp``).

``.npy`` (numpy's own), ``.pfm`` (portable float map, bottom-up rows) and
``.exr`` (through the host library, ``native.read_exr``/``write_exr``) hold
float32 HDR images; ``.ppm`` writes an 8-bit preview.
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path) -> np.ndarray:
    """An ``.npy``, ``.pfm`` or ``.exr`` file -> (H, W[, C]) float32; a
    missing file raises ``FileNotFoundError``."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    if path.endswith(".pfm"):
        return read_pfm(path)
    if path.endswith(".exr"):
        from ..native import read_exr

        return read_exr(path)
    raise ValueError(f"Unsupported image format: {path} (use .exr, .npy "
                     "or .pfm)")


def write_image(path, img) -> None:
    """Write ``img`` as ``.npy``, ``.pfm``, ``.ppm`` or ``.exr`` (ZIP), by
    the path's suffix."""
    path = os.fspath(path)
    img = np.asarray(img, np.float32)
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith(".pfm"):
        write_pfm(path, img)
    elif path.endswith(".ppm"):
        write_ppm(path, img)
    elif path.endswith(".exr"):
        from ..native import write_exr

        write_exr(path, img)
    else:
        raise ValueError(f"Unsupported image format: {path}")


def read_pfm(path) -> np.ndarray:
    """A PFM file (``PF`` three channels, ``Pf`` one) -> (H, W, C)."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file")
        channels = 3 if header == "PF" else 1
        w, h = map(int, f.readline().decode().split())
        scale = float(f.readline().decode().strip())
        data = np.fromfile(f, "<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, channels)[::-1].astype(np.float32)


def write_pfm(path, img) -> None:
    """Write (H, W) or (H, W, C) as a little-endian PFM (bottom-up)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    header = "PF" if img.shape[-1] == 3 else "Pf"
    with open(path, "wb") as f:
        f.write(f"{header}\n{img.shape[1]} {img.shape[0]}\n-1.0\n".encode())
        img[::-1].astype("<f4").tofile(f)


def write_ppm(path, img, gamma: float = 2.2) -> None:
    """An 8-bit binary PPM preview of ``img`` (H, W, 3), clamped to [0, 1]
    and gamma-encoded."""
    img = np.asarray(img, np.float32)
    ldr = (srgb(img, gamma) * 255 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        ldr.tofile(f)


def srgb(img, gamma: float = 2.2):
    """``img`` clamped to [0, 1] and raised to ``1 / gamma``."""
    return np.clip(np.asarray(img, np.float32), 0.0, 1.0) ** (1.0 / gamma)
