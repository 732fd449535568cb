"""Build, load and count the port's hand-written CUDA kernels.

The kernels (``psdr_jit_tpu_torch/csrc``) are compiled at first use with
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ctypes. The build goes to
``psdr_jit_tpu_torch/build/<hash of sources and flags>/``, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at
import time: the CPU path never needs ``nvcc``.

``--use_fast_math`` is deliberately absent: it changes ``1/x``, ``sqrtf``
and the trigonometric functions, and with them the visibility tests that
the kernels must share with their plain PyTorch versions. ``-fmad=false``
keeps nvcc from contracting ``a * b + c`` into fused multiply-adds, so the
kernels evaluate the same f32 expressions as the plain versions: with
contraction, 0.4% of K1's check rays changed their hit beyond an f32 tie
on the H100 (rays grazing or lying in a triangle's plane; PERF.md). Where a
kernel wants a fused multiply-add it writes ``fmaf`` explicitly.

``LAUNCHES`` counts the launches of each kernel (``K1``: closest hit;
``K2``, ``K2-pair``, ``K2-stash``: the detached Li in its three modes;
``K3``: the attached shade; ``K4``: its adjoint; ``K5``: the streamed
super-block sweep; ``K6``: the tree traversal); each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
SOURCES = ("common.cuh", "sweep.cuh", "shade.cuh", "intersect.cu",
           "megakernel.cu", "shade.cu", "intersect_super.cu", "bvh.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpsdr_kernels.so"

LAUNCHES = {"K1": 0, "K2": 0, "K2-pair": 0, "K2-stash": 0, "K3": 0,
            "K4": 0, "K5": 0, "K6": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of psdr_jit_tpu_torch are built "
        "from psdr_jit_tpu_torch/csrc with the CUDA toolkit at first use")


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc`` (the package's sources unless a
    measurement gives an edited copy) once per source hash; returns the
    library path. Each ``.cu`` is compiled by its own ``nvcc``, all at
    once, then linked. ``ptxas.txt`` beside the library holds ptxas's
    register and spill report."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for name in SOURCES:
        if name.endswith(".cu"):
            obj = out_dir / f"{name}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)]
            jobs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    report, failed = [], []
    for obj, cmd, proc in jobs:
        out = proc.communicate()[0]
        report.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
           *(str(obj) for obj, _, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj, _, _ in jobs:
        obj.unlink()
    (out_dir / "ptxas.txt").write_text("".join(report))
    os.replace(tmp, lib)
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def library(csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc``, built on first call."""
    lib = ctypes.CDLL(str(build(csrc)))
    lib.psdr_intersect.argtypes = [_P, _P, _I, _P, _P, _LL, _P, _P, _P, _P]
    lib.psdr_intersect.restype = _I
    lib.psdr_li_mega.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                                 _P, _P, ctypes.c_uint, _LL, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P]
    lib.psdr_li_mega.restype = _I
    shade = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint,
             _LL, _I, _I, _I]
    lib.psdr_shade_fwd.argtypes = shade + [_P, _P]
    lib.psdr_shade_fwd.restype = _I
    lib.psdr_shade_bwd.argtypes = shade + [_P, _P, _P, _P, _P, _P, _P]
    lib.psdr_shade_bwd.restype = _I
    lib.psdr_intersect_super.argtypes = [_P, _P, _I, _P, _P, _P, _LL, _P,
                                         _P, _P, _P]
    lib.psdr_intersect_super.restype = _I
    lib.psdr_bvh.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P]
    lib.psdr_bvh.restype = _I
    lib.psdr_error_string.argtypes = [_I]
    lib.psdr_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().psdr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def require(x: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device):
    """Check what a kernel accepts: a contiguous CUDA tensor of ``dtype``
    and ``shape`` (``None`` for a free dimension) on ``device``."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if (x.dim() != len(shape)
            or any(s is not None and s != d for s, d in zip(shape, x.shape))):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
