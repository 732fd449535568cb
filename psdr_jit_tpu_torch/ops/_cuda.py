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
contraction, 0.4% of the closest-hit check rays changed their hit beyond
an f32 tie on the H100 (rays grazing or lying in a triangle's plane;
PERF.md). Where a kernel wants a fused multiply-add it writes ``fmaf``
explicitly. The library also holds one host routine, ``psdr_sah_build``
(the area-split tree of ``bvh.build_sah_bvh``).

``LAUNCHES`` counts the launches of each kernel (``K1``: the closest hit
for F <= 512 triangles, the sweep of ``intersect.cu`` up to 192, the walk
of ``bvh.cu`` above; ``K5`` and ``K6``: the same walk for 512 < F <= 4096
on a tree split by surface area and above on one split at the middle;
``K2``, ``K2-pair``, ``K2-stash``: the detached Li in its three modes;
``K3``: the attached shade; ``K4``: its adjoint; ``K7``, ``K7-jvp``,
``K7-vjp``: the closest hit rebuilt from K1's, K5's or K6's payload, its
tangent and its adjoint); each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that it
went through the kernels.

Each launch is a PyTorch operator of the namespace ``OPS``
(:func:`kernel_op`, ``torch.library.custom_op``) with a fake version that
gives its outputs' shapes and types, so the dispatcher, not the launch,
unwraps the tensors of ``torch.func`` transforms (whose wrappers have no
data pointer for ctypes). The operators run on CUDA tensors only: the CPU
path calls the plain versions, never an operator.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"
SOURCES = ("common.cuh", "sweep.cuh", "shade.cuh", "hit_rebuild.cuh",
           "intersect.cu", "megakernel.cu", "shade.cu", "bvh.cu",
           "hit_rebuild.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpsdr_kernels.so"

OPS = "psdr_jit_tpu_torch"  # the kernels' operator namespace
LAUNCHES = {"K1": 0, "K2": 0, "K2-pair": 0, "K2-stash": 0, "K3": 0,
            "K4": 0, "K5": 0, "K6": 0, "K7": 0, "K7-jvp": 0, "K7-vjp": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_op(name: str, schema: str, data_outputs: bool = True):
    """Register the decorated launch as the CUDA operator ``OPS::name`` of
    ``schema``; attach its fake version with ``.register_fake``. With
    ``data_outputs`` its outputs are data (hit ids and detached distances,
    barycentrics and radiance), not functions of its inputs: autograd
    marks them non-differentiable and passes no gradient back, and
    ``torch.func`` goes through the operator."""
    def wrap(fn):
        op = torch.library.custom_op(f"{OPS}::{name}", fn, mutates_args=(),
                                     device_types="cuda", schema=schema)
        if data_outputs:
            n_args = len(inspect.signature(fn).parameters)

            def setup_context(ctx, inputs, output):
                ctx.mark_non_differentiable(*output)

            op.register_autograd(lambda ctx, *grads: (None,) * n_args,
                                 setup_context=setup_context)
        return op
    return wrap


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
    lib.psdr_sweep.argtypes = [_P, _P, _I, _P, _P, _P, _LL, _P, _P, _P, _P]
    lib.psdr_sweep.restype = _I
    lib.psdr_li_mega.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                                 _P, _P, ctypes.c_uint, _LL, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P]
    lib.psdr_li_mega.restype = _I
    shade = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, ctypes.c_uint,
             _LL, _I, _I, _I]
    lib.psdr_shade_fwd.argtypes = shade + [_P, _P]
    lib.psdr_shade_fwd.restype = _I
    lib.psdr_shade_bwd.argtypes = shade + [_P, _P, _P, _P, _P, _P, _P]
    lib.psdr_shade_bwd.restype = _I
    lib.psdr_bvh.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P]
    lib.psdr_bvh.restype = _I
    lib.psdr_sah_build.argtypes = [_P, _I, _I, _I, ctypes.c_double, _P, _P,
                                   _P, _P]
    lib.psdr_sah_build.restype = _I
    ptrs = ctypes.POINTER(ctypes.c_void_p)  # a C array of pointers
    lib.psdr_k7.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _I, _I,
                            ptrs, _P]
    lib.psdr_k7.restype = _I
    lib.psdr_k7_jvp.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                                _P, _LL, _I, _I, ptrs, _P]
    lib.psdr_k7_jvp.restype = _I
    lib.psdr_k7_vjp.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _LL, _I, _I,
                                ptrs, _P, _P, _P, _P, _P]
    lib.psdr_k7_vjp.restype = _I
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
