"""Vector math helpers (counterpart of ``psdr_jit_tpu/core/math.py``).

Vectors are ``(..., 3)`` tensors. Dot products are written out as
``x*x + y*y + z*z`` rather than a reduction, and only IEEE-rounded
operations are used, so every lane's arithmetic is the same on every
device and at every batch size.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import forward_ad

_TINY = 1e-20


@contextlib.contextmanager
def detached():
    """A block whose results carry no derivative: the JAX package's
    ``stop_gradient`` seams. ``torch.no_grad`` stops reverse mode only;
    the tangents of ``torch.autograd.forward_ad`` flow through it, so the
    block also turns forward-mode gradients off. A view (a slice, a
    reshape, ``expand``) of a tensor with a tangent keeps its tangent even
    here: detach such a tensor before a view of it leaves the block."""
    with torch.no_grad(), forward_ad._set_fwd_grad_enabled(False):
        yield


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def squared_norm(v):
    return dot(v, v)


def norm(v):
    return safe_sqrt(squared_norm(v))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _sqrt(x):
    """sqrt of float32 ``x``, correctly rounded on every device. The card's
    float32 ``sqrt`` is (it equals the rounded float64 root on all of
    4,194,304 inputs, ``scripts/torch_gather_sqrt.py``); torch's on the CPU
    is not, and differs on about 0.5% of them, so there the root is taken
    in float64 and rounded once to float32, which is exact for a square
    root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def safe_sqrt(x):
    """sqrt(max(x, 0)); 0 where x <= 0."""
    return torch.where(x > 0.0, _sqrt(torch.clamp(x, min=_TINY)), 0.0)


def safe_rsqrt(x):
    """1 / sqrt(x), and 0 where x <= 0. Written as a division: IEEE-rounded
    on every device, where ``torch.rsqrt`` is approximate on CUDA."""
    return torch.where(x > 0.0, 1.0 / _sqrt(torch.clamp(x, min=_TINY)), 0.0)


def safe_div(a, b):
    """a / b, and 0 where |b| <= 1e-20."""
    ok = torch.abs(b) > _TINY
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def normalize(v):
    """v / |v|, and 0 for zero vectors."""
    return v * safe_rsqrt(squared_norm(v))[..., None]


def sign_eps(x, eps):
    """{-1, 0, +1} as int32 with a dead zone of +-``eps`` (reference
    utils.h:48-54)."""
    return (x > eps).to(torch.int32) - (x < -eps).to(torch.int32)


def rgb2luminance(rgb):
    """BT.709 luminance (reference utils.h:77-80)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def bilinear(p0, e1, e2, st):
    """p0 + e1*s + e2*t (reference utils.h:65-68)."""
    return p0 + e1 * st[..., 0:1] + e2 * st[..., 1:2]


def ray_intersect_triangle(p0, e1, e2, ray):
    """Moller-Trumbore against one triangle a lane, differentiable:
    ``((u, v) (..., 2), t (...,))`` (reference utils.h:83-93). Nothing is
    masked; a ray parallel to the triangle's plane gives 0, not NaN."""
    h = cross(ray.d, e2)
    a = dot(e1, h)
    f = safe_div(torch.ones_like(a), a)
    s = ray.o - p0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray.d, q)
    t = f * dot(e2, q)
    return torch.stack([u, v], dim=-1), t


def mis_weight(pdf1, pdf2):
    """Power heuristic, beta = 2 (reference utils.h:278-281)."""
    w1 = pdf1 * pdf1
    w2 = pdf2 * pdf2
    return safe_div(w1, w1 + w2)


def scrub_nonfinite(x):
    """Replace non-finite entries by 0 (reference integrator.cpp:126)."""
    return torch.where(torch.isfinite(x), x, 0.0)
