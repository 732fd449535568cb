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


def lerp(a, b, t):
    return a + (b - a) * t


def mulsign(x, s):
    """x * sign(s) with sign(0) = +1 (Dr.Jit's ``mulsign``)."""
    return torch.where(s >= 0.0, x, -x)


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


def ray_intersect_scene_aabb(ray, lower, upper):
    """Rays against the scene's box from the inside (reference
    utils.h:145-164): ``(t, n, G)``, the distance to the exit face, that
    face's inward normal and the geometry factor ``dot(n, -d) / t^2``. A
    zero direction component never leaves through its axis: its slab time
    is +inf. The exit axis is the first of the smallest slab times."""
    inv_d = safe_div(torch.ones_like(ray.d), ray.d)
    t1 = (lower - ray.o) * inv_d
    t2 = (upper - ray.o) * inv_d
    t_far = torch.where(ray.d == 0.0, float("inf"), torch.maximum(t1, t2))
    tx, ty, tz = t_far.unbind(-1)
    ax0 = (tx <= ty) & (tx <= tz)
    ax1 = ~ax0 & (ty <= tz)
    ax2 = ~ax0 & ~ax1
    t = torch.where(ax0, tx, torch.where(ax1, ty, tz))
    n = -torch.sign(ray.d) * torch.stack([ax0, ax1, ax2], -1).to(
        ray.d.dtype)
    g = dot(n, -ray.d) * safe_div(torch.ones_like(t), t * t)
    return t, n, g


def mis_weight(pdf1, pdf2):
    """Power heuristic, beta = 2 (reference utils.h:278-281)."""
    w1 = pdf1 * pdf1
    w2 = pdf2 * pdf2
    return safe_div(w1, w1 + w2)


def scrub_nonfinite(x):
    """Replace non-finite entries by 0 (reference integrator.cpp:126)."""
    return torch.where(torch.isfinite(x), x, 0.0)


def fresnel_conductor(eta_r, eta_i, cos_theta_i):
    """Fresnel reflectance of a conductor with the complex index of
    refraction ``eta_r + i eta_i`` (..., C), at the cosines (...,)
    (reference utils.h:168-184): ``(..., C)``."""
    cos_theta_i_2 = cos_theta_i * cos_theta_i
    sin_theta_i_2 = 1.0 - cos_theta_i_2
    sin_theta_i_4 = sin_theta_i_2 * sin_theta_i_2
    if eta_r.dim() > cos_theta_i.dim():
        cos_theta_i = cos_theta_i[..., None]
        cos_theta_i_2 = cos_theta_i_2[..., None]
        sin_theta_i_2 = sin_theta_i_2[..., None]
        sin_theta_i_4 = sin_theta_i_4[..., None]
    temp_1 = eta_r * eta_r - eta_i * eta_i - sin_theta_i_2
    a_2_pb_2 = safe_sqrt(temp_1 * temp_1 + 4.0 * ((eta_i * eta_r)
                                                  * (eta_i * eta_r)))
    a = safe_sqrt(0.5 * (a_2_pb_2 + temp_1))
    term_1 = a_2_pb_2 + cos_theta_i_2
    term_2 = 2.0 * cos_theta_i * a
    r_s = safe_div(term_1 - term_2, term_1 + term_2)
    term_3 = a_2_pb_2 * cos_theta_i_2 + sin_theta_i_4
    term_4 = term_2 * sin_theta_i_2
    r_p = r_s * safe_div(term_3 - term_4, term_3 + term_4)
    return 0.5 * (r_s + r_p)


def fresnel_dielectric(eta, cos_theta_i):
    """Fresnel reflectance of a dielectric of relative index ``eta`` at
    the cosines ``cos_theta_i`` (reference utils.h:186-215): ``(r,
    cos_theta_t, eta_it, eta_ti)``. ``cos_theta_t`` takes the opposite
    sign of ``cos_theta_i``, with sign(0) = +1."""
    outside = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(outside, eta, rcp_eta)
    eta_ti = torch.where(outside, rcp_eta, eta)
    cos_theta_t_sqr = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (
        eta_ti * eta_ti)
    cos_theta_i_abs = torch.abs(cos_theta_i)
    cos_theta_t_abs = safe_sqrt(cos_theta_t_sqr)
    index_matched = eta == 1.0
    special_case = index_matched | (cos_theta_i_abs == 0.0)
    a_s = safe_div(cos_theta_i_abs - eta_it * cos_theta_t_abs,
                   cos_theta_i_abs + eta_it * cos_theta_t_abs)
    a_p = safe_div(cos_theta_t_abs - eta_it * cos_theta_i_abs,
                   cos_theta_t_abs + eta_it * cos_theta_i_abs)
    r = 0.5 * (a_s * a_s + a_p * a_p)
    r = torch.where(special_case, torch.where(index_matched, 0.0, 1.0), r)
    cos_theta_t = -torch.where(outside, 1.0, -1.0) * cos_theta_t_abs
    return r, cos_theta_t, eta_it, eta_ti
