"""Normal mapping: a wrapper that perturbs a nested BSDF's shading frame by
a normal map, with two-facet shadowing (counterpart of
``psdr_jit_tpu/bsdf/normalmap.py``, reference src/bsdf/normalmap.cpp,
after Schüssler et al. 2017).

The map's normal ``wp`` (in the hit's shading frame) and the hit's
``dp_du`` give the perturbed frame; meshes without texture coordinates
(``dp_du`` = 0) take an orthonormal basis around ``wp``. The nested BSDF
is evaluated twice: the direct path i -> p -> o, and the path that first
reflects off the tangent facet, i -> t -> p -> o. The scene's dispatch
(``bsdf/bsdf.py``) runs these functions once for all of a type's lanes,
each lane with its own map and its own nested BSDF, which the dispatch
evaluates by type again (``Materials.nested``)."""

from __future__ import annotations

import copy

import torch

from ..core.math import cross, dot, normalize, safe_div, safe_sqrt
from ..core.records import BSDFSample
from ..core.types import Frame
from .bsdf import BSDF
from .microfacet import _bitmap, _orient


def _wt(wp):
    """The tangent facet's direction (normalmap.cpp:20-23)."""
    return normalize(torch.stack([-wp[..., 0], -wp[..., 1],
                                  torch.zeros_like(wp[..., 0])], -1))


def _pdot(a, b):
    return torch.clamp(dot(a, b), min=0.0)


def _sin_theta(v):
    return safe_sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _g1(wp, w):
    """Two-facet shadowing (normalmap.cpp:30-36)."""
    num = torch.clamp(w[..., 2], min=0.0) * torch.clamp(wp[..., 2], min=0.0)
    den = _pdot(w, wp) + _pdot(w, _wt(wp)) * _sin_theta(wp)
    return torch.clamp(safe_div(num, den), max=1.0)


def _lambda_p(wp, wi):
    """The perturbed facet's share of the projected area
    (normalmap.cpp:39-43)."""
    i_dot_p = _pdot(wp, wi)
    return safe_div(i_dot_p, i_dot_p + _pdot(_wt(wp), wi) * _sin_theta(wp))


def perturbed_frame(wp, dp_du) -> Frame:
    """``Frame(n = wp, s from dp_du)`` (frame.h:42-45), or an orthonormal
    basis around ``wp`` where ``dp_du``'s part orthogonal to ``wp``
    vanishes."""
    proj = dp_du - wp * dot(wp, dp_du)[..., None]
    ok = (dot(proj, proj) > 1e-12)[..., None]
    s = torch.where(ok, normalize(proj), Frame.from_normal(wp).s)
    t = normalize(cross(wp, s))
    return Frame(s=normalize(cross(t, wp)), t=t, n=wp)


def _setup(nmap, its):
    """``(wp, the perturbed frame)`` from the lanes' map values ``nmap``
    (..., 3) in [0, 1]."""
    wp = normalize(nmap * 2.0 - 1.0)
    return wp, perturbed_frame(wp, its.dp_du)


def _with_wi(its, wi):
    """``its`` with the incident direction ``wi``."""
    its = copy.copy(its)
    its.wi = wi
    return its


def _reflected(wi, wt):
    return normalize(wi - 2.0 * dot(wi, wt)[..., None] * wt)


def normalmap_eval(nmap, nested, inner, two_side, its, wo, active):
    """f(wi, wo) cos(theta_o): ``(..., 3)``. ``nmap`` (..., 3) the map at
    each lane's hit, ``nested`` the nested BSDFs' ``Materials``, ``inner``
    (...,) each lane's slot among them."""
    from .bsdf import eval_dispatch

    wi, wo = _orient(its.wi, wo, two_side)
    active = active & (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    wp, frame = _setup(nmap, its)
    p_its = _with_wi(its, frame.to_local(wi))
    p_wo = frame.to_local(wo)
    shadowing = _g1(wp, wo)
    lam = _lambda_p(wp, wi)
    wt = _wt(wp)
    value = eval_dispatch(nested, inner, p_its, p_wo, active) * (
        lam * shadowing)[..., None]
    r_its = _with_wi(its, frame.to_local(_reflected(wi, wt)))
    extra = eval_dispatch(nested, inner, r_its, p_wo, active) * (
        (1.0 - lam) * shadowing)[..., None]
    value = value + torch.where((dot(wi, wt) > 0.0)[..., None], extra, 0.0)
    return torch.where(active[..., None], value, 0.0)


def normalmap_sample(nmap, nested, inner, two_side, its, rnd3,
                     active) -> BSDFSample:
    """The nested BSDF's sample in the perturbed frame, from the direct
    incident direction or, where ``rnd3[..., 2] >= lambda_p``, from its
    reflection off the tangent facet; the density is the mixture of the
    two. Detached."""
    from .bsdf import pdf_dispatch, sample_dispatch

    nmap, wi = nmap.detach(), its.wi.detach()
    wi = torch.cat([wi[..., :2], torch.where(
        two_side, torch.abs(wi[..., 2]), wi[..., 2])[..., None]], -1)
    wp, frame = _setup(nmap, its)
    frame = Frame(frame.s.detach(), frame.t.detach(), frame.n.detach())
    lam = _lambda_p(wp, wi)
    itpo = rnd3[..., 2] >= lam
    p_its = _with_wi(its, frame.to_local(wi))
    r_its = _with_wi(its, frame.to_local(_reflected(wi, _wt(wp))))
    # one nested sample a lane, from the incident direction its branch
    # picked (the JAX package samples both branches under exclusive masks)
    s_its = _with_wi(its, torch.where(itpo[..., None], r_its.wi, p_its.wi))
    bs = sample_dispatch(nested, inner, s_its, rnd3, active)
    pdf = (lam * pdf_dispatch(nested, inner, p_its, bs.wo, active)
           + (1.0 - lam) * pdf_dispatch(nested, inner, r_its, bs.wo, active))
    return BSDFSample(wo=frame.to_world(bs.wo).detach(), pdf=pdf.detach(),
                      eta=bs.eta, is_valid=active & bs.is_valid)


def normalmap_pdf(nmap, nested, inner, two_side, its, wo, active):
    """The mixture density of :func:`normalmap_sample`; detached."""
    from .bsdf import pdf_dispatch

    wi, wo = _orient(its.wi.detach(), wo.detach(), two_side)
    active = active & (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    wp, frame = _setup(nmap.detach(), its)
    frame = Frame(frame.s.detach(), frame.t.detach(), frame.n.detach())
    p_wo = frame.to_local(wo)
    lam = _lambda_p(wp, wi)
    p_its = _with_wi(its, frame.to_local(wi))
    r_its = _with_wi(its, frame.to_local(_reflected(wi, _wt(wp))))
    value = (lam * pdf_dispatch(nested, inner, p_its, p_wo, active)
             + (1.0 - lam) * pdf_dispatch(nested, inner, r_its, p_wo,
                                          active))
    return torch.where(active, value, 0.0).detach()


class NormalMapBSDF(BSDF):
    """``NormalMapBSDF(nmap, bsdf, twoSide)``: an RGB normal map (a
    :class:`Bitmap` or an array, tangent-space normals scaled to [0, 1])
    over the nested BSDF ``bsdf``."""

    _tensor_fields = ("nmap", "bsdf")

    def __init__(self, nmap, bsdf, twoSide: bool = False):
        self.nmap = _bitmap(nmap, 3)
        self.bsdf = bsdf
        self.twoSide = bool(twoSide)

    def to_string(self) -> str:
        return f"NormalMapBSDF[{self.bsdf!r}]"
