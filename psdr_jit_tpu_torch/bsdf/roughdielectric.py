"""Rough dielectric: GGX reflection and refraction through an interface of
relative index ``eta`` (counterpart of ``psdr_jit_tpu/bsdf/roughdielectric.py``,
reference src/bsdf/roughdielectric.cpp).

The sample's density is the JAX package's: the visible-normal density of
the half vector times the lobe's probability and ``|dm/dwo|``, the same on
the sampling and the pdf side (the reference's two sides differ, JAX
``roughdielectric.py:120-125``). A sample reports the relative index it
crossed in ``eta`` (1 on reflection). The roughnesses are bitmaps, read
lane by lane by the scene's material table; ``eta`` is a value a slot."""

from __future__ import annotations

import torch

from ..core.math import (dot, fresnel_dielectric, mulsign, normalize,
                         safe_div)
from ..core.records import BSDFSample
from .bsdf import BSDF
from .ggx import GGXDistribution
from .microfacet import _bitmap, _orient


def _half_vector(wi, wo, reflect, eta):
    """The generalised half vector of ``wi`` and ``wo``, turned into the
    upper hemisphere."""
    m = normalize(wi + wo * torch.where(reflect, 1.0, eta)[..., None])
    return mulsign(m, m[..., 2:3])


def roughdielectric_eval(alpha_u, alpha_v, m_eta, two_side, wi, wo, active):
    """f(wi, wo) |cos(theta_o)| for local directions (..., 3), the same in
    the three channels: ``(..., 3)``; ``alpha_u``, ``alpha_v`` and the
    relative index ``m_eta`` (...,) a lane."""
    wi, wo = _orient(wi, wo, two_side)
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    active = active & (cos_i != 0.0)
    reflect = cos_i * cos_o > 0.0
    m_inv_eta = 1.0 / m_eta
    eta = torch.where(cos_i > 0.0, m_eta, m_inv_eta)
    inv_eta = torch.where(cos_i > 0.0, m_inv_eta, m_eta)
    m = _half_vector(wi, wo, reflect, eta)
    distr = GGXDistribution(alpha_u, alpha_v)
    d = distr.eval(m)
    wi_dot_m = dot(wi, m)
    f = fresnel_dielectric(m_eta, wi_dot_m)[0]
    g = distr.G(wi, wo, m)
    value_r = safe_div(f * d * g, 4.0 * torch.abs(cos_i))
    scale = inv_eta * inv_eta
    wo_dot_m = dot(wo, m)
    den = wi_dot_m + eta * wo_dot_m
    value_t = torch.abs(safe_div(
        scale * (1.0 - f) * d * g * eta * eta * wi_dot_m * wo_dot_m,
        cos_i * (den * den)))
    result = (torch.where(reflect & active, value_r, 0.0)
              + torch.where(~reflect & active, value_t, 0.0))
    return result[..., None].expand(result.shape + (3,))


def roughdielectric_sample(alpha_u, alpha_v, m_eta, two_side, wi, rnd3,
                           active) -> BSDFSample:
    """A visible normal from ``rnd3[..., :2]``, then reflection where
    ``rnd3[..., 2]`` falls under the Fresnel reflectance and refraction
    elsewhere; detached."""
    wi = wi.detach()
    wi = torch.cat([wi[..., :2], torch.where(
        two_side, torch.abs(wi[..., 2]), wi[..., 2])[..., None]], -1)
    cos_i = wi[..., 2]
    active = active & (cos_i != 0.0)
    distr = GGXDistribution(alpha_u.detach(), alpha_v.detach())
    m, pdf = distr.sample(mulsign(wi, cos_i[..., None]), rnd3)
    active = active & (pdf != 0.0)
    eta = m_eta.detach()
    wi_dot_m = dot(wi, m)
    f, cos_theta_t, eta_it, eta_ti = fresnel_dielectric(eta, wi_dot_m)
    selected_r = (rnd3[..., 2] <= f) & active
    pdf = pdf * torch.where(selected_r, f, 1.0 - f)
    bs_eta = torch.where(selected_r, 1.0, eta_it)
    wo_r = 2.0 * wi_dot_m[..., None] * m - wi
    wo_t = (m * (wi_dot_m * eta_ti + cos_theta_t)[..., None]
            - wi * eta_ti[..., None])
    wo = torch.where(selected_r[..., None], wo_r, wo_t)
    wo_dot_m = dot(wo, m)
    den = wi_dot_m + bs_eta * wo_dot_m
    dwh_dwo = torch.where(
        selected_r, safe_div(torch.ones_like(wo_dot_m), 4.0 * wo_dot_m),
        safe_div(bs_eta * bs_eta * wo_dot_m, den * den))
    pdf = pdf * torch.abs(dwh_dwo)
    return BSDFSample(wo=wo.detach(), pdf=pdf.detach(), eta=bs_eta.detach(),
                      is_valid=active)


def roughdielectric_pdf(alpha_u, alpha_v, m_eta, two_side, wi, wo, active):
    """Solid-angle density of ``wo``, the sample's exact density;
    detached."""
    wi, wo = _orient(wi.detach(), wo.detach(), two_side)
    m_eta = m_eta.detach()
    cos_i, cos_o = wi[..., 2], wo[..., 2]
    active = active & (cos_i != 0.0)
    reflect = cos_i * cos_o > 0.0
    eta = torch.where(cos_i > 0.0, m_eta, 1.0 / m_eta)
    m = _half_vector(wi, wo, reflect, eta)
    wi_dot_m, wo_dot_m = dot(wi, m), dot(wo, m)
    active = active & (wi_dot_m * cos_i > 0.0) & (wo_dot_m * cos_o > 0.0)
    den = wi_dot_m + eta * wo_dot_m
    dwh_dwo = torch.where(
        reflect, safe_div(torch.ones_like(wo_dot_m), 4.0 * wo_dot_m),
        safe_div(eta * eta * wo_dot_m, den * den))
    distr = GGXDistribution(alpha_u.detach(), alpha_v.detach())
    pwi = mulsign(wi, cos_i[..., None])
    prob = safe_div(distr.eval(m) * distr.smith_g1(pwi, m)
                    * torch.abs(wi_dot_m), pwi[..., 2])
    f = fresnel_dielectric(m_eta, wi_dot_m)[0]
    prob = prob * torch.where(reflect, f, 1.0 - f)
    return torch.where(active, prob * torch.abs(dwh_dwo), 0.0).detach()


class RoughDielectricBSDF(BSDF):
    """``RoughDielectricBSDF(alpha_u, alpha_v, int_ior, ext_ior, twoSide)``:
    GGX roughnesses (bitmaps or values; ``alpha_v`` defaults to
    ``alpha_u``) and the relative index ``eta_value = int_ior / ext_ior``."""

    _tensor_fields = ("alpha_u", "alpha_v", "eta_value")

    def __init__(self, alpha_u=0.1, alpha_v=None, int_ior=1.5, ext_ior=1.0,
                 twoSide: bool = False):
        self.alpha_u = _bitmap(alpha_u, 1)
        self.alpha_v = _bitmap(alpha_u if alpha_v is None else alpha_v, 1)
        self.eta_value = torch.tensor(float(int_ior) / float(ext_ior),
                                      dtype=torch.float32)
        self.twoSide = bool(twoSide)

    def anisotropic(self) -> bool:
        return True

    def to_string(self) -> str:
        return "RoughDielectricBSDF[]"
