"""GGX microfacet distribution with visible-normal sampling (counterpart
of ``psdr_jit_tpu/bsdf/ggx.py``, reference src/bsdf/ggx.cpp). ``alpha_u``
and ``alpha_v`` may be per-lane tensors."""

from __future__ import annotations

import torch

from ..core import warp
from ..core.math import dot, lerp, normalize, safe_div, safe_sqrt
from ..core.types import PI, cos_phi, sin_phi


def _sq(x):
    return x * x


class GGXDistribution:
    def __init__(self, alpha_u, alpha_v=None):
        self.alpha_u = alpha_u
        self.alpha_v = alpha_u if alpha_v is None else alpha_v

    def eval(self, m):
        """The normal distribution D(m) (ggx.cpp:13-32)."""
        alpha_uv = self.alpha_u * self.alpha_v
        inner = (_sq(safe_div(m[..., 0], self.alpha_u))
                 + _sq(safe_div(m[..., 1], self.alpha_v)) + _sq(m[..., 2]))
        result = safe_div(1.0, PI * alpha_uv * _sq(inner))
        return torch.where(result * m[..., 2] > 1e-20, result, 0.0)

    def smith_g1(self, v, m):
        """Smith's masking term G1 (ggx.cpp:84-99)."""
        xy_alpha_2 = (_sq(self.alpha_u * v[..., 0])
                      + _sq(self.alpha_v * v[..., 1]))
        tan_theta_alpha_2 = safe_div(xy_alpha_2, _sq(v[..., 2]))
        result = 2.0 / (1.0 + safe_sqrt(1.0 + tan_theta_alpha_2))
        result = torch.where(xy_alpha_2 == 0.0, 1.0, result)
        return torch.where(dot(v, m) * v[..., 2] <= 0.0, 0.0, result)

    def G(self, wi, wo, m):
        return self.smith_g1(wi, m) * self.smith_g1(wo, m)

    def sample_visible_11(self, cos_theta_i, sample2):
        """A visible slope in the alpha = 1 frame (ggx.cpp:101-112)."""
        p = warp.square_to_uniform_disk_concentric(sample2)
        s = 0.5 * (1.0 + cos_theta_i)
        x = p[..., 0]
        y = lerp(safe_sqrt(1.0 - _sq(x)), p[..., 1], s)
        z = safe_sqrt(1.0 - (_sq(x) + _sq(y)))
        sin_theta_i = safe_sqrt(1.0 - _sq(cos_theta_i))
        norm_ = safe_div(1.0, sin_theta_i * y + cos_theta_i * z)
        return torch.stack([(cos_theta_i * y - sin_theta_i * z) * norm_,
                            x * norm_], -1)

    def sample(self, wi, sample3):
        """A visible normal from ``sample3[..., :2]``: ``(m, pdf)``, the pdf
        detached (ggx.cpp:35-80)."""
        wi_p = normalize(torch.stack([self.alpha_u * wi[..., 0],
                                      self.alpha_v * wi[..., 1],
                                      wi[..., 2]], -1))
        sp, cp = sin_phi(wi_p), cos_phi(wi_p)
        slope = self.sample_visible_11(wi_p[..., 2], sample3[..., :2])
        sx = (cp * slope[..., 0] - sp * slope[..., 1]) * self.alpha_u
        sy = (sp * slope[..., 0] + cp * slope[..., 1]) * self.alpha_v
        m = normalize(torch.stack([-sx, -sy, torch.ones_like(sx)], -1))
        pdf = (self.smith_g1(wi, m) * torch.abs(dot(wi, m)) * self.eval(m)
               * safe_div(1.0, torch.abs(wi[..., 2])))
        return m, pdf.detach()
