"""Sample warping functions (counterpart of ``psdr_jit_tpu/core/warp.py``,
reference include/psdr/core/warp.h)."""

from __future__ import annotations

import torch

from .types import INV_PI, PI
from .math import safe_div, safe_sqrt


def sincos_pio4(phi):
    """sin and cos for |phi| <= pi/4: Cephes' single-precision minimax
    polynomials (about 1 ulp), written out so every device and batch size
    runs the same arithmetic; K2 uses the same two polynomials."""
    z = phi * phi
    s = ((-1.9515295891e-4 * z + 8.3321608736e-3) * z
         - 1.6666654611e-1) * z * phi + phi
    c = ((2.443315711809948e-5 * z - 1.388731625493765e-3) * z
         + 4.166664568298827e-2) * z * z - 0.5 * z + 1.0
    return s, c


def square_to_uniform_disk_concentric(sample):
    """Shirley's concentric square-to-disk map (warp.h:16-50): (..., 2)."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    q13 = torch.abs(x) < torch.abs(y)
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    s, c = sincos_pio4(0.25 * PI * safe_div(rp, r))
    return torch.stack([r * torch.where(q13, s, c),
                        r * torch.where(q13, c, s)], dim=-1)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere through the concentric disk
    (warp.h:55-64): (..., 2) -> (..., 3)."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - p[..., 0] * p[..., 0] - p[..., 1] * p[..., 1])
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    """cos(theta) / pi (warp.h:68-74)."""
    return INV_PI * v[..., 2]


def square_to_uniform_triangle(sample):
    """Square to barycentrics, uniform by area (warp.h:79-83)."""
    t = safe_sqrt(1.0 - sample[..., 0])
    return torch.stack([1.0 - t, t * sample[..., 1]], dim=-1)

