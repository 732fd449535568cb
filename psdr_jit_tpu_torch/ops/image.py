"""Image reductions (counterpart of ``psdr_jit_tpu/ops/image.py``)."""

from __future__ import annotations

import torch


def interior_average(values, n_pix: int, spp: int):
    """``(n_pix * spp, C)`` pixel-major samples -> ``(n_pix, C)`` means.

    A reshape and a sum in a fixed order over the samples: a pixel's bits
    then depend only on its own samples, whatever the chunk or crop."""
    v = values.reshape(n_pix, spp, values.shape[-1])
    acc = v[:, 0]
    for s in range(1, spp):
        acc = acc + v[:, s]
    return acc * (1.0 / spp)


class _SplatDerivativeOnly(torch.autograd.Function):
    @staticmethod
    def forward(values, idx, n_pix):
        return values.new_zeros((n_pix, values.shape[-1]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, idx, n_pix = inputs
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.n_pix = n_pix

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        ok = (idx >= 0) & (idx < ctx.n_pix)
        rows = ct[torch.where(ok, idx, 0).long()]
        return torch.where(ok[..., None], rows, 0.0), None, None

    @staticmethod
    def jvp(ctx, values_t, idx_t, n_pix_t):
        """Forward mode: the lanes' tangents scatter-added into their
        pixels (JAX ``splat_add_derivative_only``'s tangent rule)."""
        (idx,) = ctx.saved_tensors
        ok = (idx >= 0) & (idx < ctx.n_pix)
        out = values_t.new_zeros((ctx.n_pix, values_t.shape[-1]))
        return out.index_add_(0, torch.where(ok, idx, 0).long(),
                              torch.where(ok[..., None], values_t, 0.0))


def splat_add_derivative_only(values, idx, n_pix: int):
    """Splat of a derivative-only estimator (the boundary terms): ``values``
    ``(N, 3)`` at pixel ids ``idx`` ``(N,)`` (-1 = dropped) into an
    ``(n_pix, 3)`` image whose value is zero and whose derivative is the
    splat's (JAX ``splat_add_derivative_only``). The forward scatters
    nothing; forward mode scatter-adds the values' tangents (an
    ``index_add_``, whose float atomics on the card vary in their last
    bits from run to run); the backward gathers the image cotangent
    ``ct[idx]`` in float32 (the JAX package's default bf16 table,
    ``rows_bf16``, is a TPU bandwidth measure and is not ported)."""
    return _SplatDerivativeOnly.apply(values, idx, n_pix)
