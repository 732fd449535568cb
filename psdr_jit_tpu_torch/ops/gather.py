"""Row gathers of differentiable tables (counterpart of
``psdr_jit_tpu/ops/gather.py`` ``gather_rows``).

The JAX package gathers rows through one-hot matmuls, a TPU measure that
is not ported: here a gather is ``index_select``. Its backward is the sum
of each lane's cotangent into its row. autograd's ``index_add_`` makes it
one float atomic an element. When millions of lanes share a few rows, as
the secondary-edge pass's 2^22 lanes share the Cornell box's 80 edges and
32 triangles, those atomics queue on the same addresses; a histogram
(``torch.bincount`` with weights) first sums a block's lanes in shared
memory. Tables of at most ``BINCOUNT_MAX_ROWS`` rows take the histogram,
larger ones ``index_add_``.
"""

from __future__ import annotations

import torch

# Rows up to which the backward sums by histogram. On an H100 (700 W) a
# (2^22, 3) cotangent of uniform row ids took 1.938 / 1.924 / 0.680 /
# 0.489 / 0.261 / 0.143 ms through index_add_ and 0.325 / 0.356 / 0.374 /
# 0.364 / 0.374 / 0.474 ms through bincount into 32 / 80 / 256 / 512 /
# 1,024 / 2,048 rows (scripts/torch_gather_sqrt.py; PERF.md).
BINCOUNT_MAX_ROWS = 512


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(table, idx):
        return table.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows, cols = ctx.rows, g.shape[1]
        if rows <= BINCOUNT_MAX_ROWS:
            flat = (idx[:, None] * cols + torch.arange(
                cols, device=idx.device)).reshape(-1)
            out = torch.bincount(flat, g.reshape(-1), minlength=rows * cols)
            return out.reshape(rows, cols).to(g.dtype), None
        return g.new_zeros((rows, cols)).index_add_(0, idx, g), None

    @staticmethod
    def jvp(ctx, table_t, idx_t):
        """Forward mode: the tangent's rows."""
        (idx,) = ctx.saved_tensors
        return table_t.index_select(0, idx)


def gather_rows(table, idx):
    """Rows of ``table`` (R, C) at ``idx`` (any shape, integer):
    ``idx.shape + (C,)``, differentiable in ``table``. An int64 ``idx`` is
    used as it is; any other is cast on each call, so a caller gathering
    several tables casts once first."""
    flat = idx.reshape(-1).long()
    if table.requires_grad and torch.is_grad_enabled():
        rows = _GatherRows.apply(table, flat)
    else:
        rows = table.index_select(0, flat)
    return rows.reshape(idx.shape + table.shape[1:])
