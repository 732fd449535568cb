"""The least time a kernel launch could take for its work, from the
launch's recorded inputs, against one H100's published peaks.

Counted work is what these inputs need, whatever kernel computes it: the
rays in and the hits or radiance out, each once, and ``TRI_BYTES`` a
triangle (a kernel's own tree, boxes, padding and staged tables are its
design, not its work). Operations would need the launch's data (which
(ray, triangle) tests any hierarchy must make), which the recorded shapes
do not give, so every bound here is set by bytes alone: the share it
gives is a lower bound of the share against a bound that also counted
operations.
"""

from __future__ import annotations

# Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# bytes a ray moves through a closest-hit kernel: origin and direction in,
# (t, id, u, v) out
RAY_BYTES = 24 + 16
# bytes of a triangle that any closest hit must read: p0, e1 and e2 in f32
TRI_BYTES = 36


def bound(nbytes: float, flops: float = 0.0):
    """``(seconds, "bytes" | "operations")``: the least time to move
    ``nbytes`` and do ``flops`` float32 operations, and which sets it."""
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = flops / F32_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _concrete(concrete, i):
    if concrete is None or i >= len(concrete):
        return None
    return concrete[i]


def k1_bytes(shapes, dtypes=None, concrete=None) -> int:
    """One K1 sweep launch (``psdr_jit_tpu_torch::k1_sweep(tri (9, F),
    box, ray_o (N, 3), ray_d, active (N,))``): ``RAY_BYTES`` and the
    active flag a ray, ``TRI_BYTES`` a triangle."""
    f = shapes[0][1]
    n = shapes[2][0]
    return n * (RAY_BYTES + 1) + TRI_BYTES * f


# K2's modes (ops/megakernel.py _K2_MODES) and its operator's argument
# positions: tri 0, ray_o 5, depth 12, mode 15
K2_SINGLE, K2_PAIR, K2_STASH = 0, 1, 2


def k2_bytes(shapes, dtypes=None, concrete=None) -> int:
    """One K2 launch (``psdr_jit_tpu_torch::k2``): a lane's ray in (two in
    pair mode), its active flag and lane id, its radiance out and, in
    stash mode, its ``1 + 2 depth`` hits (id, u, v) out; ``TRI_BYTES`` a
    triangle. Where the profiler did not record the mode and depth, the
    lane counts as single mode (a lower bound)."""
    f = shapes[0][1]
    n = shapes[5][0]
    mode = _concrete(concrete, 15)
    depth = _concrete(concrete, 12)
    per_lane = 24 + 1 + 4 + 12
    if mode == K2_PAIR:
        per_lane += 24
    elif mode == K2_STASH and isinstance(depth, int):
        per_lane += 12 * (1 + 2 * depth)
    return n * per_lane + TRI_BYTES * f


def share(trace, op_name: str, kernel_pattern, bytes_fn):
    """Percent of the bound over the kernel's device time, summed over the
    traced launches: ``op_name``'s recorded launches give the bytes,
    device kernels whose name matches ``kernel_pattern`` (a compiled
    regex) the time. None where either is missing."""
    nbytes = 0
    launches = 0
    for name, shapes, dtypes, concrete in trace.ops:
        if name == op_name and shapes:
            nbytes += bytes_fn(shapes, dtypes, concrete)
            launches += 1
    seconds = sum(s for name, s in trace.kernels
                  if kernel_pattern.search(name))
    if not launches or seconds <= 0.0:
        return None
    return 100.0 * bound(nbytes)[0] / seconds
