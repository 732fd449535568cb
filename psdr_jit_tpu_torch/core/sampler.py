"""Counter-based sampler (counterpart of ``psdr_jit_tpu/core/sampler.py``).

Draw ``cnt`` of lane ``lane`` is ``pcg4d(lane, cnt, seed, 0x9E3779B9)``, a
pure function of four 32-bit integers, so the port draws exactly the JAX
package's samples and any partition of the lanes reproduces the full
frame. Tensors hold the 32-bit values in int64 and mask after every
multiply and add: PyTorch has no add kernel for uint32 on the CPU, and the
low 32 bits of an int64 product are those of the true product even where
it overflows.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
SALT = 0x9E3779B9


def pcg4d(a, b, c, d):
    """PCG4D hash (Jarzynski & Olano 2020): four u32 in, four u32 out.

    Each argument is an int or an integer tensor of values in
    [0, 2^32); the results are broadcast int64 tensors in the same
    range."""
    device = next((x.device for x in (a, b, c, d)
                   if isinstance(x, torch.Tensor)), None)
    # ints are filled on the device: a tensor copied from the host would
    # make the host wait for the card at every draw
    a, b, c, d = torch.broadcast_tensors(
        *(x.to(torch.int64) if isinstance(x, torch.Tensor) else torch.full(
            (), x, dtype=torch.int64, device=device) for x in (a, b, c, d)))
    v0 = (a * 1664525 + 1013904223) & _MASK
    v1 = (b * 1664525 + 1013904223) & _MASK
    v2 = (c * 1664525 + 1013904223) & _MASK
    v3 = (d * 1664525 + 1013904223) & _MASK
    v0 = (v0 + v1 * v3) & _MASK
    v1 = (v1 + v2 * v0) & _MASK
    v2 = (v2 + v0 * v1) & _MASK
    v3 = (v3 + v1 * v2) & _MASK
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + v1 * v3) & _MASK
    v1 = (v1 + v2 * v0) & _MASK
    v2 = (v2 + v0 * v1) & _MASK
    v3 = (v3 + v1 * v2) & _MASK
    return v0, v1, v2, v3


def u32_to_unit_float(u):
    """u32 (in int64) -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


class Sampler:
    """Per-lane independent sample streams.

    ``lane``: int64 tensor of global sample indices (``pixel * spp + s``);
    ``seed``: int. The draw counter ``cnt`` is a Python int that every
    draw advances, in the JAX package's schedule.
    """

    def __init__(self, seed: int = 0, lane=None):
        self.seed_value = int(seed) & _MASK
        self.lane = (torch.zeros(1, dtype=torch.int64) if lane is None
                     else torch.as_tensor(lane).to(torch.int64) & _MASK)
        self.cnt = 0

    def seed(self, seed_values):
        """The reference's re-seeding (Sampler::seed, psdr.cpp:183): one
        independent stream for each entry of ``seed_values``."""
        self.lane = torch.as_tensor(seed_values).to(torch.int64) & _MASK
        self.cnt = 0
        return self

    # the JAX package's first spelling
    seed_ = seed

    def _draw(self, n_dims: int):
        outs = []
        while len(outs) < n_dims:
            v = pcg4d(self.lane, self.cnt, self.seed_value, SALT)
            outs.extend(v[: min(4, n_dims - len(outs))])
            self.cnt += 1
        return [u32_to_unit_float(u) for u in outs]

    def next_1d(self):
        return self._draw(1)[0]

    def next_2d(self):
        return torch.stack(self._draw(2), dim=-1)

    def next_nd(self, n: int):
        return torch.stack(self._draw(n), dim=-1)
