"""Discrete sampling distribution (counterpart of
``psdr_jit_tpu/core/distribution.py``): construction and ``sample_reuse``
for tables of at most ``SEARCHSORTED_DENSE_MAX`` entries. Alias tables
(the JAX package's sampler above that size) and ``HyperCubeDistribution``
are not ported yet."""

from __future__ import annotations

import dataclasses

import torch

from .math import safe_div

# Above this many entries the JAX package samples from a Walker alias table
# (core/distribution.py with_alias), a different estimator; the port raises
# there until alias tables come with the secondary edges.
SEARCHSORTED_DENSE_MAX = 2048


@dataclasses.dataclass
class DiscreteDistribution:
    pmf: torch.Tensor  # (N,) unnormalized masses, detached
    cdf: torch.Tensor  # (N,) inclusive cumulative sum

    @staticmethod
    def init(pmf) -> "DiscreteDistribution":
        pmf = torch.as_tensor(pmf, dtype=torch.float32).detach()
        return DiscreteDistribution(pmf=pmf, cdf=torch.cumsum(pmf, 0))

    @property
    def size(self) -> int:
        return self.pmf.shape[0]

    @property
    def total(self):
        return self.cdf[-1]

    def sample_reuse(self, u):
        """(idx, pdf, u') for uniforms ``u``, reusing the random number
        (reference pmf.cpp:30-51). ``idx`` counts the CDF entries below
        ``u * total``, as the JAX package's dense compare does."""
        if self.size == 1:
            return torch.zeros(u.shape, dtype=torch.int32,
                               device=u.device), torch.ones_like(u), u
        if self.size > SEARCHSORTED_DENSE_MAX:
            raise NotImplementedError(
                f"{self.size}-entry table: the JAX package samples tables "
                f"above {SEARCHSORTED_DENSE_MAX} entries from an alias "
                "table, which is not ported yet (ROADMAP.md, port queue)")
        scaled = u * self.total
        idx = torch.clamp(torch.searchsorted(self.cdf, scaled),
                          max=self.size - 1)
        p = self.pmf[idx]
        lower = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)],
                            0.0)
        u_new = torch.clamp(safe_div(scaled - lower, p), 0.0, 1.0)
        return idx.to(torch.int32), p / self.total, u_new
