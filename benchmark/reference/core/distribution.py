"""Sampling distributions (counterpart of
``psdr_jit_tpu/core/distribution.py``).

* :class:`DiscreteDistribution`: PMF/CDF sampling with sample reuse
  (reference ``src/core/pmf.cpp``) by a search of the CDF, or, for a table
  of more than ``SEARCHSORTED_DENSE_MAX`` entries with a Walker alias table
  attached (:meth:`DiscreteDistribution.with_alias`, built on the host
  from concrete masses as the JAX package builds it), by one row gather
  and a coin.
* :class:`HyperCubeDistribution`: a regular-grid PMF over the unit cube
  (reference ``src/core/cube_distrb.cpp``), the secondary-edge guiding
  table.

Sampling tables are detached, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .math import safe_div

# Above this many entries a table built from concrete masses (the scene
# compile's edge table, the guiding grid) samples from Walker alias rows,
# as in the JAX package.
SEARCHSORTED_DENSE_MAX = 2048


def build_alias_rows(pmf) -> torch.Tensor:
    """Walker alias table of the masses ``pmf`` as one ``(N, 4)`` float32
    tensor on the CPU, columns ``(prob, alias index, pmf self, pmf alias)``:
    the classic two-queue build in float64 numpy, step for step the JAX
    package's ``_build_alias_rows``, so the rows are its bits. An all-zero
    table gives ``prob = 1`` and each entry its own alias."""
    p = np.asarray(torch.as_tensor(pmf).detach().cpu(),
                   np.float64).reshape(-1)
    n = p.shape[0]
    # the alias index rides as a float32 column: exact below 2^24
    if n >= (1 << 24):
        raise ValueError(f"{n}-entry alias table: float32 alias indices are "
                         "exact only below 2^24 entries")
    total = p.sum()
    if not (total > 0.0) or n == 0:
        rows = np.zeros((max(n, 1), 4), np.float32)
        rows[:, 0] = 1.0
        rows[:, 1] = np.arange(max(n, 1))
        return torch.from_numpy(rows)
    scaled = p * (n / total)
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in small + large:
        prob[i] = 1.0
    rows = np.empty((n, 4), np.float32)
    rows[:, 0] = prob
    rows[:, 1] = alias
    rows[:, 2] = p
    rows[:, 3] = p[alias]
    return torch.from_numpy(rows)


@dataclasses.dataclass
class DiscreteDistribution:
    pmf: torch.Tensor  # (N,) unnormalized masses, detached
    cdf: torch.Tensor  # (N,) inclusive cumulative sum
    # (N, 4) Walker alias rows (build_alias_rows), or None: CDF search
    alias_rows: Optional[torch.Tensor] = None

    @staticmethod
    def init(pmf) -> "DiscreteDistribution":
        pmf = torch.as_tensor(pmf, dtype=torch.float32).detach()
        return DiscreteDistribution(pmf=pmf, cdf=torch.cumsum(pmf, 0))

    def with_alias(self) -> "DiscreteDistribution":
        """This table with its alias rows attached, on the table's device,
        where it has more than ``SEARCHSORTED_DENSE_MAX`` entries (reads the
        masses back to the host)."""
        if self.size <= SEARCHSORTED_DENSE_MAX:
            return self
        return DiscreteDistribution(
            pmf=self.pmf, cdf=self.cdf,
            alias_rows=build_alias_rows(self.pmf).to(self.pmf.device))

    @property
    def needs_coin(self) -> bool:
        """Whether sampling takes an extra independent uniform, the alias
        coin: callers draw one iff this is True."""
        return self.alias_rows is not None

    @property
    def size(self) -> int:
        return self.pmf.shape[0]

    @property
    def total(self):
        return self.cdf[-1]

    # the reference's accessors (psdr.cpp:187-192)
    @property
    def sum(self):
        return self.total

    def pmf_normalized(self):
        """The normalized masses (the reference's ``pmf()``)."""
        return self.pmf / self.total

    def _sample_alias(self, u, u_coin=None):
        """``(idx, pmf[idx], u')`` by one row gather. With ``u_coin`` the
        coin is exact and ``u'`` the fraction of ``u * N`` in its cell;
        without it, that fraction serves as the coin and is rescaled."""
        n = self.size
        un = u * n
        j = torch.clamp(un.to(torch.int32), 0, n - 1)
        f = un - j.to(torch.float32)
        rows = self.alias_rows.index_select(0, j.reshape(-1).long()).reshape(
            j.shape + (4,))
        prob, alias, p_self, p_other = rows.unbind(-1)
        alias = alias.to(torch.int32)
        if u_coin is not None:
            take_self = u_coin < prob
            idx = torch.where(take_self, j, alias)
            p = torch.where(take_self, p_self, p_other)
            return idx, p, torch.clamp(f, 0.0, 1.0)
        take_self = f < prob
        idx = torch.where(take_self, j, alias)
        p = torch.where(take_self, p_self, p_other)
        u_new = torch.clamp(torch.where(
            take_self, safe_div(f, prob),
            safe_div(f - prob, torch.clamp(1.0 - prob, min=1e-12))), 0.0, 1.0)
        return idx, p, u_new

    def _search(self, u):
        """``(idx, pmf[idx], scaled, cdf[idx - 1])``: ``idx`` counts the CDF
        entries below ``u * total`` (clamped to the last entry), the index
        of the JAX package's dense compare and of its binary search."""
        scaled = u * self.total
        idx = torch.clamp(torch.searchsorted(self.cdf, scaled),
                          max=self.size - 1)
        lower = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)],
                            0.0)
        return idx, self.pmf[idx], scaled, lower

    def sample(self, u, u_coin=None):
        """``(idx, normalized pdf)`` for uniforms ``u``; ``u_coin`` is the
        alias coin where :attr:`needs_coin`."""
        if self.size == 1:
            # pmf.cpp:19-22: pdf 1 even for a zero mass
            return (torch.zeros(u.shape, dtype=torch.int32, device=u.device),
                    torch.ones_like(u))
        if self.alias_rows is not None:
            idx, p, _ = self._sample_alias(u, u_coin)
            return idx, p / self.total
        idx, p, _, _ = self._search(u)
        return idx.to(torch.int32), p / self.total

    def sample_reuse(self, u, u_coin=None):
        """``(idx, pdf, u')`` for uniforms ``u``, reusing the random number
        (reference pmf.cpp:30-51); ``u_coin`` as in :meth:`sample`."""
        if self.size == 1:
            return torch.zeros(u.shape, dtype=torch.int32,
                               device=u.device), torch.ones_like(u), u
        if self.alias_rows is not None:
            idx, p, u_new = self._sample_alias(u, u_coin)
            return idx, p / self.total, u_new
        idx, p, scaled, lower = self._search(u)
        u_new = torch.clamp(safe_div(scaled - lower, p), 0.0, 1.0)
        return idx.to(torch.int32), p / self.total, u_new


@dataclasses.dataclass
class HyperCubeDistribution:
    """Regular-grid PMF over [0, 1]^d (cube_distrb.cpp:10-64): row-major
    cells over ``res``, the secondary-edge guiding table."""

    res: tuple                            # d ints
    distrb: Optional[DiscreteDistribution] = None

    @staticmethod
    def init(res, mass) -> "HyperCubeDistribution":
        res = tuple(int(r) for r in res)
        n = 1
        for r in res:
            n *= r
        mass = torch.as_tensor(mass, dtype=torch.float32).reshape(n)
        return HyperCubeDistribution(res=res,
                                     distrb=DiscreteDistribution.init(mass))

    @property
    def num_cells(self) -> int:
        n = 1
        for r in self.res:
            n *= r
        return n

    def with_alias(self) -> "HyperCubeDistribution":
        """Alias rows for the cell table (host build, concrete masses)."""
        return HyperCubeDistribution(res=self.res,
                                     distrb=self.distrb.with_alias())

    def cell_coords(self, idx):
        """Flat cell index -> integer coordinates (..., d), row-major."""
        coords = []
        for r in reversed(self.res):
            coords.append(idx % r)
            idx = idx // r
        return torch.stack(list(reversed(coords)), dim=-1)

    @property
    def needs_coin(self) -> bool:
        return self.distrb is not None and self.distrb.needs_coin

    def _res_f32(self, like):
        out = torch.empty(len(self.res), dtype=torch.float32,
                          device=like.device)
        for i, r in enumerate(self.res):
            out[i] = r
        return out

    def sample_reuse(self, samples, u_coin=None):
        """Warp (..., d) uniforms toward heavy cells: ``(warped, pdf)``.
        The last coordinate picks the cell and is reused inside it
        (cube_distrb.cpp:43-49); ``u_coin`` is the alias coin."""
        d = len(self.res)
        idx, p_cell, u_last = self.distrb.sample_reuse(samples[..., d - 1],
                                                       u_coin)
        coords = self.cell_coords(idx).to(torch.float32)
        unit = 1.0 / self._res_f32(samples)
        inner = torch.cat([samples[..., :d - 1], u_last[..., None]], dim=-1)
        warped = (coords + inner) * unit
        return warped, p_cell * float(self.num_cells)

    def pdf(self, p):
        """Density at points ``p`` (..., d) of [0, 1]^d
        (cube_distrb.cpp:53-64); 0 outside."""
        res_i = torch.tensor(self.res, dtype=torch.int32, device=p.device)
        ip = torch.floor(p * self._res_f32(p)).to(torch.int32)
        valid = ((ip >= 0) & (ip < res_i)).all(-1)
        ip = torch.minimum(torch.clamp(ip, min=0), res_i - 1)
        flat = ip[..., 0]
        for i in range(1, len(self.res)):
            flat = flat * self.res[i] + ip[..., i]
        dens = safe_div(self.distrb.pmf[flat.long()], self.distrb.total) * \
            float(self.num_cells)
        return torch.where(valid, dens, 0.0)
