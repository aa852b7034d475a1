"""Bounded-memory streaming quantiles (exact warm-up + uniform reservoir).

The streaming result backend (simulator.SimResult with ``records=None``)
folds each job record away at completion, so tail statistics like p99
flow time cannot be answered by sorting records after the fact.  This
module provides :class:`StreamingQuantile`: fixed-memory (one
``exact_cap``-sized buffer) per tracked quantile, fed one observation at
a time.

Approximation contract (tests/test_quantile.py):

* **Exact below the cap** — the first ``exact_cap`` (default 8192)
  observations are kept in a sorted buffer and ``value()`` answers with
  the same linear-interpolation formula as
  ``SimResult.flow_percentile`` — *bit-identical* to the materialized
  percentile, so runs that fit the buffer lose nothing.
* **Reservoir beyond the cap** — Vitter's Algorithm R keeps a uniform
  sample of everything seen; ``value()`` is the sample percentile.
  Unlike marker estimators (P²), a uniform reservoir stays unbiased on
  *trending* streams — exactly what simulator flow times are under
  queue ramp-up — with only sampling noise: the sample rank of the true
  quantile has std ``sqrt(cap * q(1-q))``, about ±0.16 percentile
  points at p99 with the default cap.  The tested bound is **within
  10 % relative error of the exact percentile** on heavy-tailed
  lognormal data at 50k+ observations (typically ~1 %); gate
  thresholds built on these estimates should leave margin accordingly.

The reservoir's RNG is seeded per estimator, so a fixed event stream
yields a reproducible estimate (the serve benchmark gates depend on
that).
"""
from __future__ import annotations

import bisect
from typing import List

import numpy as np

EXACT_CAP_DEFAULT = 8192
_BLOCK = 4096  # uniforms drawn per RNG call (amortizes Generator overhead)


class StreamingQuantile:
    """One tracked quantile ``q`` (percent, e.g. 99.0) over a stream."""

    __slots__ = ("q", "exact_cap", "n", "_buf", "_sorted", "_rng",
                 "_u", "_ui")

    def __init__(
        self, q: float, exact_cap: int = EXACT_CAP_DEFAULT, seed: int = 0
    ):
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"quantile must be in [0, 100], got {q}")
        if exact_cap < 1:
            raise ValueError("exact_cap must be >= 1")
        self.q = float(q)
        self.exact_cap = exact_cap
        self.n = 0
        self._buf: List[float] = []  # sorted while exact, arbitrary after
        self._sorted = True
        self._rng = np.random.default_rng([seed, int(self.q * 1000)])
        self._u = np.empty(0)
        self._ui = 0

    def _percentile(self, flows: List[float]) -> float:
        """flow_percentile's formula verbatim (bit-identity contract)."""
        if not flows:
            return 0.0
        if len(flows) == 1:
            return flows[0]
        pos = (self.q / 100.0) * (len(flows) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(flows) - 1)
        return flows[lo] + (pos - lo) * (flows[hi] - flows[lo])

    def _uniform(self) -> float:
        if self._ui >= len(self._u):
            self._u = self._rng.random(_BLOCK)
            self._ui = 0
        u = self._u[self._ui]
        self._ui += 1
        return u

    def add(self, x: float) -> None:
        self.n += 1
        if self.n <= self.exact_cap:
            bisect.insort(self._buf, x)
            return
        # Algorithm R: every observation lands in the reservoir with
        # probability cap/n — a uniform sample of the whole stream.
        self._sorted = False
        j = int(self._uniform() * self.n)
        if j < self.exact_cap:
            self._buf[j] = x

    def value(self) -> float:
        """Current estimate: exact while n <= exact_cap, reservoir
        percentile beyond."""
        if self._sorted:
            return self._percentile(self._buf)
        return self._percentile(sorted(self._buf))

    @property
    def exact(self) -> bool:
        """True while the estimate is still the exact percentile."""
        return self.n <= self.exact_cap
