"""Scenario fleets: batched Monte-Carlo robustness sweeps.

The paper's competitive-ratio claim is a statement about *distributions*
of adversarial conditions; a single deterministic benchmark row cannot
exercise it.  ``run_fleet`` generates N seeded variants of a base
:class:`~repro.core.scenario.Scenario` (straggler / elastic / fault /
arrival-jitter perturbation samplers layered on the scenario event stream)
and runs them through a shared-state runner instead of N sequential
``simulate()`` calls:

* **Shared caches.**  Every variant's policy is built with
  ``Policy.fleet_shared`` pointing at one :class:`FleetShared`, so all
  variants share one ``PlacementCache`` per refine flag (entries are
  pure functions of ``(cluster spec, config, capacity shape, classes,
  speeds)`` — cache purity is exactly what the in-run memoization
  already relies on, property-tested cached == uncached) and one pool
  of clean ``AlphaCache`` bounds.  Degraded alpha bounds depend on live
  per-variant cluster state and stay per policy instance, as does every
  queue / virtual-machine / allocation structure.

* **Batched cold refine.**  With ``prewarm=True`` and a refine-mapping
  policy, a cheap greedy *scout* run of the base scenario first records
  the realistic ``(config, shape)`` working set (the ~600 cold
  placements that floor A-SRPT throughput), then
  ``PlacementCache.warm`` computes all of them up front — the refine
  stage grouped across shapes and variants into one array program per
  ``(config, slot-count, bandwidth-pattern)`` group instead of one
  three-seed program per miss.  Warmed entries are bit-identical to
  what on-demand misses would compute, so fleet schedules equal the
  sequential path's byte for byte (pinned on all 10 golden scenarios).

Determinism: variant i draws from ``numpy.random.default_rng([seed,
i])``, so the whole :class:`FleetResult` — per-variant schedule sha256s
included — is a pure function of ``(base, policy factory,
perturbations, n_variants, seed)``.
"""
from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .job import ClusterSpec
from .scenario import Perturbation, Scenario, perturb_scenario
from .simulator import AlphaCache, Policy, simulate


class FleetShared:
    """Cross-variant cache pool handed to ``Policy.fleet_shared``.

    Hands out one :class:`~repro.core.heavy_edge.PlacementCache` per
    refine flag (shared instance: DenseGraph pool, seed store, and LRU
    amortize across the fleet) and per-policy ``AlphaCache`` instances
    whose *clean* bound dicts alias one shared pool.  Degraded bounds
    share too: the memo is
    content-addressed by the straggler multiset + job config rather
    than the live cluster's ``(epoch, speed_version)`` counters — those
    only gate each instance's private scan — so variants hitting the
    same degradation state reuse each other's folds.  A spec other than
    the fleet's gets private caches (no sharing).
    """

    def __init__(self, cluster_spec: ClusterSpec):
        self.spec = cluster_spec
        self._pcaches: Dict[bool, object] = {}
        self._alpha_clean: Dict[int, Tuple[float, float]] = {}
        self._alpha_class: Dict[Tuple[int, int], float] = {}
        self._alpha_deg: Dict[tuple, Tuple[float, float]] = {}

    def placement_cache(self, cluster_spec: ClusterSpec, refine=False):
        from .heavy_edge import PlacementCache

        if cluster_spec != self.spec:
            return PlacementCache(cluster_spec, refine=refine)
        key = bool(refine)
        pc = self._pcaches.get(key)
        if pc is None:
            pc = self._pcaches[key] = PlacementCache(
                cluster_spec, refine=refine
            )
        return pc

    def alpha_cache(self, cluster_spec: ClusterSpec) -> AlphaCache:
        ac = AlphaCache(cluster_spec)
        if cluster_spec == self.spec:
            ac._cache = self._alpha_clean
            ac._class_amax = self._alpha_class
            ac._deg_cache = self._alpha_deg
        return ac


class _ScoutShared:
    """Provider for the prewarm scout: shared alpha pool (warms it for
    the fleet), throwaway greedy placement cache with a miss log."""

    def __init__(self, shared: FleetShared, log: list):
        self._shared = shared
        self._log = log

    def alpha_cache(self, cluster_spec):
        return self._shared.alpha_cache(cluster_spec)

    def placement_cache(self, cluster_spec, refine=False):
        from .heavy_edge import PlacementCache

        return PlacementCache(cluster_spec, refine=refine,
                              key_log=self._log)


def fleet_variants(
    base: Scenario,
    perturbations: Sequence[Perturbation],
    n_variants: int,
    seed: int = 0,
) -> Iterator[Tuple[int, Scenario]]:
    """Yield ``(index, variant)`` pairs; variant i is drawn from its own
    ``default_rng([seed, i])``, so any subset replays identically."""
    for i in range(n_variants):
        rng = np.random.default_rng([seed, i])
        yield i, perturb_scenario(
            base, perturbations, rng,
            name=f"{base.name or 'fleet'}#v{i}",
        )


@dataclass(frozen=True)
class VariantResult:
    """One variant's schedule summary (digest = ``schedule_digest()``)."""

    index: int
    name: str
    digest: str
    total_flow_time: float
    makespan: float
    mean_jct: float
    n_migrations: int
    n_events: int
    wall_s: float


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default), on
    plain floats so the digest is numpy-version independent."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = (n - 1) * (q / 100.0)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return sorted_vals[lo]
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _dist(vals: List[float]) -> Dict[str, float]:
    s = sorted(vals)
    return {
        "mean": math.fsum(s) / len(s),
        "p50": _percentile(s, 50.0),
        "p95": _percentile(s, 95.0),
        "min": s[0],
        "max": s[-1],
    }


@dataclass(frozen=True)
class FleetResult:
    """Distribution stats + per-variant rows for one fleet run."""

    variants: Tuple[VariantResult, ...]
    seed: int
    stats: Dict[str, Dict[str, float]]
    prewarm: Dict[str, float]
    wall_s: float

    def digest(self) -> str:
        """Bit-identity fingerprint of the whole fleet: per-variant
        schedule digests and exact metric floats, in variant order."""
        h = hashlib.sha256()
        for v in self.variants:
            h.update(
                f"{v.index}:{v.digest}:{v.total_flow_time!r}:"
                f"{v.makespan!r}:{v.n_migrations}\n".encode()
            )
        return h.hexdigest()

    def to_dict(self) -> dict:
        return {
            "schema": 1,
            "bench": "sched_scale_fleet",
            "n_variants": len(self.variants),
            "seed": self.seed,
            "stats": self.stats,
            "digests": [v.digest for v in self.variants],
            "fleet_digest": self.digest(),
            "prewarm": self.prewarm,
            "wall_s": self.wall_s,
        }


def run_fleet(
    base: Scenario,
    policy_factory: Callable[[], Policy],
    perturbations: Sequence[Perturbation],
    n_variants: int,
    seed: int = 0,
    share: bool = True,
    prewarm: bool = True,
    validate: bool = False,
    progress: Optional[Callable[[int, VariantResult], None]] = None,
) -> FleetResult:
    """Run ``n_variants`` seeded perturbations of ``base`` and fold the
    results into a :class:`FleetResult`.

    ``share=False, prewarm=False`` is the sequential control arm: fresh
    policy *and* fresh caches per variant, exactly N independent
    ``simulate()`` calls (what the ``--fleet-ab`` benchmark compares
    against).  Schedules are identical either way — sharing only moves
    cache warmup, never results.

    ``policy_factory`` must return a fresh policy per call (per-run
    queue/predictor state is never shared; only caches are).
    """
    base = base.materialize()
    # DET003-allowlisted ([tool.detlint] run_fleet): every perf_counter
    # in this function (fleet total, prewarm, per-variant) feeds a
    # wall_s field on FleetResult/VariantResult/prewarm_stats — timing
    # telemetry for the --fleet-ab speedup table.  Variant schedules and
    # digests are produced by simulate() before the subtraction, so
    # wall-clock jitter can never reach them.
    t_fleet = time.perf_counter()
    shared = FleetShared(base.cluster) if share else None
    prewarm_stats: Dict[str, float] = {}
    if share and prewarm:
        probe = policy_factory()
        if getattr(probe, "refine_mapping", False) and getattr(
            probe, "placement_cache", True
        ):
            # Scout: the same policy config with refine off explores
            # nearly the same (config, shape) working set at a fraction
            # of the cost; its misses become the warm work-list.  Warmed
            # entries are pure functions of their key, so a mispredicted
            # key is wasted work, never a wrong schedule.
            t0 = time.perf_counter()
            probe.refine_mapping = False
            log: list = []
            probe.fleet_shared = _ScoutShared(shared, log)
            simulate(base, probe, validate=False)
            warmed, groups = shared.placement_cache(
                base.cluster, refine=True
            ).warm(log)
            prewarm_stats = {
                "keys": float(len(log)),
                "warmed": float(warmed),
                "refine_batches": float(groups),
                "wall_s": time.perf_counter() - t0,
            }
    rows: List[VariantResult] = []
    for i, variant in fleet_variants(base, perturbations, n_variants, seed):
        pol = policy_factory()
        if shared is not None:
            pol.fleet_shared = shared
        # Policy-level perturbations (e.g. PredictionNoisePerturbation)
        # draw from their own substream — [seed, i, 1], disjoint from the
        # event sampler's [seed, i] — so adding one never shifts the
        # event draws (or digests) of event/job perturbations.
        prng = np.random.default_rng([seed, i, 1])
        for p in perturbations:
            p.perturb_policy(pol, base, prng)
        t0 = time.perf_counter()
        res = simulate(variant, pol, validate=validate)
        row = VariantResult(
            index=i,
            name=variant.name,
            digest=res.schedule_digest(),
            total_flow_time=res.total_flow_time,
            makespan=res.makespan,
            mean_jct=res.mean_jct,
            n_migrations=res.n_migrations,
            n_events=res.n_events,
            wall_s=time.perf_counter() - t0,
        )
        rows.append(row)
        if progress is not None:
            progress(i, row)
    stats = {
        "total_flow_time": _dist([r.total_flow_time for r in rows]),
        "makespan": _dist([r.makespan for r in rows]),
        "mean_jct": _dist([r.mean_jct for r in rows]),
        "n_migrations": _dist([float(r.n_migrations) for r in rows]),
    }
    return FleetResult(
        variants=tuple(rows),
        seed=seed,
        stats=stats,
        prewarm=prewarm_stats,
        wall_s=time.perf_counter() - t_fleet,
    )
