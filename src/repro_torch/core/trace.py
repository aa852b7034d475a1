"""Synthetic MLaaS-like workload trace (substitute for [6], see DESIGN.md).

The two-month Alibaba MLaaS trace is not redistributable/available offline.
This generator reproduces its published statistics that matter to the
scheduling problem:

* recurrence: ~65 % of jobs belong to groups submitted >= 5 times; group
  sizes are Zipf-heavy-tailed;
* >70 % single-GPU jobs by default (``single_gpu_frac``);
* heavy-tailed iteration counts per group (log-normal group mean), with a
  fraction of early-terminated runs (user kills / failed exploration), which
  is what makes iteration counts *uncertain* and prediction non-trivial;
* Poisson arrivals with diurnal modulation over the horizon.

Scenario-level samplers (``straggler_scenario``, ``elastic_scenario``,
``elastic_events``) bundle a sampled trace with a cluster spec and a
typed event timeline into one serializable
:class:`~repro.core.scenario.Scenario` — the simulate() input — so a single seed pins workload, cluster, and events, and the
whole thing replays via ``benchmarks/sched_scale.py --scenario``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .job import ClusterSpec, JobSpec, RAR, ServerClass, StageSpec, TAR
from .profiles import PAPER_MODELS, SINGLE_GPU_MODELS, build_stages, make_job
from .scenario import (
    ClusterEvent,
    Degradation,
    IterJobs,
    Scenario,
    ServerJoin,
    ServerLeave,
)

# Mixed-generation server SKUs (gpus/server, NIC B/s, intra B/s): production
# GPU clusters run several accelerator generations side by side (Hu et al.,
# arXiv 2109.01313).  Ordered newest -> oldest; bandwidths follow the
# paper's 10 GbE / NVLink magnitudes with a 100 GbE NIC on the newest SKU
# and a half-width 4-GPU node for the oldest.
GPU_GENERATIONS: tuple = (
    ("gen-a", 8, 12.5e9, 300e9),
    ("gen-b", 8, 1.25e9, 150e9),
    ("gen-c", 4, 1.25e9, 50e9),
)


def mixed_cluster_spec(
    num_servers: int = 16,
    seed: int = 0,
    n_classes: int = 2,
    b_intra: float = 300e9,
) -> ClusterSpec:
    """Sample a mixed-generation cluster (companion to ``generate_trace``).

    Draws ``n_classes`` generations from ``GPU_GENERATIONS`` (newest first)
    and splits ``num_servers`` among them with every class non-empty, so a
    trace seed pins both the workload and the cluster it runs on.
    """
    if not 1 <= n_classes <= len(GPU_GENERATIONS):
        raise ValueError(
            f"n_classes must be in [1, {len(GPU_GENERATIONS)}]"
        )
    if num_servers < n_classes:
        raise ValueError("need at least one server per class")
    rng = np.random.default_rng(seed)
    # one server guaranteed per class; the rest multinomially split
    extra = rng.multinomial(
        num_servers - n_classes, np.full(n_classes, 1.0 / n_classes)
    )
    classes = [
        ServerClass(
            count=1 + int(extra[i]),
            gpus_per_server=gpus,
            b_inter=b_inter,
            b_intra=bi,
            name=name,
        )
        for i, (name, gpus, b_inter, bi) in enumerate(
            GPU_GENERATIONS[:n_classes]
        )
    ]
    return ClusterSpec.heterogeneous(classes, b_intra=b_intra)


def straggler_events(
    num_servers: int,
    horizon: float,
    n_stragglers: int = 4,
    seed: int = 0,
    factor_low: float = 0.25,
    factor_high: float = 0.75,
    start_frac: Tuple[float, float] = (0.2, 0.6),
    duration_frac: float = 0.25,
    recover: bool = True,
) -> List[Tuple[float, int, float]]:
    """Sample timed slowdown events for ``simulate(degradations=...)``.

    Production characterization (Hu et al., arXiv 2109.01313) attributes
    most tail slowdown to *partial* degradation — thermally throttled
    GPUs, flapping NICs — rather than outright failures.  This sampler
    draws ``n_stragglers`` distinct servers, each slowing to a factor in
    ``[factor_low, factor_high]`` at a time inside
    ``start_frac * horizon`` (mid-trace, so the cluster is loaded);
    ``recover=True`` pairs every slowdown with a return-to-1.0 event
    ``duration_frac * horizon`` later (clamped inside the horizon), so a
    finish-in-place policy pays the stretch while a migrating one can
    route around it.

    Deterministic per seed; events are returned time-sorted.
    """
    if n_stragglers > num_servers:
        raise ValueError(
            f"{n_stragglers} stragglers > {num_servers} servers"
        )
    if not 0.0 < factor_low <= factor_high:
        raise ValueError("factors must satisfy 0 < low <= high")
    rng = np.random.default_rng(seed)
    servers = rng.choice(num_servers, size=n_stragglers, replace=False)
    starts = rng.uniform(
        start_frac[0] * horizon, start_frac[1] * horizon, size=n_stragglers
    )
    factors = rng.uniform(factor_low, factor_high, size=n_stragglers)
    events: List[Tuple[float, int, float]] = [
        (float(t), int(m), float(f))
        for t, m, f in zip(starts, servers, factors)
    ]
    if recover:
        dur = duration_frac * horizon
        events.extend(
            (float(min(t + dur, horizon)), int(m), 1.0)
            for t, m in zip(starts, servers)
        )
    events.sort()
    return events


def elastic_events(
    servers: Sequence[int],
    join_at: Optional[float],
    leave_at: float = 0.0,
    drain_timeout: float = 0.0,
) -> List[ClusterEvent]:
    """Elastic-capacity timeline: ``servers`` leave at ``leave_at`` and
    (unless ``join_at`` is None — permanently lost capacity) rejoin at
    ``join_at``.  ``leave_at=0.0`` with the default immediate
    ``drain_timeout=0.0`` expresses "absent from the start" — the
    ``ClusterSpec`` stays the full universe of server slots and the
    scenario carves the live subset out of it (see scenario.py).
    """
    if join_at is not None and join_at <= leave_at:
        # equality is rejected too: the canonical (t, server, kind)
        # order applies joins *before* leaves at one instant, so a
        # same-time pair would leave the servers down for good
        raise ValueError(
            f"join_at {join_at} precedes or coincides with "
            f"leave_at {leave_at}"
        )
    events: List[ClusterEvent] = [
        ServerLeave(float(leave_at), int(m), drain_timeout=drain_timeout)
        for m in servers
    ]
    if join_at is not None:
        events.extend(ServerJoin(float(join_at), int(m)) for m in servers)
    return events


def straggler_scenario(
    cfg: "TraceConfig",
    cluster: Optional[ClusterSpec] = None,
    n_stragglers: int = 4,
    event_seed: int = 0,
    name: str = "",
    **straggler_kw,
) -> Scenario:
    """Sample a full degradation scenario: trace + mixed cluster +
    ``straggler_events`` timeline, bundled as one serializable
    :class:`Scenario` (``cluster`` defaults to ``mixed_cluster_spec``
    seeded like the trace, so one seed pins everything)."""
    if cluster is None:
        cluster = mixed_cluster_spec(seed=cfg.seed)
    events = [
        Degradation(t, m, factor=f)
        for t, m, f in straggler_events(
            cluster.num_servers, cfg.horizon, n_stragglers=n_stragglers,
            seed=event_seed, **straggler_kw,
        )
    ]
    return Scenario(
        jobs=tuple(generate_trace(cfg)), cluster=cluster,
        events=tuple(events), name=name or f"straggler-{cfg.seed}",
    )


def elastic_scenario(
    cfg: "TraceConfig",
    cluster: Optional[ClusterSpec] = None,
    elastic_servers: Sequence[int] = (0, 1, 2, 3),
    join_frac: Optional[float] = 0.5,
    drain_timeout: float = 0.0,
    name: str = "",
) -> Scenario:
    """Sample an elastic-capacity scenario: ``elastic_servers`` are absent
    from the start and join at ``join_frac * cfg.horizon`` (None = never —
    the static-degraded baseline the recovered flow time is measured
    against in ``sched_scale --elastic``)."""
    if cluster is None:
        cluster = mixed_cluster_spec(seed=cfg.seed)
    join_at = None if join_frac is None else join_frac * cfg.horizon
    return Scenario(
        jobs=tuple(generate_trace(cfg)), cluster=cluster,
        events=tuple(
            elastic_events(
                elastic_servers, join_at, drain_timeout=drain_timeout
            )
        ),
        name=name or f"elastic-{cfg.seed}",
    )


@dataclass
class TraceConfig:
    n_jobs: int = 5000
    horizon: float = 60 * 24 * 3600.0  # two months, seconds
    single_gpu_frac: float = 0.7
    recur_zipf_a: float = 1.8  # group size tail exponent
    mean_iters: float = 400.0
    sigma_iters: float = 1.2  # log-normal sigma of group means
    early_kill_frac: float = 0.08  # jobs stopped early (uncertain n_i)
    # Fraction of groups whose re-submissions are internally *constant*
    # (users rerunning identical jobs — the dominant MLaaS pattern that
    # makes ~60 % of jobs exactly predictable, paper Fig. 4); the rest are
    # exploration groups with per-job variation.
    constant_group_frac: float = 0.55
    n_users: int = 120
    max_gpus_per_job: Optional[int] = None  # clamp g_i (<= cluster G)
    seed: int = 0
    # Arrival burstiness (MLaaS-like): group submissions are clustered --
    # users submit several exploratory configurations in a session and
    # resubmit after observing results.
    burst_frac: float = 0.7  # fraction of a group's jobs in its session
    session_spread: float = 1800.0  # intra-session spacing scale (s)


def generate_trace(cfg: TraceConfig) -> List[JobSpec]:
    """Generate the trace with NumPy-vectorized draws.

    All random quantities are drawn as arrays (group sizes in chunks; one
    flat array per per-group / per-job attribute, with segmented cumsums
    for the intra-session spacings), so generating 10^5+ jobs takes
    seconds — the only per-job Python work left is ``make_job``.
    """
    rng = np.random.default_rng(cfg.seed)

    # --- groups with Zipf-ish sizes until we cover n_jobs -----------------
    sizes_np = np.empty(0, dtype=np.int64)
    while int(sizes_np.sum()) < cfg.n_jobs:
        chunk = np.minimum(
            rng.zipf(cfg.recur_zipf_a, size=max(256, cfg.n_jobs // 8)), 200
        )
        sizes_np = np.concatenate([sizes_np, chunk])
    # cut at the first group crossing n_jobs, trim its overshoot
    cum = np.cumsum(sizes_np)
    n_groups = int(np.searchsorted(cum, cfg.n_jobs)) + 1
    sizes_np = sizes_np[:n_groups].copy()
    overshoot = int(cum[n_groups - 1]) - cfg.n_jobs
    if overshoot > 0:
        sizes_np[-1] -= overshoot
        if sizes_np[-1] <= 0:
            sizes_np = sizes_np[:-1]
    sizes = sizes_np.tolist()
    G = len(sizes)
    N = int(sizes_np.sum())
    starts = np.concatenate([[0], np.cumsum(sizes_np)[:-1]])
    group_of = np.repeat(np.arange(G), sizes_np)

    # --- group-level attributes (vectorized) ------------------------------
    model_names = list(PAPER_MODELS)
    single = rng.random(G) < cfg.single_gpu_frac
    single_model_idx = rng.integers(0, len(SINGLE_GPU_MODELS), size=G)
    multi_model_idx = rng.integers(0, len(model_names), size=G)
    config_u = rng.random(G)  # uniform pick within the valid config list
    user_ids = rng.integers(0, cfg.n_users, size=G)
    rar = rng.random(G) < 0.5
    group_means = np.exp(
        rng.normal(np.log(cfg.mean_iters), cfg.sigma_iters, size=G)
    )
    constant_group = rng.random(G) < cfg.constant_group_frac

    # valid multi-GPU config indices per model (respecting the clamp)
    multi_configs: dict = {}
    for name in model_names:
        profile = PAPER_MODELS[name]
        multi = [i for i, c in enumerate(profile.configs) if sum(c) > 1]
        if cfg.max_gpus_per_job is not None:
            ok = [
                i
                for i in multi
                if sum(profile.configs[i]) <= cfg.max_gpus_per_job
            ]
            multi_configs[name] = ok if ok else [0]
        else:
            multi_configs[name] = multi

    # --- arrivals ----------------------------------------------------------
    # Bursty, diurnal: a group's submissions cluster into a "session"
    # (hyper-parameter exploration burst) anchored at a business-hours
    # start; the rest spread over the horizon.  Sessions are *clamped* to
    # the horizon — wrapping them (mod horizon) would let a group's later
    # submissions arrive before its anchor, breaking the "recurring jobs
    # are observed before being predicted" premise.
    day = 24 * 3600.0
    n_day = max(1, int(cfg.horizon // day))
    anchors = (
        rng.integers(0, n_day, size=G) * day + rng.uniform(8, 20, size=G) * 3600.0
    )
    # The business-hours draw can land past a sub-day horizon (and the last
    # day's evening can overhang a multi-day one); fold the anchor back so
    # every session *starts* inside the horizon and only its tail truncates.
    anchors %= cfg.horizon
    in_session = rng.random(N) < cfg.burst_frac
    n_sess_total = int(in_session.sum())
    gaps = rng.exponential(cfg.session_spread, size=n_sess_total)
    # segmented cumsum of the session gaps (grouped by each job's group)
    sess_group = group_of[in_session]
    gap_cum = np.cumsum(gaps)
    seg_start = np.concatenate(
        [[0], np.searchsorted(sess_group, np.arange(1, G))]
    )
    base = np.zeros(G)
    has_sess = seg_start < n_sess_total
    first = seg_start[has_sess]
    base[has_sess] = gap_cum[first] - gaps[first]
    sess_times = anchors[sess_group] + (gap_cum - base[sess_group])
    arrivals = np.empty(N)
    arrivals[in_session] = np.minimum(sess_times, cfg.horizon)
    arrivals[~in_session] = rng.uniform(0, cfg.horizon, size=N - n_sess_total)

    # --- iteration counts ---------------------------------------------------
    factors = np.where(
        constant_group[group_of],
        1.0,
        rng.uniform(0.85, 1.15, size=N),  # exploration variation
    )
    killed = rng.random(N) < cfg.early_kill_frac
    factors = np.where(
        killed, factors * rng.uniform(0.05, 0.5, size=N), factors
    )
    n_iters = np.maximum(
        1, np.round(group_means[group_of] * factors)
    ).astype(np.int64)

    # --- materialize JobSpecs ----------------------------------------------
    jobs: List[JobSpec] = []
    job_id = 0
    for gid in range(G):
        size = sizes[gid]
        lo = int(starts[gid])
        if single[gid]:
            model = SINGLE_GPU_MODELS[int(single_model_idx[gid])]
            config_idx = 0  # config (1,) is first for single-GPU models
        else:
            model = model_names[int(multi_model_idx[gid])]
            ok = multi_configs[model]
            config_idx = ok[int(config_u[gid] * len(ok))]
        user_id = int(user_ids[gid])
        allreduce = RAR if rar[gid] else TAR
        order = np.argsort(arrivals[lo : lo + size], kind="stable")
        for k in order:
            i = lo + int(k)
            jobs.append(
                make_job(
                    job_id=job_id,
                    model=model,
                    config_idx=config_idx,
                    n_iters=int(n_iters[i]),
                    arrival=float(arrivals[i]),
                    group_id=gid,
                    user_id=user_id,
                    allreduce=allreduce,
                )
            )
            job_id += 1

    jobs.sort(key=lambda j: (j.arrival, j.job_id))
    for job in jobs:
        # materialize the cached derived attributes (g, interned config id)
        # at generation time, off the schedulers' hot path
        job.g
        job.config_key
    return jobs


@dataclass
class StreamTraceConfig:
    """Recipe for :func:`stream_trace` — the bounded-memory generator.

    Unlike :class:`TraceConfig` (which materializes, globally sorts, and
    segments sessions — all O(n_jobs)), the streaming recipe draws
    arrivals as a single Poisson process (exponential gaps, cumulative
    sum carried across chunks — already time-ordered, no sort) against a
    *bounded* recurrence pool of ``n_groups`` groups with Zipf-ranked
    popularity.  Everything resident is O(n_groups + chunk), so a 10^6+
    job trace streams through ``simulate`` without ever existing as a
    list.

    ``arrival_rate`` is jobs/second.  Keep the offered load (rate x mean
    GPU-seconds per job) under the cluster's GPU capacity or the live
    queue — and with it the simulator's working set — grows without
    bound; the defaults target roughly half utilization of the
    64-server / 512-GPU ``sched_scale --stream`` cluster (saturation
    sets in just past 6.5 jobs/s there).
    """

    n_jobs: int = 1_000_000
    arrival_rate: float = 6.0  # Poisson arrivals per second
    single_gpu_frac: float = 0.9
    n_groups: int = 4096  # bounded recurrence pool
    group_zipf_a: float = 1.3  # popularity tail over group ranks
    mean_iters: float = 40.0
    sigma_iters: float = 1.0  # log-normal sigma of group means
    early_kill_frac: float = 0.08
    constant_group_frac: float = 0.55
    n_users: int = 500
    max_gpus_per_job: Optional[int] = 8  # clamp g_i (<= cluster G)
    seed: int = 0
    chunk: int = 8192  # vectorized draw granularity (resident bound)


def stream_trace(cfg: StreamTraceConfig) -> Iterator[JobSpec]:
    """Yield ``cfg.n_jobs`` time-ordered jobs in O(n_groups + chunk) memory.

    Group attributes (model, config, user, allreduce, iteration-count
    mean, constant-vs-exploration) are drawn once for the bounded pool;
    per-chunk draws pick a group by Zipf popularity and sample the
    job-level variation (exploration factor, early kills).  Stage tuples
    are built once per (model, config) and shared across all their jobs.
    Deterministic per seed.
    """
    if cfg.n_jobs < 0:
        raise ValueError(f"n_jobs must be >= 0, got {cfg.n_jobs}")
    if cfg.arrival_rate <= 0.0:
        raise ValueError(f"arrival_rate must be > 0, got {cfg.arrival_rate}")
    rng = np.random.default_rng(cfg.seed)
    G = cfg.n_groups
    model_names = list(PAPER_MODELS)

    # --- bounded group pool (one vectorized draw, O(n_groups)) ------------
    single = rng.random(G) < cfg.single_gpu_frac
    single_model_idx = rng.integers(0, len(SINGLE_GPU_MODELS), size=G)
    multi_model_idx = rng.integers(0, len(model_names), size=G)
    config_u = rng.random(G)
    user_ids = rng.integers(0, cfg.n_users, size=G)
    rar = rng.random(G) < 0.5
    group_means = np.exp(
        rng.normal(np.log(cfg.mean_iters), cfg.sigma_iters, size=G)
    )
    constant_group = rng.random(G) < cfg.constant_group_frac

    # valid multi-GPU config indices per model (respecting the clamp);
    # mirrors generate_trace
    multi_configs: Dict[str, List[int]] = {}
    for name in model_names:
        profile = PAPER_MODELS[name]
        multi = [i for i, c in enumerate(profile.configs) if sum(c) > 1]
        if cfg.max_gpus_per_job is not None:
            ok = [
                i
                for i in multi
                if sum(profile.configs[i]) <= cfg.max_gpus_per_job
            ]
            multi_configs[name] = ok if ok else [0]
        else:
            multi_configs[name] = multi

    # resolve each group to (model, stages, allreduce); stage tuples are
    # memoized per (model, config_idx) and shared by every job instance
    stage_cache: Dict[Tuple[str, int], Tuple[StageSpec, ...]] = {}
    group_model: List[str] = []
    group_stages: List[Tuple[StageSpec, ...]] = []
    group_allreduce: List[str] = []
    for gid in range(G):
        if single[gid]:
            model = SINGLE_GPU_MODELS[int(single_model_idx[gid])]
            config_idx = 0  # config (1,) is first for single-GPU models
        else:
            model = model_names[int(multi_model_idx[gid])]
            ok = multi_configs[model]
            config_idx = ok[int(config_u[gid] * len(ok))]
        key = (model, config_idx)
        stages = stage_cache.get(key)
        if stages is None:
            profile = PAPER_MODELS[model]
            stages = build_stages(
                profile, profile.configs[config_idx % len(profile.configs)]
            )
            stage_cache[key] = stages
        group_model.append(model)
        group_stages.append(stages)
        group_allreduce.append(RAR if rar[gid] else TAR)

    # Zipf-ranked group popularity (heavy-tailed recurrence without an
    # unbounded group universe)
    pop = np.arange(1, G + 1, dtype=np.float64) ** -cfg.group_zipf_a
    pop /= pop.sum()

    # --- chunked job stream ------------------------------------------------
    t = 0.0
    job_id = 0
    remaining = cfg.n_jobs
    while remaining > 0:
        m = min(cfg.chunk, remaining)
        times = t + np.cumsum(
            rng.exponential(1.0 / cfg.arrival_rate, size=m)
        )
        t = float(times[-1])
        gidx = rng.choice(G, size=m, p=pop)
        factors = np.where(
            constant_group[gidx],
            1.0,
            rng.uniform(0.85, 1.15, size=m),  # exploration variation
        )
        killed = rng.random(m) < cfg.early_kill_frac
        factors = np.where(
            killed, factors * rng.uniform(0.05, 0.5, size=m), factors
        )
        n_iters = np.maximum(
            1, np.round(group_means[gidx] * factors)
        ).astype(np.int64)
        for i in range(m):
            gid = int(gidx[i])
            yield JobSpec(
                job_id=job_id,
                stages=group_stages[gid],
                n_iters=int(n_iters[i]),
                arrival=float(times[i]),
                group_id=gid,
                user_id=int(user_ids[gid]),
                allreduce=group_allreduce[gid],
                model_name=group_model[gid],
            )
            job_id += 1
        remaining -= m


def stream_trace_source(cfg: StreamTraceConfig) -> IterJobs:
    """The streaming trace as a replayable ``Scenario.jobs`` source."""
    return IterJobs(lambda: stream_trace(cfg), name=f"stream-{cfg.seed}")


def trace_stats(jobs: Sequence[JobSpec]) -> dict:
    from collections import Counter

    group_counts = Counter(j.group_id for j in jobs)
    recurrent = sum(
        1 for j in jobs if group_counts[j.group_id] >= 5
    )
    single = sum(1 for j in jobs if j.g == 1)
    return {
        "n_jobs": len(jobs),
        "frac_recurrent_ge5": recurrent / max(len(jobs), 1),
        "frac_single_gpu": single / max(len(jobs), 1),
        "n_groups": len(group_counts),
        "max_g": max(j.g for j in jobs),
    }
