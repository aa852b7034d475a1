"""Event-driven cluster simulator for online non-preemptive scheduling.

The paper's Algorithm 1 iterates unit time-slots; cluster state only changes
at job arrivals/completions (plus the comm-heavy delay deadlines), so we
advance event-to-event — the schedule produced is identical while remaining
tractable for 10^5-job traces.  ``tests/test_asrpt.py`` cross-checks against
a literal slotted execution on small instances.

``simulate(scenario, policy)`` is the one entry point: a
:class:`~repro.core.scenario.Scenario` bundles the workload, the cluster
spec, and a single canonical timeline of typed cluster events (faults,
degradations, elastic ServerJoin/ServerLeave — see scenario.py).  The
legacy ``simulate(jobs, spec, faults=..., degradations=...)`` signature
is kept as a thin shim that builds a ``Scenario``; it is property-tested
bit-identical (tests/test_scenario.py) and the golden fixtures
(tests/golden/) pin it byte-for-byte.  Same-timestamp events apply in
the scenario's canonical ``(t, server, kind, magnitude)`` order — not in
caller interleaving order (the tie-break rule; scenario.py
documents the ranking).

Hot-path design (trace scale):

* policies *own* their allocations: ``plan_pass`` allocates on the live
  ``ClusterState`` and the simulator only releases on completion.  (The old
  protocol had each pass allocate, undo, and the simulator re-allocate —
  three O(placement) dict walks per start, and the undo releases defeated
  the release-epoch change tracking policies use to skip recomputation.)
* wake-ups are epoch-tagged: at most one *live* wake event exists at a
  time; superseded wakes stay in the heap but are recognised as stale by
  their epoch and skipped without a scheduling pass.
* all events at the same timestamp are drained before a single scheduling
  pass runs.

Policies observe only online information: arrivals as they happen, true
iteration counts only at completion (fed to the predictor).

Degradation events (stragglers): a ``Degradation(t, server, factor)``
scales a server's effective speed mid-run (see cluster.py / timing.py).
Running jobs touching the server are *re-timed*: their remaining
iterations are brought to ``t`` under the old alpha, a new alpha is
evaluated under the updated speed map, and the completion event is
re-issued.  Completion events are therefore epoch-tagged per job (like
wakes): superseded completions stay in the heap and are dropped on pop.
A ``factor == 0.0`` event takes the fault path verbatim (capacity
forfeited, running jobs finish in place, no re-timing) — ``Fault`` is
the same event, and the legacy ``faults=`` keyword is sugar for it.
After re-timing, the policy's ``plan_migrations`` hook may
checkpoint-restart affected jobs onto fresh capacity (see migration.py);
the simulator re-times migrated jobs with the restart penalty and
updates their records in place.

Elastic capacity: a ``ServerLeave(t, server, drain_timeout)`` starts a
graceful drain — no new allocations; while the window is open, jobs
still running on the leaving server join the migration watch (a
migrating policy can checkpoint-restart them off before the server
disappears; for an undegraded drain the race only moves a job whose
fresh placement beats its current one by more than the penalty).  At
``t + drain_timeout`` the server is gone for good — jobs still on it
finish in place, as after a fault.  ``drain_timeout == 0`` *is* the fault
path (property-tested equal).  A ``ServerJoin(t, server)`` brings an
inactive slot online (class capacity minus GPUs still held by running
jobs); the epoch bump wakes settled policies so queued work starts on
the new capacity in the same pass.
"""
from __future__ import annotations

import hashlib
import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import (
    Dict,
    List,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    Union,
    runtime_checkable,
)

import numpy as np

from .cluster import ClusterState
from .job import ClusterSpec, JobSpec
from .scenario import (
    ClusterEvent,
    Degradation,
    Fault,
    JobStream,
    Scenario,
    ServerJoin,
    ServerLeave,
    scenario_from_legacy,
)
from . import timing

# Completions free capacity and cluster events (faults, degradations,
# joins/leaves) change it before arrivals/wakes at the same timestamp
# trigger the scheduling pass.
_COMPLETION, _CLUSTER, _ARRIVAL, _WAKE = 0, 1, 2, 3


@dataclass(slots=True)
class Allocation:
    """One placement decision returned by ``Policy.plan_pass``.

    The policy has already called ``cluster.allocate`` for it (policies
    own their allocations); the simulator only computes the completion
    and releases on it.

    ``n_pred`` is the predicted iteration count the decision was made
    with (prediction_loop): when set — policies attach it only when
    their predictor tracks overruns — the simulator watches for the job
    running past ``t + n_pred * alpha`` and asks the policy to
    re-estimate there.  ``None`` (the default, and what every
    pre-prediction-loop policy produces) means nothing is watched; the
    physical completion is always timed with the *true* ``job.n_iters``
    either way.
    """

    job: JobSpec
    placement: Dict[int, np.ndarray]
    alpha: float
    n_pred: Optional[float] = None


# Historical name; same type.
Start = Allocation


@dataclass(slots=True)
class Migration:
    """A checkpoint-restart decision returned by ``Policy.plan_migrations``.

    The policy has already released the job's old allocation and allocated
    ``placement`` (policies own their allocations, as with ``Allocation``);
    the simulator re-times the job: remaining iterations resume at
    ``alpha`` after ``penalty`` seconds of checkpoint-restart downtime.
    """

    job: JobSpec
    placement: Dict[int, np.ndarray]
    alpha: float
    penalty: float


@dataclass(slots=True)
class JobRecord:
    arrival: float
    start: float
    completion: float
    alpha: float
    servers: Tuple[int, ...]
    migrations: int = 0


@dataclass(slots=True)
class _Running:
    """Live bookkeeping for one started job (degradation re-timing).

    ``iters_rem`` is the remaining iteration count as of ``since`` —
    which is the time the job last (re)started *computing*: after a
    migration ``since`` sits at ``t + penalty``, so the checkpoint-
    restart downtime is never credited as productive work if another
    event re-times the job mid-restart (re-timings subtract elapsed
    iterations only for ``t > since``).  The live completion event
    carries ``epoch`` — re-timing bumps it, turning the superseded event
    into a stale heap entry.  Instances double as the read-only views
    handed to ``Policy.plan_migrations``.

    ``pred_rem`` mirrors ``iters_rem`` for the *predicted* iteration
    count (prediction_loop): decremented in lockstep at every
    elapsed-iteration subtraction, re-set by mid-flight re-estimation.
    ``pred_epoch`` tags the one live predicted-completion check event
    the way ``epoch`` tags the completion — superseded checks stay in
    the heap and are dropped on pop.  ``None`` (any start without
    ``n_pred``) disables the watch for this job.
    """

    job: JobSpec
    placement: Dict[int, np.ndarray]
    alpha: float
    iters_rem: float
    since: float
    epoch: int = 0
    pred_rem: Optional[float] = None
    pred_epoch: int = 0


@dataclass(slots=True)
class _DrainDeadline:
    """Internal event: a ServerLeave drain window closes (not part of the
    scenario schema — synthesized when the leave is applied).  ``gen``
    is the per-server drain generation at synthesis: a join cancelling
    the drain and a later leave re-opening it would otherwise let this
    stale deadline close the *new* window early (like wake/completion
    events, stale entries stay in the heap and are dropped on pop)."""

    server: int
    gen: int


@dataclass(slots=True)
class _PredCheck:
    """Internal event: a watched job reached its *predicted* completion
    while still running (prediction_loop).  Rides the ``_CLUSTER`` lane
    (after completions at the same timestamp — a job finishing exactly
    on its prediction needs no re-estimate) but, like
    :class:`_DrainDeadline`, never reaches ``Policy.on_event``: the
    simulator consumes it, brings the job's bookkeeping to ``t``, asks
    ``policy.on_overrun`` for a fresh predicted-remaining, and re-arms
    the check there.  ``epoch`` is the job's ``pred_epoch`` at push
    time; any re-timing bumps it, so superseded checks are dropped on
    pop."""

    job_id: int
    epoch: int


@dataclass(slots=True)
class _ReqArrival:
    """Internal event: the next request of one serving lane arrives.  One
    live instance per lane rides the heap (re-pushed at the following
    arrival time as each pops), so the heap stays bounded by live events
    even for million-request streams.  Never reaches ``Policy.on_event``.
    """

    lane: int


@dataclass(slots=True)
class _BatchDone:
    """Internal event: a serving replica finishes its in-flight batch.
    The batch's request arrival times live on the lane (bounded by
    ``max_batch * max_replicas``); latencies fold into the result's
    bounded estimators at pop.  Never reaches ``Policy.on_event``."""

    lane: int
    replica: int


@dataclass(slots=True)
class _Resume:
    """Checkpoint state of a preempted training job awaiting restart:
    remaining iterations at eviction, the epoch its restarted completion
    event must carry (old epoch + 1, so the stale pre-preemption
    completion is dropped on pop), the ``pred_epoch`` to continue from
    (same staleness argument for in-flight prediction checks), and the
    original :class:`JobRecord` — a restart updates it in place, so
    ``arrival`` and first ``start`` survive and the eviction counts as a
    migration."""

    iters_rem: float
    epoch: int
    pred_epoch: int
    rec: "JobRecord"


_DIGEST_MOD = 1 << 256

# Flow-time quantiles the streaming backend tracks with bounded-memory
# estimators (quantile.py) — the tail metrics the serving/prediction
# gates read.  Exact (bit-identical to the materialized formula) while
# the completed-job count fits the estimator buffer (8192), uniform-
# reservoir approximate beyond.
STREAM_FLOW_QUANTILES = (50.0, 95.0, 99.0)

# Request-latency quantiles the serving lane tracks.  Request counts are
# unbounded (million-request streams), so latencies always go through
# the bounded estimators — even on materialized runs.
SERVE_LAT_QUANTILES = (50.0, 99.0)


def _record_digest(jid: int, r: JobRecord) -> int:
    """sha256 of one per-job record line, as an integer.

    ``repr`` of the floats keeps the line exact (shortest round-trip
    repr) and platform-stable for the matmul-free engines.  The
    per-record hashes combine by *summation* mod 2^256 (see
    ``SimResult.schedule_digest``), so the streaming backend can fold a
    record the moment its job completes and forget it — no jid-sorted
    walk over an O(jobs) dict."""
    return int.from_bytes(
        hashlib.sha256(
            (
                f"{jid}:{r.start!r}:{r.completion!r}:{r.alpha!r}:"
                f"{r.servers}:{r.migrations}\n"
            ).encode()
        ).digest(),
        "big",
    )


def _msum_add(partials: List[float], x: float) -> None:
    """Shewchuk growth step: add ``x`` to the non-overlapping partial-sum
    list in place.  ``math.fsum(partials)`` afterwards equals
    ``math.fsum`` over every value ever added — exactly, in any insertion
    order — which is what makes the streaming backend's flow-time sums
    bit-identical to the materialized path's ``fsum`` over records."""
    i = 0
    for y in partials:
        if abs(x) < abs(y):
            x, y = y, x
        hi = x + y
        lo = y - (hi - x)
        if lo:
            partials[i] = lo
            i += 1
        x = hi
    partials[i:] = [x]


@dataclass
class SimResult:
    """Per-job schedule records + engine stats — or, in streaming mode,
    incremental aggregates over the same records.

    Materialized runs fill ``records`` (job_id -> :class:`JobRecord`).
    Streaming runs (``simulate(..., stream=True)`` or a
    :class:`~repro.core.scenario.JobStream`-backed scenario) set
    ``records = None`` and fold each record into exact aggregates at its
    completion, so memory stays bounded by the *live* job count.  Every
    metric property and ``schedule_digest`` answers identically over
    either backend (property-tested + pinned by the golden fixtures):
    sums are order-independent correctly-rounded ``fsum`` s, and the
    digest is a commutative per-record sum."""

    records: Optional[Dict[int, JobRecord]] = field(default_factory=dict)
    # engine statistics (filled by ``simulate``; benchmarks/sched_scale.py)
    n_events: int = 0
    n_sched_passes: int = 0
    peak_queue_depth: int = 0
    n_migrations: int = 0
    # mid-flight prediction re-estimates (prediction_loop): 0 for oracle
    # and for every policy that doesn't track overruns
    n_reestimates: int = 0
    wall_s: float = 0.0
    n_jobs: int = 0
    # streaming aggregates (used when records is None): Shewchuk partial
    # sums, running max, the commutative digest accumulator, and
    # bounded-memory flow-time quantile estimators (quantile.py)
    _flow_parts: List[float] = field(default_factory=list)
    _comp_parts: List[float] = field(default_factory=list)
    _max_completion: float = 0.0
    _digest_acc: int = 0
    _flow_q: Optional[Dict[float, "StreamingQuantile"]] = None
    # serving-lane aggregates: request counts/latencies fold at
    # each batch completion (requests never materialize), training-job
    # preemptions for serving replicas count here
    n_requests: int = 0
    n_slo_met: int = 0
    n_preemptions: int = 0
    _req_lat_parts: List[float] = field(default_factory=list)
    _req_q: Optional[Dict[float, "StreamingQuantile"]] = None

    def _fold_request(self, latency: float, slo: float) -> None:
        """Stream one served request into the serving aggregates."""
        self.n_requests += 1
        if latency <= slo:
            self.n_slo_met += 1
        _msum_add(self._req_lat_parts, latency)
        if self._req_q is None:
            from .quantile import StreamingQuantile

            self._req_q = {
                q: StreamingQuantile(q) for q in SERVE_LAT_QUANTILES
            }
        for est in self._req_q.values():
            est.add(latency)

    @property
    def slo_attainment(self) -> float:
        """Fraction of requests served within their stream's SLO (1.0 on
        runs without requests — an empty serving lane violates nothing)."""
        return self.n_slo_met / self.n_requests if self.n_requests else 1.0

    @property
    def mean_request_latency(self) -> float:
        return math.fsum(self._req_lat_parts) / max(self.n_requests, 1)

    def request_latency_percentile(self, q: float) -> float:
        """Request-latency percentile over the tracked quantiles
        (``SERVE_LAT_QUANTILES``: p50/p99), answered by the bounded
        estimators — exact below the 8192-request buffer, uniform-
        reservoir approximate beyond (quantile.py documents the bound).
        0.0 on runs without requests; untracked quantiles raise."""
        est = (self._req_q or {}).get(float(q))
        if est is not None:
            return est.value()
        if self._req_q is None:
            return 0.0
        raise RuntimeError(
            f"serving runs track only the {sorted(self._req_q)} request-"
            f"latency percentiles; q={q} is not tracked"
        )

    def _fold(self, jid: int, rec: JobRecord) -> None:
        """Stream one completed record into the aggregates (after this
        the record can be forgotten)."""
        flow = rec.completion - rec.arrival
        _msum_add(self._flow_parts, flow)
        _msum_add(self._comp_parts, rec.completion)
        if rec.completion > self._max_completion:
            self._max_completion = rec.completion
        if self._flow_q is None:
            from .quantile import StreamingQuantile

            self._flow_q = {
                q: StreamingQuantile(q) for q in STREAM_FLOW_QUANTILES
            }
        for est in self._flow_q.values():
            est.add(flow)
        self._digest_acc = (
            self._digest_acc + _record_digest(jid, rec)
        ) % _DIGEST_MOD

    @property
    def total_completion_time(self) -> float:
        if self.records is None:
            return math.fsum(self._comp_parts)
        return math.fsum(r.completion for r in self.records.values())

    @property
    def total_flow_time(self) -> float:
        if self.records is None:
            return math.fsum(self._flow_parts)
        return math.fsum(r.completion - r.arrival for r in self.records.values())

    @property
    def makespan(self) -> float:
        if self.records is None:
            return self._max_completion
        # guard the empty case like mean_jct (max() raises on no records)
        if not self.records:
            return 0.0
        return max(r.completion for r in self.records.values())

    @property
    def mean_jct(self) -> float:
        n = self.n_jobs if self.records is None else len(self.records)
        return self.total_flow_time / max(n, 1)

    @property
    def events_per_sec(self) -> float:
        return self.n_events / self.wall_s if self.wall_s > 0 else float("nan")

    def flow_percentile(self, q: float) -> float:
        """Per-job flow-time percentile (linear interpolation, numpy's
        default definition).

        Materialized runs sort the records exactly.  Streaming runs fold
        records away, so the tracked quantiles (``STREAM_FLOW_QUANTILES``:
        p50/p95/p99) are answered by bounded-memory estimators
        (quantile.py): *exact and bit-identical* to this method's
        materialized formula while the completed-job count fits the
        estimator buffer (8192), uniform-reservoir approximate beyond
        (documented bound: within ~10 % relative on heavy-tailed flows,
        typically ~1 %).  Untracked quantiles on a streaming run
        raise."""
        if self.records is None:
            est = (self._flow_q or {}).get(float(q))
            if est is not None:
                return est.value()
            if self._flow_q is None and self.n_jobs == 0:
                return 0.0
            raise RuntimeError(
                f"streaming runs track only the "
                f"{sorted(self._flow_q or STREAM_FLOW_QUANTILES)} flow "
                f"percentiles; q={q} needs a materialized run "
                f"(stream=False)"
            )
        if not self.records:
            return 0.0
        flows = sorted(r.completion - r.arrival for r in self.records.values())
        if len(flows) == 1:
            return flows[0]
        pos = (q / 100.0) * (len(flows) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(flows) - 1)
        return flows[lo] + (pos - lo) * (flows[hi] - flows[lo])

    def schedule_digest(self) -> str:
        """Byte-identity fingerprint over every per-job record — what the
        golden harness (tests/test_golden.py) and ``sched_scale
        --scenario`` replays compare.  Per-record sha256 values are
        summed mod 2^256 (hex-formatted to the usual 64 chars): the sum
        commutes, so the streaming backend folds records at completion
        time in completion order, the materialized backend in dict
        order, and both land on the same digest."""
        if self.records is None:
            acc = self._digest_acc
        else:
            acc = 0
            for jid, r in self.records.items():
                acc = (acc + _record_digest(jid, r)) % _DIGEST_MOD
        return f"{acc:064x}"


@runtime_checkable
class SchedulingPolicy(Protocol):
    """The formal policy contract ``simulate`` drives (third-party
    policies implement this; ``Policy`` below is the in-tree base with
    default no-ops).  Lifecycle per simulation:

    1. ``bind(cluster_spec)`` once, before any event;
    2. per event timestamp, after state changes apply:
       ``on_arrival``/``on_completion`` for job events, ``on_event`` for
       every cluster event (fault/degradation/join/leave);
    3. ``plan_migrations(t, cluster, candidates)`` — only while migration
       candidates exist and ``migrate`` is truthy;
    4. ``plan_pass(t, cluster)`` — the scheduling pass; returns
       ``Allocation`` s the policy has already allocated on ``cluster``;
    5. ``next_wakeup(t)`` — optional future self-wake.
    """

    migrate: bool

    def bind(self, cluster_spec: ClusterSpec) -> None: ...

    def on_arrival(self, t: float, job: JobSpec) -> None: ...

    def on_completion(self, t: float, job: JobSpec) -> None: ...

    def on_event(
        self, t: float, event: ClusterEvent, cluster: ClusterState
    ) -> None: ...

    def plan_pass(self, t: float, cluster: ClusterState) -> List[Allocation]: ...

    def plan_migrations(
        self, t: float, cluster: ClusterState, candidates: List["_Running"]
    ) -> List[Migration]: ...

    def next_wakeup(self, t: float) -> Optional[float]: ...

    def queue_depth(self) -> int: ...


class Policy:
    """Scheduling policy base class (see asrpt.py / baselines.py).

    ``plan_pass`` must ``cluster.allocate`` every returned allocation —
    the allocation is kept (the simulator releases it at the job's
    completion).  ``schedule`` remains from the pre-protocol API both as
    a caller-facing alias and as an override point: a subclass that only
    defines ``schedule`` is still dispatched through it (the simulator
    binds the override when one exists); new code overrides
    ``plan_pass``.
    """

    # Opt-in for the degradation/drain migration hook: the simulator
    # maintains the migration watchlist and calls ``plan_migrations`` only
    # when this is truthy (MigrationMixin exposes it as a constructor arg).
    migrate: bool = False

    # Prediction-loop opt-in (repro.core.prediction_loop): truthy when the
    # policy's predictor wants predicted completions watched.  Policies
    # derive it from ``predictor.track_overruns`` in their constructors
    # (and through ``set_predictor``); the simulator keeps the running-job
    # registry and fires ``on_overrun`` only when it is set, so every
    # pre-prediction-loop policy runs the legacy event sequence byte for
    # byte.
    track_overruns: bool = False

    # Fleet cache sharing (repro.core.fleet): ``run_fleet`` installs a
    # shared-cache provider here before the simulator binds the policy.
    # Subclasses that construct an AlphaCache / PlacementCache in ``bind``
    # do so through the helpers below, so warm cache state — pure
    # functions of the cluster spec and the request key — is amortized
    # across a fleet's variants while all per-run state (queues, virtual
    # machine, allocations, degraded-bounds memos) stays per policy
    # instance.  ``None`` (the default) builds private caches: a lone
    # ``simulate()`` call is byte-for-byte the pre-fleet engine.
    fleet_shared = None

    def bind(self, cluster_spec: ClusterSpec) -> None:
        self.cluster_spec = cluster_spec

    def _make_alpha_cache(self, cluster_spec: ClusterSpec) -> "AlphaCache":
        fs = self.fleet_shared
        if fs is None:
            return AlphaCache(cluster_spec)
        return fs.alpha_cache(cluster_spec)

    def _make_placement_cache(
        self, cluster_spec: ClusterSpec, refine: bool = False
    ):
        fs = self.fleet_shared
        if fs is None:
            from .heavy_edge import PlacementCache  # avoid import cycle

            return PlacementCache(cluster_spec, refine=refine)
        return fs.placement_cache(cluster_spec, refine=refine)

    def set_predictor(self, predictor) -> None:
        """Swap the iteration predictor and re-derive ``track_overruns``.

        The policy-level perturbation hook
        (``Perturbation.perturb_policy``; see
        ``scenario.PredictionNoisePerturbation``) uses this to install a
        per-variant prediction model on a freshly constructed, not yet
        bound policy.
        """
        self.predictor = predictor
        self.track_overruns = bool(getattr(predictor, "track_overruns", False))

    def _n_pred(self, job: JobSpec) -> Optional[float]:
        """Predicted iterations to stamp on an :class:`Allocation` —
        ``None`` unless this policy tracks overruns (keeping legacy
        starts, and therefore the golden schedules, untouched)."""
        if not self.track_overruns:
            return None
        return float(self.predictor.predict(job))

    def on_overrun(self, t: float, job: JobSpec, elapsed_iters: float) -> float:
        """A watched job ran past its predicted completion: return the new
        predicted *remaining* iterations.  The default delegates to the
        predictor's ``reestimate(job, elapsed)`` (the prediction_loop
        backoff contract, returning a new predicted total) and falls back
        to plain doubling; the result is floored at one iteration so the
        re-estimation loop always advances.
        """
        re = getattr(self.predictor, "reestimate", None)
        if re is not None:
            new_total = float(re(job, elapsed_iters))
        else:
            new_total = max(elapsed_iters, 1.0) * 2.0
        return max(new_total - elapsed_iters, 1.0)

    def on_arrival(self, t: float, job: JobSpec) -> None:
        raise NotImplementedError

    def on_completion(self, t: float, job: JobSpec) -> None:
        pass

    def on_event(
        self, t: float, event: ClusterEvent, cluster: ClusterState
    ) -> None:
        """Cluster-event lifecycle hook: called for every scenario event
        at its timestamp, after the cluster state change applied (and
        for no-op events — e.g. a repeated speed factor — so policies
        see the full timeline).  Policies needing custom reactions
        (telemetry, learned schedulers re-planning on capacity churn)
        override this; the default relies on the epoch-based change
        tracking every pass already does.
        """

    def plan_pass(self, t: float, cluster: ClusterState) -> List[Allocation]:
        raise NotImplementedError

    def schedule(self, t: float, cluster: ClusterState) -> List[Allocation]:
        """Pre-protocol alias for ``plan_pass`` (the historical name)."""
        return self.plan_pass(t, cluster)

    def next_wakeup(self, t: float) -> Optional[float]:
        return None

    def plan_migrations(
        self, t: float, cluster: ClusterState, candidates: List["_Running"]
    ) -> List[Migration]:
        """Migration hook: while any job is running on degraded or
        draining capacity, called before every scheduling pass with
        those jobs as read-only views (so capacity freed by completions
        since the triggering event is still exploitable).  A migrating
        policy releases the old allocation, allocates the new placement,
        and returns a ``Migration`` per moved job (see migration.py);
        the default never migrates.  Only called when ``self.migrate``
        is truthy (non-migrating policies skip the watchlist bookkeeping
        entirely); never called on clean runs.
        """
        return []

    def plan_preemptions(
        self,
        t: float,
        cluster: ClusterState,
        candidates: List["_Running"],
        gpus_needed: int,
    ) -> List["_Running"]:
        """Serving-lane preemption hook: a request stream needs
        ``gpus_needed`` GPUs on one server for a replica and no server
        has them free.  ``candidates`` are the running training jobs
        (read-only views; dead-straddlers excluded).  Return victims in
        eviction order — the simulator preempts one at a time (release,
        ``on_preemption`` re-queue) and stops as soon as some server
        fits the replica, so order the cheapest evictions first.
        Unlike ``plan_migrations``, the policy must NOT release or
        allocate here — the simulator owns the eviction.  The default
        never preempts (request backlogs then wait for capacity).
        """
        return []

    def on_preemption(self, t: float, job: JobSpec) -> None:
        """A running job was evicted for a serving replica: re-queue it so
        a later ``plan_pass`` restarts it (the simulator resumes its
        remaining iterations after a checkpoint-restart penalty and
        counts the restart as a migration on its record).  Any policy
        returning victims from ``plan_preemptions`` must implement
        this — a dropped job fails the end-of-run completeness check.
        """
        raise NotImplementedError(
            f"{type(self).__name__} returned preemption victims but does "
            f"not implement on_preemption"
        )

    def migration_queue_head(self, t: float) -> Optional[JobSpec]:
        """Head of the policy's ready queue (the next job a pass would
        start), or None.  Consulted by the queue-aware migration race
        guard (migration.py): a checkpoint-restart claims free capacity
        that the queue head may deserve first.  The base returns None —
        policies without a visible queue never block migrations.
        """
        return None

    def queue_depth(self) -> int:
        """Jobs held by the policy (pending + delayed); for engine stats."""
        return 0


def simulate(
    jobs: Union[Scenario, List[JobSpec]],
    cluster_spec: Optional[Union[ClusterSpec, Policy]] = None,
    policy: Optional[Policy] = None,
    validate: bool = True,
    faults: Optional[Sequence[Tuple[float, int]]] = None,
    degradations: Optional[Sequence[Tuple[float, int, float]]] = None,
    stream: Optional[bool] = None,
) -> SimResult:
    """Run a policy over a scenario; returns per-job records + engine stats.

    Preferred form::

        simulate(scenario, policy)              # Scenario from scenario.py

    Legacy shim (bit-identical; builds the equivalent ``Scenario``)::

        simulate(jobs, cluster_spec, policy, faults=..., degradations=...)

    ``validate=False`` skips the per-start placement re-validation (safety
    net for policy bugs) — benchmarks use it; tests keep it on.

    ``stream`` selects the result backend: ``True`` folds completed
    records into incremental aggregates (``SimResult.records is None``;
    memory bounded by the live job count), ``False`` keeps the full
    per-job record dict.  The default (``None``) streams exactly when
    the scenario's jobs source is a lazy
    :class:`~repro.core.scenario.JobStream`.  Both backends produce the
    same metrics and ``schedule_digest`` bit-for-bit.

    ``faults``: (time, server_id) failure injections — sugar for
    :class:`Fault` events (capacity vanishes; GPUs held by running jobs
    are forfeited on release; the epoch bump wakes incremental policies).
    Jobs whose GPU demand exceeds the degraded capacity can never start;
    the end-of-run unfinished-jobs check reports them.

    ``degradations``: (time, server_id, speed_factor) straggler events —
    sugar for :class:`Degradation`.  ``factor`` in (0, 1) slows the
    server (compute + NIC stretch by ``1/factor``), 1.0 restores it,
    > 1.0 models a boost, and exactly 0.0 is a full failure.  Running
    jobs touching a ``factor > 0`` change are re-timed at the event and
    offered to ``policy.plan_migrations``; a repeated factor equal to
    the server's current speed is a no-op and triggers no scheduling
    pass, so an all-1.0 schedule is bit-identical to the clean run.

    Same-timestamp events apply in the scenario's canonical
    ``(t, server, kind, magnitude)`` order, not input order — see
    scenario.py for the documented tie-break.
    """
    if isinstance(jobs, Scenario):
        if faults is not None or degradations is not None:
            raise TypeError(
                "faults=/degradations= belong to the legacy signature; "
                "encode them as Scenario events instead"
            )
        if policy is not None and cluster_spec is not None:
            raise TypeError(
                "simulate(scenario, policy) takes no cluster spec — the "
                "scenario carries its own cluster"
            )
        pol = policy if policy is not None else cluster_spec
        if not isinstance(pol, Policy) and not isinstance(
            pol, SchedulingPolicy
        ):
            raise TypeError(
                f"simulate(scenario, policy): policy implementing "
                f"SchedulingPolicy required, got {type(pol).__name__}"
            )
        return _simulate_scenario(jobs, pol, validate, stream)
    if not isinstance(policy, Policy) and not isinstance(
        policy, SchedulingPolicy
    ):
        raise TypeError(
            f"simulate(jobs, cluster_spec, policy): policy implementing "
            f"SchedulingPolicy required, got {type(policy).__name__}"
        )
    scenario = scenario_from_legacy(
        jobs, cluster_spec, faults=faults, degradations=degradations
    )
    return _simulate_scenario(scenario, policy, validate, stream)


def _arrival_stream(src: JobStream, total_gpus: int):
    """Validate a lazy jobs source as it is pulled: the per-job GPU-demand
    check the materialized path runs upfront, plus fail-loud time
    ordering — a stream yielding out of arrival order would silently
    corrupt the event heap."""
    last = float("-inf")
    for job in src:
        if job.g > total_gpus:
            raise ValueError(
                f"job {job.job_id} needs {job.g} GPUs, cluster has "
                f"{total_gpus}"
            )
        if job.arrival < last:
            raise ValueError(
                f"job stream out of time order: job {job.job_id} arrives "
                f"at {job.arrival} after {last}"
            )
        last = job.arrival
        yield job


class _ServeLane:
    """Per-stream serving state: the lazy arrival iterator, the FIFO
    backlog of arrival timestamps (memory ∝ current backlog, never the
    stream length), and up to ``max_replicas`` replica slots (hosting
    server, in-flight batch)."""

    __slots__ = ("rs", "it", "queue", "servers", "batch", "idle",
                 "exhausted")

    def __init__(self, rs):
        self.rs = rs
        self.it = rs.arrivals()
        self.queue: deque = deque()  # arrival times awaiting dispatch
        self.servers: List[Optional[int]] = [None] * rs.max_replicas
        self.batch: List[Optional[List[float]]] = [None] * rs.max_replicas
        self.idle: List[int] = []  # allocated, no in-flight batch (sorted)
        self.exhausted = False  # arrival iterator consumed


class _ServeState:
    """Runtime for the serving lanes of one simulation.

    Requests and training jobs share the one :class:`ClusterState`:
    replicas allocate real GPUs under reserved negative allocation ids
    (job ids are >= 0), so every replica up scales training capacity
    down and vice versa.  Per lane the event loop batches the backlog onto
    idle replicas (batch = min(backlog, max_batch); service time from
    the stream's engine-calibrated curve), scales up — preempting
    comm-heavy training jobs through ``Policy.plan_preemptions`` when no
    server has room — while the projected queue-head latency exceeds
    half the SLO, and releases idle replicas beyond the first back to
    training (the last one once the lane drains).  Serve events trigger
    a policy scheduling pass only when cluster capacity actually changed
    — a million-request stream must not run a million passes.
    """

    def __init__(self, streams, cluster, policy, result, events, seq):
        self.lanes = [_ServeLane(rs) for rs in streams]
        self.cluster: ClusterState = cluster
        self.policy = policy
        self.result: SimResult = result
        self.events = events  # the event loop's heap (shared identity)
        self.seq = seq
        self.starved: set = set()  # lanes with a backlog and no replica
        self.resume: Dict[int, _Resume] = {}  # preempted jobs awaiting restart
        self.restart_penalty = float(
            getattr(policy, "migration_penalty", 0.0)
        )
        self._preempt = getattr(policy, "plan_preemptions", None)
        # bound by the event loop once its registries exist (bind_runtime)
        self.running: Dict[int, _Running] = {}
        self.records: Dict[int, JobRecord] = {}
        self.migration_watch: set = set()

    def bind_runtime(self, running, records, migration_watch) -> None:
        self.running = running
        self.records = records
        self.migration_watch = migration_watch

    def prime(self) -> None:
        """Arm one arrival event per lane (each re-arms the next on pop)."""
        for li, lane in enumerate(self.lanes):
            nxt = next(lane.it, None)
            if nxt is None:
                lane.exhausted = True
            else:
                heapq.heappush(
                    self.events,
                    (nxt, _CLUSTER, next(self.seq), _ReqArrival(li)),
                )

    def on_arrival(self, payload: _ReqArrival, t: float) -> bool:
        lane = self.lanes[payload.lane]
        lane.queue.append(t)
        nxt = next(lane.it, None)
        if nxt is None:
            lane.exhausted = True
        else:  # re-arm with the same payload object — one live per lane
            heapq.heappush(
                self.events, (nxt, _CLUSTER, next(self.seq), payload)
            )
        return self.dispatch(payload.lane, t)

    def on_batch_done(self, payload: _BatchDone, t: float) -> bool:
        lane = self.lanes[payload.lane]
        fold = self.result._fold_request
        slo = lane.rs.slo
        for arr in lane.batch[payload.replica]:
            fold(t - arr, slo)
        lane.batch[payload.replica] = None
        lane.idle.append(payload.replica)
        lane.idle.sort()
        changed = self.dispatch(payload.lane, t)
        return self._scale_down(payload.lane, t) or changed

    # -- dispatch -----------------------------------------------------------

    def dispatch(self, li: int, t: float) -> bool:
        """Feed idle replicas from the backlog; scale up when the backlog
        threatens the SLO.  Returns True when cluster capacity changed
        (the event loop then runs a scheduling pass)."""
        lane = self.lanes[li]
        rs = lane.rs
        changed = False
        while True:
            while lane.queue and lane.idle:
                ridx = lane.idle.pop(0)
                b = min(len(lane.queue), rs.max_batch)
                batch = [lane.queue.popleft() for _ in range(b)]
                lane.batch[ridx] = batch
                heapq.heappush(
                    self.events,
                    (
                        t + rs.service_time(b),
                        _CLUSTER,
                        next(self.seq),
                        _BatchDone(li, ridx),
                    ),
                )
            if not lane.queue:
                self.starved.discard(li)
                return changed
            n_rep = sum(1 for s in lane.servers if s is not None)
            if n_rep >= rs.max_replicas or not self._want_scale(
                lane, t, n_rep
            ):
                self.starved.discard(li)
                return changed
            server = self._find_server(rs.gpus)
            if server is None and self._preempt is not None:
                server = self._preempt_for(t, rs.gpus)
                if server is not None:
                    changed = True
            if server is None:
                # no capacity even after preemption: the backlog waits;
                # re-tried while starved at every live timestamp (training
                # completions free capacity without a serve event)
                if n_rep == 0:
                    self.starved.add(li)
                return changed
            ridx = lane.servers.index(None)
            self.cluster.allocate(
                self._aid(li, ridx), {}, counts={server: rs.gpus}
            )
            lane.servers[ridx] = server
            lane.idle.append(ridx)
            lane.idle.sort()
            changed = True
            # loop: the fresh replica takes a batch immediately

    def _aid(self, li: int, ridx: int) -> int:
        """Reserved allocation id for replica ``ridx`` of lane ``li`` —
        negative, so it can never collide with a job id (>= 0)."""
        return -1 - (li * self.lanes[li].rs.max_replicas + ridx)

    def _want_scale(self, lane: _ServeLane, t: float, n_rep: int) -> bool:
        """Scale-up trigger: projected queue-head latency (elapsed wait +
        full-batch rounds to drain the backlog at current width) beyond
        half the SLO — the half leaves the service time itself headroom."""
        if n_rep == 0:
            return True
        rs = lane.rs
        batches = -(-len(lane.queue) // rs.max_batch)  # ceil
        rounds = -(-batches // n_rep)  # ceil
        est = (t - lane.queue[0]) + rounds * rs.service_time(rs.max_batch)
        return est > 0.5 * rs.slo

    def _find_server(self, gpus: int) -> Optional[int]:
        """Most-free active server with >= ``gpus`` free (lowest id on
        ties) — consolidation would fragment training's multi-server
        placements for no serving benefit."""
        fb = self.cluster.free_buckets
        for c in range(len(fb) - 1, gpus - 1, -1):
            if fb[c]:
                return fb[c][0]
        return None

    def _preempt_for(self, t: float, gpus: int) -> Optional[int]:
        """Ask the policy for training victims and evict until a server
        fits a replica.  Victims are brought to ``t``, released, and
        re-queued via ``on_preemption``; their checkpoint
        (:class:`_Resume`) restarts them through a later ``plan_pass``.
        Returns the server that now fits, or None."""
        running = self.running
        if not running:
            return None
        down = self.cluster.downed_servers
        candidates = [
            r for r in running.values() if down.isdisjoint(r.placement)
        ]
        if not candidates:
            return None
        victims = self._preempt(t, self.cluster, candidates, gpus)
        server = None
        for r in victims:
            jid = r.job.job_id
            if jid not in running:
                continue
            if t > r.since:
                el = (t - r.since) / r.alpha
                r.iters_rem -= el
                if r.iters_rem < 0.0:
                    r.iters_rem = 0.0
                if r.pred_rem is not None:
                    r.pred_rem -= el
                    if r.pred_rem < 0.0:
                        r.pred_rem = 0.0
                r.since = t
            # epoch + 1 turns the in-heap completion stale; pred_epoch
            # carries over so stale prediction checks stay stale too
            self.resume[jid] = _Resume(
                r.iters_rem, r.epoch + 1, r.pred_epoch, self.records[jid]
            )
            self.cluster.release(jid)
            del running[jid]
            self.migration_watch.discard(jid)
            self.result.n_preemptions += 1
            self.policy.on_preemption(t, r.job)
            server = self._find_server(gpus)
            if server is not None:
                break
        return server

    def _scale_down(self, li: int, t: float) -> bool:
        """Release idle replicas beyond the first immediately; keep the
        last while the lane can still produce work (no alloc/release per
        lull), release it too once the lane drains."""
        lane = self.lanes[li]
        changed = False
        drained = (
            lane.exhausted
            and not lane.queue
            and all(b is None for b in lane.batch)
        )
        while lane.idle:
            n_rep = sum(1 for s in lane.servers if s is not None)
            if n_rep > 1 or drained:
                ridx = lane.idle.pop()
                self.cluster.release(self._aid(li, ridx))
                lane.servers[ridx] = None
                changed = True
            else:
                break
        return changed

    def unserved(self) -> int:
        return sum(len(lane.queue) for lane in self.lanes)


def _simulate_scenario(
    scenario: Scenario,
    policy: Policy,
    validate: bool,
    stream: Optional[bool] = None,
) -> SimResult:
    import time as _time

    jobs_src = scenario.jobs
    lazy = isinstance(jobs_src, JobStream)
    if stream is None:
        stream = lazy
    cluster_spec = scenario.cluster
    total_gpus = cluster_spec.total_gpus
    if lazy:
        arrivals = _arrival_stream(jobs_src, total_gpus)
    else:
        jobs = jobs_src
        for job in jobs:
            if job.g > total_gpus:
                raise ValueError(
                    f"job {job.job_id} needs {job.g} GPUs, cluster has "
                    f"{total_gpus}"
                )
        if any(
            jobs[i].arrival > jobs[i + 1].arrival
            for i in range(len(jobs) - 1)
        ):
            # the pre-streaming heap popped arrivals by (arrival, input
            # index); a stable sort by arrival reproduces that order
            # exactly for an unsorted tuple workload
            jobs = sorted(jobs, key=lambda j: j.arrival)
        arrivals = iter(jobs)
    policy.bind(cluster_spec)
    cluster = ClusterState(cluster_spec)
    result = SimResult()
    records = result.records  # job_id -> JobRecord (all jobs, materialized)
    if stream:
        # bounded working set: records holds only not-yet-completed jobs;
        # a completed record folds into the aggregates and is dropped
        result.records = None
        records = {}

    # DET003-allowlisted ([tool.detlint] _simulate_scenario): this
    # perf_counter
    # pair brackets the run for SimResult.wall_s / events_per_sec —
    # reported only, never folded into schedule decisions, completions,
    # or the schedule digest.
    wall0 = _time.perf_counter()
    seq = itertools.count()
    # (time, kind, seq-or-epoch, payload); kind breaks time ties
    # (completions/cluster events before arrivals before wakes), seq keeps
    # sorts stable.  Payload: (JobSpec, completion-epoch) for completions,
    # the JobSpec for arrivals, the typed ClusterEvent (or an internal
    # _DrainDeadline) for cluster events, None for wakes.  Scenario events
    # take consecutive seq numbers in their canonical order, so the
    # documented tie-break survives the heap.  Arrivals are *not*
    # pre-loaded: the main loop feeds them from the time-ordered iterator
    # as the clock reaches them, keeping the heap bounded by live events —
    # seq only breaks ties within one (t, kind), and same-t arrivals enter
    # in stream order, so pop order is identical to the pre-loaded heap.
    events: List[Tuple[float, int, int, object]] = []
    migrate_capable = bool(getattr(policy, "migrate", False))
    # Running-job bookkeeping is needed when anything can re-time a job
    # (factor > 0 degradations) or feed the migration watch (drain
    # windows, which only matter to migration-capable policies).  Clean
    # and fault-only runs skip the registry entirely (measured ~10-20%
    # of the cheap baselines' event cost at 5k jobs).  A prediction-loop
    # policy (track_overruns) needs the registry too: predicted-
    # completion checks live on _Running.pred_rem.
    track_overruns = bool(getattr(policy, "track_overruns", False))
    track_running = track_overruns
    # Serving lanes: request streams need the running-job
    # registry — preemption victims come from it.
    streams = scenario.request_streams
    if streams:
        track_running = True
    offer_migrations = False
    for ev in scenario.events:
        events.append((ev.t, _CLUSTER, next(seq), ev))
        kind = type(ev)
        if kind is Degradation and ev.factor > 0.0:
            track_running = True
            offer_migrations = migrate_capable
        elif (
            kind is ServerLeave
            and ev.drain_timeout > 0.0
            and migrate_capable
        ):
            track_running = True
            offer_migrations = True
    heapq.heapify(events)

    n_arrived = 0
    n_completed = 0
    n_events = 0
    peak_depth = 0
    n_passes = 0
    n_migrations = 0
    n_reestimates = 0
    # job_id -> live bookkeeping (placement, remaining iterations, the
    # epoch of the one non-stale completion event); see track_running.
    running: Dict[int, _Running] = {}
    # Jobs currently running on *risky* capacity — degraded (factor < 1)
    # or draining (ServerLeave window open): they are (re-)offered to
    # ``plan_migrations`` on every scheduling pass while the set is
    # non-empty — a saturated cluster often has nowhere to migrate *at*
    # the triggering event, but completions free capacity moments later.
    # Empty on clean runs (the hook is never called).
    migration_watch: set = set()
    # Single live wake: stale wake events carry an older epoch and are
    # dropped on pop without triggering a scheduling pass.
    wake_epoch = 0
    wake_time: Optional[float] = None
    # Per-server drain generation (see _DrainDeadline).
    drain_gen: Dict[int, int] = {}

    serve: Optional[_ServeState] = None
    if streams:
        serve = _ServeState(streams, cluster, policy, result, events, seq)
        serve.bind_runtime(running, records, migration_watch)
        serve.prime()

    heappop, heappush = heapq.heappop, heapq.heappush
    # Canonical pass entry is ``plan_pass``; a pre-protocol subclass that
    # only overrides ``schedule`` (the historical name) must still be
    # dispatched through its override, so bind through ``schedule``
    # exactly when it is overridden (zero extra indirection otherwise;
    # pure-protocol policies may not define ``schedule`` at all).
    cls_sched = getattr(type(policy), "schedule", None)
    if cls_sched is None or cls_sched is Policy.schedule:
        plan_pass = policy.plan_pass
    else:
        plan_pass = policy.schedule
    queue_depth = policy.queue_depth
    next_wakeup = policy.next_wakeup
    on_arrival = policy.on_arrival
    on_completion = policy.on_completion
    on_event = policy.on_event
    release = cluster.release
    on_overrun = getattr(policy, "on_overrun", None)

    def push_pred_check(r: _Running) -> None:
        """(Re-)arm the predicted-completion check for ``r``.

        Bumps ``pred_epoch`` first so any in-flight check is superseded
        even when no new one is pushed.  A check is observable only if
        the predicted completion precedes the true one
        (``pred_rem < iters_rem`` — both convert to time under the same
        alpha); otherwise the job physically completes first and a check
        would pop as a stale no-op, so it is elided.  Timed off
        ``since``, so a job inside a migration's restart window is
        checked only after the downtime, like its completion.
        """
        r.pred_epoch += 1
        if r.pred_rem is not None and r.pred_rem < r.iters_rem:
            heappush(
                events,
                (
                    r.since + r.pred_rem * r.alpha,
                    _CLUSTER,
                    next(seq),
                    _PredCheck(r.job.job_id, r.pred_epoch),
                ),
            )

    next_arrival = next(arrivals, None)
    while events or next_arrival is not None:
        # feed the heap every arrival at or before the earliest queued
        # event — the source is arrival-ordered, so nothing later can
        # precede the heap top; each push may lower the top, hence the
        # re-check against events[0]
        while next_arrival is not None and (
            not events or next_arrival.arrival <= events[0][0]
        ):
            heappush(
                events,
                (next_arrival.arrival, _ARRIVAL, next(seq), next_arrival),
            )
            n_arrived += 1
            next_arrival = next(arrivals, None)
        t = events[0][0]
        live = False  # any non-stale event at this timestamp?
        speed_changed: List[int] = []  # servers re-sped at t (factor > 0)
        downed: List[int] = []  # servers killed at t (fault/leave/deadline)
        while events and events[0][0] == t:
            _, kind, tag, payload = heappop(events)
            n_events += 1
            if kind == _COMPLETION:
                job, ep = payload
                if track_running:
                    r = running.get(job.job_id)
                    if r is None or ep != r.epoch:
                        continue  # superseded by a re-timing: stale entry
                    del running[job.job_id]
                    migration_watch.discard(job.job_id)
                release(job.job_id)
                on_completion(t, job)
                if stream:
                    result._fold(job.job_id, records.pop(job.job_id))
                n_completed += 1
                live = True
            elif kind == _ARRIVAL:
                on_arrival(t, payload)
                live = True
            elif kind == _CLUSTER:
                ev_kind = type(payload)
                if ev_kind is _ReqArrival:
                    # internal serve event: live only when cluster capacity
                    # changed (a million-request stream must not force a
                    # million scheduling passes)
                    if serve.on_arrival(payload, t):
                        live = True
                    continue
                if ev_kind is _BatchDone:
                    if serve.on_batch_done(payload, t):
                        live = True
                    continue
                if ev_kind is _PredCheck:
                    # A watched job reached its predicted completion while
                    # still running: bring the bookkeeping to t, ask the
                    # policy to re-estimate the remaining work, and re-arm
                    # the check at the new prediction.  The backoff
                    # contract (prediction_loop) makes consecutive checks
                    # geometrically spaced, so a job with n true
                    # iterations fires O(log n) of these no matter how
                    # wrong the initial prediction was.
                    r = running.get(payload.job_id)
                    if r is not None and payload.epoch == r.pred_epoch:
                        if t > r.since:
                            el = (t - r.since) / r.alpha
                            r.iters_rem -= el
                            if r.iters_rem < 0.0:
                                r.iters_rem = 0.0
                            r.pred_rem -= el
                            r.since = t
                        elapsed = r.job.n_iters - r.iters_rem
                        if on_overrun is None:
                            # protocol policy stamped n_pred but has no
                            # hook: plain doubling of the elapsed work
                            new_rem = max(elapsed, 1.0)
                        else:
                            new_rem = float(on_overrun(t, r.job, elapsed))
                        if new_rem <= 0.0:
                            # never trust a hook into a same-time loop
                            new_rem = 1.0
                        r.pred_rem = new_rem
                        n_reestimates += 1
                        push_pred_check(r)
                        live = True
                    continue  # internal event: no on_event call
                if ev_kind is _DrainDeadline:
                    # internal: the leave window closed — the server is
                    # down for good (jobs still on it finish in place and
                    # drop off the migration watch via the downed prune).
                    # A deadline from a superseded drain (cancelled by a
                    # join, window re-opened by a later leave) carries an
                    # older generation and is dropped.
                    if payload.gen == drain_gen.get(
                        payload.server
                    ) and cluster.finish_drain(payload.server):
                        if track_running:
                            downed.append(payload.server)
                        live = True
                    continue  # not a scenario event: no on_event call
                if ev_kind is Fault or (
                    ev_kind is Degradation and payload.factor == 0.0
                ):
                    # full failure: the fault path verbatim (capacity
                    # forfeited; running jobs finish in place, un-re-timed)
                    cluster.mark_server_down(payload.server)
                    if track_running:
                        downed.append(payload.server)
                    live = True
                elif ev_kind is Degradation:
                    if cluster.set_server_speed(
                        payload.server, payload.factor
                    ):
                        speed_changed.append(payload.server)
                        live = True
                    # else: factor equals the current speed — a no-op
                    # (neither re-timing nor a scheduling pass; keeps
                    # all-1.0 degradation schedules identical to clean)
                elif ev_kind is ServerLeave:
                    if payload.drain_timeout <= 0.0:
                        # immediate leave == the fault path (property-
                        # tested); the slot stays rejoinable via ServerJoin
                        cluster.mark_server_down(payload.server)
                        if track_running:
                            downed.append(payload.server)
                        live = True
                    elif cluster.drain_server(payload.server):
                        live = True
                        m = payload.server
                        gen = drain_gen.get(m, 0) + 1
                        drain_gen[m] = gen
                        if offer_migrations:
                            down = cluster.downed_servers
                            for jid, r in running.items():
                                # dead-straddlers can't checkpoint-restart
                                # (state on the dead server is gone)
                                if m in r.placement and down.isdisjoint(
                                    r.placement
                                ):
                                    migration_watch.add(jid)
                        if payload.drain_timeout != float("inf"):
                            heappush(
                                events,
                                (
                                    t + payload.drain_timeout,
                                    _CLUSTER,
                                    next(seq),
                                    _DrainDeadline(m, gen),
                                ),
                            )
                elif ev_kind is ServerJoin:
                    if cluster.activate_server(payload.server):
                        live = True
                        if migration_watch:
                            # a join cancelling a drain un-risks the
                            # server: drop watched jobs that no longer
                            # touch degraded or draining capacity
                            sp = cluster.speed_factors
                            dr = cluster.draining_servers
                            # sorted() by job id (DET001): discard-only
                            # loop, but set order must never become an
                            # observable sequence
                            for jid in sorted(migration_watch):
                                p = running[jid].placement
                                if (
                                    not sp or sp.keys().isdisjoint(p)
                                ) and (not dr or dr.isdisjoint(p)):
                                    migration_watch.discard(jid)
                else:
                    # custom ClusterEvent subclass: no engine-side state
                    # change — it reaches the policy via on_event (the
                    # extensibility point), and triggers a pass so the
                    # policy's reaction can schedule immediately
                    live = True
                on_event(t, payload, cluster)
            else:  # _WAKE: no state change; just triggers a scheduling pass.
                if tag == wake_epoch:
                    wake_time = None
                    live = True
                # else: superseded wake — ignore.
        if not live:
            continue

        if serve is not None and serve.starved:
            # replica-less backlogs retry on any live timestamp: training
            # completions free capacity without raising a serve event, and
            # the replica must claim GPUs before the scheduling pass below
            # hands them to queued training jobs
            for li in sorted(serve.starved):
                serve.dispatch(li, t)

        if downed and migration_watch:
            # A job whose placement touches a *dead* server can never
            # checkpoint-restart (its checkpoint state lived there): drop
            # it from the watch — it finishes in place, as after a fault.
            dead = set(downed)
            # sorted() by job id (DET001): discard-only loop, but set
            # order must never become an observable sequence
            for jid in [
                j for j in sorted(migration_watch)
                if not dead.isdisjoint(running[j].placement)
            ]:
                migration_watch.discard(jid)

        if speed_changed:
            # Re-time every running job touching a re-sped server under the
            # final (post-drain) speed map; jobs left on degraded capacity
            # join the migration watchlist.
            changed = set(speed_changed)
            speeds = cluster.speed_factors
            down = cluster.downed_servers
            draining = cluster.draining_servers
            for jid, r in running.items():
                if changed.isdisjoint(r.placement):
                    continue
                if not down.isdisjoint(r.placement):
                    # straddles a dead server: it finishes in place at its
                    # last re-timed alpha (the fault path).  Re-timing here would
                    # evaluate the dead server at full speed — its _speed
                    # entry died with it — shrinking the completion.
                    continue
                if t > r.since:
                    el = (t - r.since) / r.alpha
                    r.iters_rem -= el
                    if r.iters_rem < 0.0:
                        r.iters_rem = 0.0
                    if r.pred_rem is not None:
                        r.pred_rem -= el
                        if r.pred_rem < 0.0:
                            r.pred_rem = 0.0
                    r.since = t
                a_new = timing.alpha(
                    r.job, r.placement, cluster_spec,
                    speeds=speeds or None,
                )
                if a_new != r.alpha:
                    r.alpha = a_new
                    r.epoch += 1
                    # r.since == t normally; for a job still inside a
                    # migration's restart window (since > t) the pending
                    # downtime is preserved, not re-counted as progress
                    completion = r.since + r.iters_rem * a_new
                    rec = records[jid]
                    rec.alpha = a_new
                    rec.completion = completion
                    heappush(
                        events,
                        (completion, _COMPLETION, next(seq), (r.job, r.epoch)),
                    )
                    if r.pred_rem is not None:
                        # the in-flight check was timed under the old
                        # alpha: supersede and re-arm it
                        push_pred_check(r)
                # (dead-straddlers never reach here — the `continue`
                # above — so no downed-server check is needed)
                if offer_migrations and (
                    (speeds and not speeds.keys().isdisjoint(r.placement))
                    or (
                        draining
                        and not draining.isdisjoint(r.placement)
                    )
                ):
                    migration_watch.add(jid)
                else:
                    migration_watch.discard(jid)

        if migration_watch:
            speeds = cluster.speed_factors
            draining = cluster.draining_servers
            if not speeds and not draining:
                # every watched job's risk resolved: stragglers recovered
                # or died (a downed server's jobs finish in place at their
                # last re-timed alpha, as after a fault) and drain windows closed
                migration_watch.clear()
            else:
                risky = set(speeds)
                risky.update(draining)
                candidates: List[_Running] = []
                for jid in sorted(migration_watch):
                    r = running[jid]
                    if t > r.since:
                        # bring remaining-iteration bookkeeping to t so the
                        # stay-vs-move race compares current quantities
                        # (no check re-arm needed: alpha is unchanged, so
                        # the in-flight check's timestamp stays valid)
                        el = (t - r.since) / r.alpha
                        r.iters_rem -= el
                        if r.iters_rem < 0.0:
                            r.iters_rem = 0.0
                        if r.pred_rem is not None:
                            r.pred_rem -= el
                            if r.pred_rem < 0.0:
                                r.pred_rem = 0.0
                        r.since = t
                    candidates.append(r)
                for mig in policy.plan_migrations(t, cluster, candidates):
                    job = mig.job
                    if validate:
                        timing.validate_placement(job, mig.placement)
                    r = running[job.job_id]
                    r.placement = mig.placement
                    r.alpha = mig.alpha
                    r.epoch += 1
                    # computing resumes only after the restart downtime;
                    # parking ``since`` there keeps later re-timings from
                    # crediting the penalty window as iterations done
                    r.since = t + mig.penalty
                    completion = r.since + r.iters_rem * mig.alpha
                    rec = records[job.job_id]
                    rec.alpha = mig.alpha
                    rec.completion = completion
                    rec.servers = tuple(sorted(mig.placement))
                    rec.migrations += 1
                    n_migrations += 1
                    heappush(
                        events,
                        (completion, _COMPLETION, next(seq), (job, r.epoch)),
                    )
                    if r.pred_rem is not None:
                        # new alpha + restart downtime: supersede and
                        # re-arm the predicted-completion check
                        push_pred_check(r)
                    if risky.isdisjoint(mig.placement):
                        migration_watch.discard(job.job_id)

        for start in plan_pass(t, cluster):
            job = start.job
            if validate:
                timing.validate_placement(job, start.placement)
            res = (
                serve.resume.pop(job.job_id, None)
                if serve is not None and serve.resume
                else None
            )
            if res is None:
                ep = 0
                iters = float(job.n_iters)
                since = t
                completion = t + job.n_iters * start.alpha
                records[job.job_id] = JobRecord(
                    arrival=job.arrival,
                    start=t,
                    completion=completion,
                    alpha=start.alpha,
                    # placements never carry empty per-server vectors, so
                    # the touched servers are exactly the placement keys
                    servers=tuple(sorted(start.placement)),
                )
            else:
                # preemption restart: remaining iterations resume after
                # the checkpoint-restart downtime; the original record
                # keeps its first start and counts the restart as a
                # migration.  The carried epoch outdates the stale
                # pre-preemption completion still in the heap.
                ep = res.epoch
                iters = res.iters_rem
                since = t + serve.restart_penalty
                completion = since + iters * start.alpha
                rec = res.rec
                rec.alpha = start.alpha
                rec.completion = completion
                rec.servers = tuple(sorted(start.placement))
                rec.migrations += 1
                records[job.job_id] = rec
            if track_running:
                n_pred = start.n_pred
                running[job.job_id] = r = _Running(
                    job=job,
                    placement=start.placement,
                    alpha=start.alpha,
                    iters_rem=iters,
                    since=since,
                    epoch=ep,
                    pred_rem=(None if n_pred is None else float(n_pred)),
                    pred_epoch=(0 if res is None else res.pred_epoch),
                )
                if r.pred_rem is not None:
                    # arm the predicted-completion watch; a 0-predicted
                    # (unseen) job fires it at t itself — the outer loop
                    # re-pops the same timestamp, the backoff re-estimate
                    # raises pred_rem to >= one iteration, and the job
                    # proceeds without starving anyone (physical
                    # completion uses the true n_iters regardless)
                    push_pred_check(r)
                # a job *started* onto degraded capacity (a straggler can
                # still hold the most free GPUs) is as migratable as one
                # caught there by the event; placements never touch downed
                # or draining servers (zero free), so neither needs a check
                if offer_migrations:
                    sp = cluster.speed_factors
                    if sp and not sp.keys().isdisjoint(start.placement):
                        migration_watch.add(job.job_id)
            heappush(events, (completion, _COMPLETION, next(seq), (job, ep)))
        n_passes += 1
        depth = queue_depth()
        if depth > peak_depth:
            peak_depth = depth

        wake = next_wakeup(t)
        if wake is not None and wake > t and wake != wake_time:
            wake_epoch += 1
            wake_time = wake
            heappush(events, (wake, _WAKE, wake_epoch, None))

    if n_completed != n_arrived:
        missing = n_arrived - n_completed
        raise RuntimeError(f"simulation ended with {missing} unfinished jobs")
    if serve is not None and serve.unserved():
        raise RuntimeError(
            f"simulation ended with {serve.unserved()} unserved requests "
            f"(no replica could ever be placed — check stream gpus vs "
            f"cluster capacity)"
        )
    result.n_jobs = n_completed
    result.n_events = n_events
    result.n_sched_passes = n_passes
    result.peak_queue_depth = peak_depth
    result.n_migrations = n_migrations
    result.n_reestimates = n_reestimates
    # DET003-allowlisted: wall_s lands after every record/digest above
    # is final (see the matching comment at wall0)
    result.wall_s = _time.perf_counter() - wall0
    return result


# ---------------------------------------------------------------------------
# Shared helpers: per-config alpha bounds cache
# ---------------------------------------------------------------------------


class AlphaCache:
    """alpha_max / alpha-tilde_min per unique (stages, allreduce) config.

    ``bounds(job)`` answers the *clean*-cluster bounds (cached per
    config).  ``bounds(job, cluster)`` with a degraded live
    :class:`ClusterState` folds the current per-server speed factors in
    (the straggler case):

    * ``alpha_max`` — the spread worst case must cover a lone replica
      landing on a straggler: for every *allocatable* degraded server
      (not down, not draining) the per-class spread bound is stretched
      by ``1/factor`` (degradation divides the whole per-stage time —
      compute and NIC alike — by the factor; see cluster.py), and the
      worst such value joins the clean bound in the max.
    * ``alpha_min_tilde`` — the consolidated best case divides by the
      best allocatable factor: a fully-degraded cluster (no clean
      server left) can do no better than its fastest straggler, while a
      boosted server (factor > 1) improves the estimate.

    A heavily degraded cluster therefore *raises* ``a_max/a_min`` and
    can flip a borderline job into the comm-heavy class — admission
    then consolidates/delays it instead of spreading it across
    stragglers on clean-cluster assumptions.  The per-instance
    ``(cluster epoch, speed version)`` signature only gates the
    O(num_servers) active-server *scan*; the degraded answers themselves
    are memoized content-addressed — keyed by the sorted multiset of
    allocatable ``(class, factor)`` stragglers, the best factor, and the
    job config — because the fold below is a pure function of exactly
    that key.  Content addressing is what lets
    :class:`~repro.core.fleet.FleetShared` alias one degraded memo
    across every variant of a fleet (so a fleet shares what one run folds):
    two variants hitting the same straggler state — common under
    shared samplers — reuse each other's folds, and entries survive
    signature churn *within* a run (degrade -> recover -> re-degrade
    re-hits the memo instead of recomputing).  Clean clusters never
    touch any of this path.
    """

    def __init__(self, cluster_spec: ClusterSpec):
        self.spec = cluster_spec
        self._cache: Dict[int, Tuple[float, float]] = {}
        # degradation-aware state: per-(config, class) spread bounds,
        # the per-signature scan memo, and the content-addressed degraded
        # answers (shareable across fleet variants; never cleared)
        self._class_amax: Dict[Tuple[int, int], float] = {}
        self._deg_sig: Optional[Tuple[int, int]] = None
        self._deg_cache: Dict[tuple, Tuple[float, float]] = {}
        self._deg_active: Tuple[Tuple[int, float], ...] = ()
        self._deg_best: float = 1.0

    def bounds(
        self, job: JobSpec, cluster: Optional[ClusterState] = None
    ) -> Tuple[float, float]:
        """Returns (alpha_max, alpha_min_tilde); degradation-aware when a
        degraded live ``cluster`` is passed."""
        if cluster is not None and cluster.has_degraded:
            return self._degraded_bounds(job, cluster)
        key = job.config_key
        hit = self._cache.get(key)
        if hit is None:
            from . import heavy_edge as he  # local import to avoid cycle

            a_max = timing.alpha_max(job, self.spec)
            a_min = he.alpha_min_estimate(job, self.spec)
            # The consolidated estimate can only be <= the all-spread bound.
            a_max = max(a_max, a_min)
            hit = (a_max, a_min)
            self._cache[key] = hit
        return hit

    def _class_alpha_max(self, job: JobSpec, cls: int) -> float:
        key = (job.config_key, cls)
        v = self._class_amax.get(key)
        if v is None:
            g, b_inter, _b_intra = self.spec.class_geom(cls)
            v = timing.alpha_max(job, self.spec, nic_share=b_inter / g)
            self._class_amax[key] = v
        return v

    def _degraded_bounds(
        self, job: JobSpec, cluster: ClusterState
    ) -> Tuple[float, float]:
        sig = (cluster.epoch, cluster.speed_version)
        if sig != self._deg_sig:
            self._deg_sig = sig
            sp = cluster.speed_factors
            down = cluster.downed_servers
            drain = cluster.draining_servers
            spec = self.spec
            active: List[Tuple[int, float]] = []
            best = 0.0
            any_clean = False
            for m in range(spec.num_servers):
                if m in down or m in drain:
                    continue  # takes no new allocations: not admission-visible
                f = sp.get(m)
                if f is None:
                    any_clean = True
                else:
                    active.append((spec.class_of(m), f))
                    if f > best:
                        best = f
            if any_clean and best < 1.0:
                best = 1.0
            # sorted: the fold is order-independent (a max over per-class
            # stretches), so two clusters with the same straggler multiset
            # share memo entries regardless of which server ids degraded
            self._deg_active = tuple(sorted(active))
            self._deg_best = best
        if not self._deg_active and self._deg_best >= 1.0:
            # every straggler is down or draining: new placements can only
            # land on clean capacity, so the clean bounds apply verbatim
            return self.bounds(job)
        key = (self._deg_active, self._deg_best, job.config_key)
        hit = self._deg_cache.get(key)
        if hit is None:
            a_max, a_min = self.bounds(job)  # clean baseline (cached)
            for cls, f in self._deg_active:
                v = self._class_alpha_max(job, cls) / f
                if v > a_max:
                    a_max = v
            if self._deg_best > 0.0:
                a_min = a_min / self._deg_best
            a_max = max(a_max, a_min)
            hit = (a_max, a_min)
            self._deg_cache[key] = hit
        return hit
