"""First-class scenarios: one composable, serializable cluster-event stream.

The paper's A-SRPT is an *online* algorithm — its value is reacting to an
arbitrary event stream.  Before this module the simulator grew one ad-hoc
keyword per scenario kind (``faults=``, then
``degradations=``); every new scenario (elastic capacity, maintenance drains, serving
bursts) would have added another.  A :class:`Scenario` instead bundles

* the workload (``jobs`` — a time-ordered tuple of :class:`JobSpec`, or
  a lazy :class:`JobStream` for bounded-memory million-job replays),
* the cluster it runs on (a :class:`ClusterSpec`), and
* a single time-ordered timeline of typed :class:`ClusterEvent` s,

so adding a scenario kind means adding an *event type*, not a simulator
parameter.  ``simulate(scenario, policy)`` is the one entry point
(simulator.py); the legacy ``simulate(jobs, spec, faults=...,
degradations=...)`` signature survives as a thin shim that builds a
``Scenario`` and is property-tested bit-identical (tests/test_scenario.py).

Event types
-----------

``Fault(t, server)``
    Full failure: free capacity vanishes at ``t``; GPUs held by running
    jobs are forfeited as those jobs release; running jobs finish in
    place (the fault path).  Identical to ``Degradation(t, server, 0.0)``.

``Degradation(t, server, factor)``
    Straggler event: the server's effective compute/NIC speed is scaled
    by ``factor``.  ``factor`` in (0, 1) slows, 1.0 recovers,
    > 1.0 boosts, exactly 0.0 is a ``Fault``.

``ServerLeave(t, server, drain_timeout)``
    Elastic capacity: the server begins leaving at ``t``.  No new
    allocations from ``t`` on; capacity is forfeited as running jobs
    release.  ``drain_timeout`` is the graceful-drain window: while it
    is open, jobs still running on the server are offered to
    ``Policy.plan_migrations`` (checkpoint-restart off the leaving
    server); at ``t + drain_timeout`` the server is gone for good
    (remaining jobs finish in place, as after a fault).  ``drain_timeout=0``
    degrades to the ``Fault`` path verbatim (property-tested);
    ``float("inf")`` keeps the drain window open forever.

``ServerJoin(t, server)``
    Elastic capacity: server ``server`` (a spec slot that previously
    left, failed, or never came up) comes online at ``t`` with its
    class capacity.  The epoch bump wakes settled policies so queued
    work starts immediately.  A server absent *from the start* is
    expressed as ``ServerLeave(0.0, m)`` — the spec stays the full
    universe of slots.

Canonical event order (the tie-break bugfix)
--------------------------------------------

Same-timestamp events used to apply in input-sequence order (faults
before degradations, each list in caller order) — an accident of the
legacy keywords.  ``Scenario`` instead stores its timeline canonically
sorted by ``(t, server, kind, magnitude)`` with kind ranked

    ServerJoin < Degradation < ServerLeave < Fault

so at one instant, per server: capacity arrives first, speed changes
apply next, and removals win the instant (a fault overrides a
same-instant degradation).  Ties within a kind order by magnitude
(``factor`` / ``drain_timeout``) ascending.  The order is deterministic
for any input permutation — schedules no longer depend on how the
caller happened to interleave event lists (tests/test_scenario.py pins
this).

JSON schema (versions 1 and 2)
------------------------------

``Scenario.to_json()`` / ``Scenario.from_json()`` round-trip the whole
scenario; ``Scenario.from_json(s.to_json()) == s`` and a round-tripped
scenario replays a byte-identical schedule (property-tested).  Version 2
adds one optional section, ``"request_streams"`` — serving
workloads (see :class:`RequestStream`), each tagged ``"kind":
"request-stream"`` with the same strict unknown-field/unknown-kind
deserialization as events.  A scenario without request streams still
serializes as version 1 with no ``"request_streams"`` key, so every
pre-serving document — the golden fixtures included — round-trips byte
for byte; ``from_dict`` reads both versions and rejects
``request_streams`` under a version-1 declaration.  Layout::

    {
      "schema": 1,
      "name": "<free-form label>",
      "cluster": {
        "num_servers": 8, "gpus_per_server": 4,
        "b_inter": 1.25e9, "b_intra": 3e11,
        // heterogeneous specs instead carry the class list:
        "server_classes": [
          {"count": 3, "gpus_per_server": 8, "b_inter": 1.25e10,
           "b_intra": 0.0, "name": "gen-a"}, ...
        ]
      },
      "jobs": [ <job>, ... ],      // time-ordered
      "events": [ <event>, ... ]   // canonical order (see above)
    }

A ``<job>`` is the frozen-trace format ``tests/golden/trace.json``
already uses (that file is a documented instance of the ``jobs`` array)::

    {"job_id": 0, "n_iters": 37, "arrival": 12.5, "group_id": 3,
     "user_id": 7, "allreduce": "rar", "model_name": "qwen3_32b",
     "stages": [[p_f, p_b, d_in, d_out, h, k], ...]}

An ``<event>`` carries its kind tag plus the per-kind fields::

    {"kind": "fault", "t": 600.0, "server": 0}
    {"kind": "degradation", "t": 400.0, "server": 1, "factor": 0.25}
    {"kind": "leave", "t": 900.0, "server": 2, "drain_timeout": 120.0}
    {"kind": "join",  "t": 1200.0, "server": 2}

``drain_timeout`` serializes ``float("inf")`` as JSON ``null`` (strict
JSON has no Infinity).  Unknown kinds or fields fail ``from_dict`` with
a ``ValueError`` naming the offender — the schema is versioned via the
top-level ``"schema"`` integer, bumped on incompatible change.

CLI: ``python -m repro.core.scenario validate FILE`` checks a scenario
file against the schema; ``validate-jobs FILE`` checks a bare jobs
array (e.g. ``tests/golden/trace.json``).  CI runs both plus an
end-to-end replay via ``benchmarks/sched_scale.py --scenario``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Type,
    Union,
)

from .job import ClusterSpec, JobSpec, ServerClass, StageSpec
from ..serve.latency import DEFAULT_SERVE_MODEL

# Version 2 added the optional "request_streams" section (serving
# workloads).  ``to_dict`` still emits version 1 for scenarios
# without request streams — version-1 documents (all golden fixtures,
# every pre-serving scenario file) round-trip byte-identical — and
# ``from_dict`` reads both.
SCENARIO_SCHEMA_VERSION = 2
_READABLE_SCHEMAS = (1, 2)

# Frozen-trace job layout (tests/golden/trace.json is an instance).
_STAGE_FIELDS = ("p_f", "p_b", "d_in", "d_out", "h", "k")
_JOB_FIELDS = (
    "job_id", "n_iters", "arrival", "group_id", "user_id", "allreduce",
    "model_name",
)
_CLASS_FIELDS = ("count", "gpus_per_server", "b_inter", "b_intra", "name")


# ---------------------------------------------------------------------------
# Typed cluster events
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClusterEvent:
    """One timed change to the cluster, applied just before the scheduling
    pass at ``t`` (all same-timestamp events drain first — simulator.py)."""

    t: float
    server: int

    def __post_init__(self) -> None:
        # `not (x >= 0)` rejects NaN as well as negatives: json.load
        # happily parses NaN/Infinity, and a NaN time would silently
        # corrupt the simulator's event-heap ordering
        if not (self.t >= 0.0 and math.isfinite(self.t)):
            raise ValueError(f"event time must be finite >= 0, got {self.t}")
        if self.server < 0:
            raise ValueError(f"server id must be >= 0, got {self.server}")


@dataclass(frozen=True)
class Fault(ClusterEvent):
    """Full server failure (== ``Degradation(factor=0.0)``); the fault path."""


@dataclass(frozen=True)
class Degradation(ClusterEvent):
    """Speed change: effective compute/NIC scale by ``factor``."""

    factor: float = 1.0

    def __post_init__(self) -> None:
        super().__post_init__()
        if not (self.factor >= 0.0 and math.isfinite(self.factor)):
            raise ValueError(
                f"speed factor must be finite >= 0, got {self.factor}"
            )


@dataclass(frozen=True)
class ServerJoin(ClusterEvent):
    """Elastic capacity: the server slot comes online with class caps."""


@dataclass(frozen=True)
class ServerLeave(ClusterEvent):
    """Elastic capacity: graceful drain; ``drain_timeout=0`` == ``Fault``."""

    drain_timeout: float = 0.0

    def __post_init__(self) -> None:
        super().__post_init__()
        # inf is legal (open-ended window); NaN and negatives are not
        if not self.drain_timeout >= 0.0:
            raise ValueError(
                f"drain_timeout must be >= 0, got {self.drain_timeout}"
            )


# Canonical same-timestamp order (see module docstring): joins first,
# then speed changes, removals win the instant.
_KIND_RANK: Dict[type, int] = {
    ServerJoin: 0,
    Degradation: 1,
    ServerLeave: 2,
    Fault: 3,
}
_KIND_TAG: Dict[type, str] = {
    Fault: "fault",
    Degradation: "degradation",
    ServerJoin: "join",
    ServerLeave: "leave",
}
_TAG_KIND: Dict[str, type] = {v: k for k, v in _KIND_TAG.items()}


def event_sort_key(ev: ClusterEvent) -> Tuple[float, int, int, float]:
    """Total order over events: ``(t, server, kind rank, magnitude)``.

    Custom :class:`ClusterEvent` subclasses (policy-defined events that
    reach ``Policy.on_event`` without engine-side state changes) rank
    after the built-ins at one ``(t, server)``.
    """
    kind = type(ev)
    if kind is Degradation:
        mag = ev.factor
    elif kind is ServerLeave:
        mag = ev.drain_timeout
    else:
        mag = 0.0
    return (ev.t, ev.server, _KIND_RANK.get(kind, len(_KIND_RANK)), mag)


def event_to_dict(ev: ClusterEvent) -> dict:
    kind = type(ev)
    tag = _KIND_TAG.get(kind)
    if tag is None:
        raise ValueError(
            f"only built-in event kinds serialize (schema "
            f"{SCENARIO_SCHEMA_VERSION}); {kind.__name__} is "
            f"policy-defined — keep such scenarios in-process"
        )
    d: dict = {"kind": tag, "t": ev.t, "server": ev.server}
    if kind is Degradation:
        d["factor"] = ev.factor
    elif kind is ServerLeave:
        # strict JSON has no Infinity: an open-ended drain window is null
        d["drain_timeout"] = (
            None if ev.drain_timeout == float("inf") else ev.drain_timeout
        )
    return d


# Per-kind fields beyond the common (kind, t, server) — from_dict rejects
# anything else, so a typo'd field (e.g. "drain_timout") fails loudly
# instead of silently taking the default.
_KIND_EXTRA_FIELDS: Dict[str, frozenset] = {
    "fault": frozenset(),
    "degradation": frozenset({"factor"}),
    "join": frozenset(),
    "leave": frozenset({"drain_timeout"}),
}


def event_from_dict(d: Mapping) -> ClusterEvent:
    try:
        tag = d["kind"]
    except KeyError:
        raise ValueError(f"event missing 'kind': {d!r}") from None
    kind: Optional[Type[ClusterEvent]] = _TAG_KIND.get(tag)
    if kind is None:
        raise ValueError(
            f"unknown event kind {tag!r} (schema {SCENARIO_SCHEMA_VERSION} "
            f"knows {sorted(_TAG_KIND)})"
        )
    unknown = set(d) - {"kind", "t", "server"} - _KIND_EXTRA_FIELDS[tag]
    if unknown:
        raise ValueError(
            f"event {tag!r} has unknown field(s) {sorted(unknown)}: {d!r}"
        )
    try:
        t, server = float(d["t"]), int(d["server"])
    except KeyError as exc:
        raise ValueError(f"event {tag!r} missing field {exc}") from None
    if kind is Degradation:
        try:
            return Degradation(t, server, factor=float(d["factor"]))
        except KeyError:
            raise ValueError(
                f"degradation event missing 'factor': {d!r}"
            ) from None
    if kind is ServerLeave:
        timeout = d.get("drain_timeout", 0.0)
        return ServerLeave(
            t, server,
            drain_timeout=float("inf") if timeout is None else float(timeout),
        )
    return kind(t, server)


# ---------------------------------------------------------------------------
# Request streams (schema v2): recurring serving workloads on the timeline
# ---------------------------------------------------------------------------


REQUEST_STREAM_KIND = "request-stream"

# Required fields have no safe default (a stream without a rate or an SLO
# is meaningless); the rest default like the dataclass so hand-written
# scenario files stay terse.  ``to_dict`` always writes every field —
# the serving defaults (the calibrated latency curve) may be refreshed,
# and a committed scenario must replay identically across refreshes.
_STREAM_REQUIRED = ("stream_id", "rate", "duration", "slo")
_STREAM_OPTIONAL = (
    "start", "diurnal_amplitude", "diurnal_period", "phase", "gpus",
    "max_replicas", "max_batch", "svc_base", "svc_per_req", "seed",
)
_STREAM_FIELDS = _STREAM_REQUIRED + _STREAM_OPTIONAL
_ARRIVAL_CHUNK = 4096  # rng draws per block (amortizes Generator overhead)


@dataclass(frozen=True)
class RequestStream:
    """A recurring serving workload: Poisson request arrivals (optionally
    diurnally modulated) with a per-request SLO deadline, co-scheduled
    with training jobs on the same cluster.

    Arrivals are a nonhomogeneous Poisson process at instantaneous rate
    ``rate_at(t) = rate * (1 + diurnal_amplitude * sin(2*pi*(t - start)
    / diurnal_period + phase))`` over ``[start, start + duration)`` —
    ``diurnal_amplitude = 0`` (the default) is plain Poisson at
    ``rate`` req/s.  :meth:`arrivals` generates the timestamps lazily
    (thinning against the peak rate, chunked rng draws), so
    million-request streams never materialize; the draw is a pure
    function of ``(seed, stream_id)``.

    Requests are served by *replicas* — ``gpus`` GPUs on one server,
    allocated out of the same :class:`~repro.core.cluster.ClusterState`
    training jobs use — which batch up to ``max_batch`` queued requests
    and take ``service_time(b) = svc_base + svc_per_req * b`` seconds
    per batch.  The service defaults come from the committed
    engine-calibrated curve
    (:data:`repro.serve.latency.DEFAULT_SERVE_MODEL`); a request meets
    its SLO when completion - arrival <= ``slo``.  The simulator scales
    replicas up to ``max_replicas`` (preempting comm-heavy training
    jobs via ``Policy.plan_preemptions`` when the cluster is full) and
    releases idle ones back to training — see simulator.py.
    """

    stream_id: int
    rate: float
    duration: float
    slo: float
    start: float = 0.0
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 86_400.0
    phase: float = 0.0
    gpus: int = 1
    max_replicas: int = 1
    max_batch: int = 8
    svc_base: float = DEFAULT_SERVE_MODEL.batch_base
    svc_per_req: float = DEFAULT_SERVE_MODEL.batch_per_req
    seed: int = 0

    def __post_init__(self) -> None:
        if self.stream_id < 0:
            raise ValueError(f"stream_id must be >= 0, got {self.stream_id}")
        if not (self.rate > 0.0 and math.isfinite(self.rate)):
            raise ValueError(f"rate must be finite > 0, got {self.rate}")
        if not (self.duration > 0.0 and math.isfinite(self.duration)):
            raise ValueError(
                f"duration must be finite > 0, got {self.duration}"
            )
        if not (self.slo > 0.0 and math.isfinite(self.slo)):
            raise ValueError(f"slo must be finite > 0, got {self.slo}")
        if not (self.start >= 0.0 and math.isfinite(self.start)):
            raise ValueError(
                f"start must be finite >= 0, got {self.start}"
            )
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            # amplitude 1 would zero the instantaneous rate (and < 0
            # flips the phase); keep the modulation strictly positive
            raise ValueError(
                f"diurnal_amplitude must be in [0, 1), got "
                f"{self.diurnal_amplitude}"
            )
        if not (self.diurnal_period > 0.0 and math.isfinite(self.diurnal_period)):
            raise ValueError(
                f"diurnal_period must be finite > 0, got "
                f"{self.diurnal_period}"
            )
        if not math.isfinite(self.phase):
            raise ValueError(f"phase must be finite, got {self.phase}")
        if self.gpus < 1:
            raise ValueError(f"gpus must be >= 1, got {self.gpus}")
        if self.max_replicas < 1:
            raise ValueError(
                f"max_replicas must be >= 1, got {self.max_replicas}"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if not (self.svc_base >= 0.0 and math.isfinite(self.svc_base)):
            raise ValueError(
                f"svc_base must be finite >= 0, got {self.svc_base}"
            )
        if not (self.svc_per_req > 0.0 and math.isfinite(self.svc_per_req)):
            raise ValueError(
                f"svc_per_req must be finite > 0, got {self.svc_per_req}"
            )

    @property
    def end(self) -> float:
        return self.start + self.duration

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate (req/s) at time ``t``."""
        if self.diurnal_amplitude == 0.0:
            return self.rate
        return self.rate * (
            1.0
            + self.diurnal_amplitude
            * math.sin(
                2.0 * math.pi * (t - self.start) / self.diurnal_period
                + self.phase
            )
        )

    def service_time(self, batch: int) -> float:
        """Seconds one replica takes to serve a batch of ``batch``."""
        return self.svc_base + self.svc_per_req * batch

    def arrivals(self) -> Iterator[float]:
        """Lazy time-ordered arrival timestamps (thinning sampler).

        Candidate gaps are exponential at the peak rate
        ``rate * (1 + amplitude)``; a candidate at ``t`` is kept when
        ``u * peak <= rate_at(t)`` — the standard nonhomogeneous-Poisson
        thinning, exact for the sinusoidal profile.  The acceptance
        uniform is drawn for every candidate (amplitude 0 accepts all),
        so enabling modulation never shifts the underlying draw
        sequence.  Replayable: each call re-seeds from
        ``(seed, stream_id)``.
        """
        import numpy as np

        rng = np.random.default_rng([self.seed, self.stream_id])
        peak = self.rate * (1.0 + self.diurnal_amplitude)
        t = self.start
        end = self.end
        while True:
            gaps = rng.exponential(1.0 / peak, _ARRIVAL_CHUNK)
            us = rng.random(_ARRIVAL_CHUNK)
            for gap, u in zip(gaps, us):
                t += gap
                if t >= end:
                    return
                if u * peak <= self.rate_at(t):
                    yield t


def request_stream_to_dict(rs: RequestStream) -> dict:
    d: dict = {"kind": REQUEST_STREAM_KIND}
    d.update({f: getattr(rs, f) for f in _STREAM_FIELDS})
    return d


def request_stream_from_dict(d: Mapping) -> RequestStream:
    tag = d.get("kind")
    if tag != REQUEST_STREAM_KIND:
        raise ValueError(
            f"unknown request-stream kind {tag!r} (schema "
            f"{SCENARIO_SCHEMA_VERSION} knows [{REQUEST_STREAM_KIND!r}])"
        )
    unknown = set(d) - {"kind"} - set(_STREAM_FIELDS)
    if unknown:
        raise ValueError(
            f"request stream has unknown field(s) {sorted(unknown)}: {d!r}"
        )
    missing = [f for f in _STREAM_REQUIRED if f not in d]
    if missing:
        raise ValueError(
            f"request stream missing required field(s) {missing}: {d!r}"
        )
    kwargs = {
        "stream_id": int(d["stream_id"]),
        "rate": float(d["rate"]),
        "duration": float(d["duration"]),
        "slo": float(d["slo"]),
    }
    for f in _STREAM_OPTIONAL:
        if f in d:
            kwargs[f] = (
                int(d[f])
                if f in ("gpus", "max_replicas", "max_batch", "seed")
                else float(d[f])
            )
    return RequestStream(**kwargs)


# ---------------------------------------------------------------------------
# Job + cluster (de)serialization — the frozen-trace format, now documented
# ---------------------------------------------------------------------------


def job_to_dict(job: JobSpec) -> dict:
    d = {f: getattr(job, f) for f in _JOB_FIELDS}
    d["stages"] = [
        [getattr(st, f) for f in _STAGE_FIELDS] for st in job.stages
    ]
    return d


def job_from_dict(d: Mapping) -> JobSpec:
    unknown = set(d) - set(_JOB_FIELDS) - {"stages"}
    if unknown:
        raise ValueError(
            f"job record has unknown field(s) {sorted(unknown)}"
        )
    try:
        stages = tuple(
            StageSpec(**dict(zip(_STAGE_FIELDS, s))) for s in d["stages"]
        )
        return JobSpec(stages=stages, **{f: d[f] for f in _JOB_FIELDS})
    except KeyError as exc:
        raise ValueError(f"job record missing field {exc}") from None


def jobs_to_dicts(jobs: Sequence[JobSpec]) -> List[dict]:
    return [job_to_dict(job) for job in jobs]


def jobs_from_dicts(data: Sequence[Mapping]) -> List[JobSpec]:
    return [job_from_dict(d) for d in data]


# ---------------------------------------------------------------------------
# Streaming jobs sources (bounded-memory million-job scenarios)
# ---------------------------------------------------------------------------


class JobStream:
    """Lazy jobs source for ``Scenario.jobs`` — O(1) resident memory.

    A stream is an iterable yielding :class:`JobSpec` s in nondecreasing
    ``arrival`` order; the simulator pulls arrivals incrementally (each
    job is validated as it is pulled, and an out-of-order yield fails
    loudly — simulator.py).  A ``Scenario`` whose ``jobs`` is a
    ``JobStream`` never materializes the workload: the stream is held
    as-is (not tupled) and ``simulate`` defaults to the streaming
    result backend for it.  Streaming scenarios do not serialize —
    ``to_dict`` refuses; use :meth:`Scenario.materialize` first.

    Subclasses implement ``__iter__``.  Whether iteration is replayable
    is per-subclass: :class:`JsonlJobs` always is (it re-opens its
    shards); :class:`IterJobs` is replayable only in factory form.
    """

    def __iter__(self) -> Iterator[JobSpec]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise TypeError(
            f"{type(self).__name__} is a lazy jobs source: its length is "
            f"unknown without consuming it (materialize the scenario for "
            f"a tuple-backed workload)"
        )


class IterJobs(JobStream):
    """Wrap an iterator — or, for a replayable stream, a zero-argument
    factory returning a fresh iterator — of time-ordered ``JobSpec`` s.

    A bare iterator/generator is single-shot: iterating a second time
    raises (the first pass consumed it), which matters for equivalence
    tests that replay a stream — pass a factory callable there.
    """

    def __init__(
        self,
        source: Union[Callable[[], Iterable[JobSpec]], Iterable[JobSpec]],
        name: str = "",
    ):
        self.name = name
        if callable(source):
            self._factory: Optional[Callable[[], Iterable[JobSpec]]] = source
            self._iter: Optional[Iterator[JobSpec]] = None
        else:
            self._factory = None
            self._iter = iter(source)

    def __iter__(self) -> Iterator[JobSpec]:
        if self._factory is not None:
            return iter(self._factory())
        it, self._iter = self._iter, None
        if it is None:
            raise RuntimeError(
                "single-shot IterJobs already consumed; construct it from "
                "a factory callable for a replayable stream"
            )
        return it


class JsonlJobs(JobStream):
    """JSONL-shard jobs source: one schema-v1 ``<job>`` record per line.

    Shards are read lazily, in the order given; the concatenation must
    be arrival-ordered (enforced at simulation time).  Blank lines are
    skipped; a malformed line fails loudly with its ``path:lineno``.
    Replayable: every iteration re-opens the shards.
    """

    def __init__(
        self,
        paths: Union[str, os.PathLike, Sequence[Union[str, os.PathLike]]],
        name: str = "",
    ):
        if isinstance(paths, (str, os.PathLike)):
            paths = (paths,)
        self.paths: Tuple[str, ...] = tuple(os.fspath(p) for p in paths)
        if not self.paths:
            raise ValueError("JsonlJobs needs at least one shard path")
        self.name = name

    def __iter__(self) -> Iterator[JobSpec]:
        for path in self.paths:
            with open(path) as fh:
                for lineno, line in enumerate(fh, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                    except json.JSONDecodeError as exc:
                        raise ValueError(
                            f"{path}:{lineno}: malformed JSONL job record: "
                            f"{exc}"
                        ) from None
                    try:
                        yield job_from_dict(d)
                    except ValueError as exc:
                        raise ValueError(
                            f"{path}:{lineno}: {exc}"
                        ) from None


def jobs_to_jsonl(jobs: Iterable[JobSpec], path) -> int:
    """Write jobs as a JSONL shard (one schema-v1 record per line, the
    :class:`JsonlJobs` input format); streams — never holds more than
    one job resident.  Returns the number of jobs written."""
    n = 0
    with open(path, "w") as fh:
        for job in jobs:
            fh.write(json.dumps(job_to_dict(job), allow_nan=False))
            fh.write("\n")
            n += 1
    return n


def cluster_to_dict(spec: ClusterSpec) -> dict:
    if spec.is_heterogeneous:
        return {
            "b_intra": spec.b_intra,
            "server_classes": [
                {f: getattr(c, f) for f in _CLASS_FIELDS}
                for c in spec.server_classes
            ],
        }
    return {
        "num_servers": spec.num_servers,
        "gpus_per_server": spec.gpus_per_server,
        "b_inter": spec.b_inter,
        "b_intra": spec.b_intra,
    }


def cluster_from_dict(d: Mapping) -> ClusterSpec:
    unknown = set(d) - {
        "num_servers", "gpus_per_server", "b_inter", "b_intra",
        "server_classes",
    }
    if unknown:
        raise ValueError(
            f"cluster spec has unknown field(s) {sorted(unknown)}"
        )
    try:
        if d.get("server_classes"):
            classes = []
            for c in d["server_classes"]:
                bad = set(c) - set(_CLASS_FIELDS)
                if bad:
                    raise ValueError(
                        f"server class has unknown field(s) {sorted(bad)}"
                    )
                classes.append(
                    ServerClass(**{f: c[f] for f in _CLASS_FIELDS if f in c})
                )
            return ClusterSpec.heterogeneous(classes, b_intra=d["b_intra"])
        return ClusterSpec(
            num_servers=d["num_servers"],
            gpus_per_server=d["gpus_per_server"],
            b_inter=d["b_inter"],
            b_intra=d["b_intra"],
        )
    except KeyError as exc:
        raise ValueError(f"cluster spec missing field {exc}") from None


# ---------------------------------------------------------------------------
# Scenario
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """Workload + cluster + one canonical timeline of typed events.

    ``events`` is re-sorted into the canonical ``(t, server, kind,
    magnitude)`` order on construction, so two scenarios built from any
    permutation of the same events compare (and replay) equal.  Event
    server ids are validated against the spec here — failing at
    construction beats failing mid-simulation.

    ``jobs`` is either a time-ordered tuple of :class:`JobSpec` (any
    sequence is tupled on construction) or a :class:`JobStream` — a
    lazy source held as-is, so a scenario no longer implies O(jobs)
    resident memory; per-job validation then happens as the simulator
    pulls arrivals.  Stream-backed scenarios do not serialize (see
    :meth:`to_dict` / :meth:`materialize`).

    ``request_streams`` (schema v2) holds the serving
    workloads co-scheduled with the jobs — stored sorted by
    ``stream_id`` (ids must be unique), each validated against the
    cluster (a replica must fit on one server).
    """

    jobs: Union[Tuple[JobSpec, ...], JobStream]
    cluster: ClusterSpec
    events: Tuple[ClusterEvent, ...] = ()
    name: str = ""
    request_streams: Tuple[RequestStream, ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.jobs, JobStream):
            object.__setattr__(self, "jobs", tuple(self.jobs))
        events = tuple(sorted(self.events, key=event_sort_key))
        object.__setattr__(self, "events", events)
        n = self.cluster.num_servers
        for ev in events:
            if ev.server >= n:
                raise ValueError(
                    f"{type(ev).__name__} targets server {ev.server}, "
                    f"cluster has {n}"
                )
        streams = tuple(
            sorted(self.request_streams, key=lambda rs: rs.stream_id)
        )
        object.__setattr__(self, "request_streams", streams)
        seen = set()
        cap = self.cluster.gpus_per_server
        for rs in streams:
            if rs.stream_id in seen:
                raise ValueError(
                    f"duplicate request stream_id {rs.stream_id}"
                )
            seen.add(rs.stream_id)
            if rs.gpus > cap:
                raise ValueError(
                    f"request stream {rs.stream_id} needs {rs.gpus} GPUs "
                    f"per replica on one server; largest server has {cap}"
                )

    def materialize(self) -> "Scenario":
        """Tuple-backed copy: pulls the whole stream into memory (O(jobs);
        the escape hatch back to the serializable, indexable form).  A
        tuple-backed scenario returns itself."""
        if not isinstance(self.jobs, JobStream):
            return self
        return Scenario(
            jobs=tuple(self.jobs), cluster=self.cluster,
            events=self.events, name=self.name,
            request_streams=self.request_streams,
        )

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        if isinstance(self.jobs, JobStream):
            raise TypeError(
                "a stream-backed Scenario does not serialize (its jobs "
                "are not resident); call .materialize() first, or keep "
                "the workload as JSONL shards next to the scenario"
            )
        # request-stream-free scenarios serialize as version 1 with no
        # "request_streams" key: every pre-serving document (the golden
        # fixtures included) round-trips byte-identical
        d = {
            "schema": 2 if self.request_streams else 1,
            "name": self.name,
            "cluster": cluster_to_dict(self.cluster),
            "jobs": jobs_to_dicts(self.jobs),
            "events": [event_to_dict(ev) for ev in self.events],
        }
        if self.request_streams:
            d["request_streams"] = [
                request_stream_to_dict(rs) for rs in self.request_streams
            ]
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "Scenario":
        version = d.get("schema")
        if version not in _READABLE_SCHEMAS:
            raise ValueError(
                f"unsupported scenario schema {version!r} "
                f"(this build reads {_READABLE_SCHEMAS})"
            )
        unknown = set(d) - {
            "schema", "name", "cluster", "jobs", "events", "request_streams",
        }
        if unknown:
            raise ValueError(
                f"scenario has unknown section(s) {sorted(unknown)}"
            )
        if version < 2 and "request_streams" in d:
            raise ValueError(
                "request_streams requires scenario schema 2, document "
                f"declares {version}"
            )
        try:
            cluster = d["cluster"]
            jobs = d["jobs"]
        except KeyError as exc:
            raise ValueError(f"scenario missing section {exc}") from None
        return cls(
            jobs=tuple(jobs_from_dicts(jobs)),
            cluster=cluster_from_dict(cluster),
            events=tuple(
                event_from_dict(ev) for ev in d.get("events", ())
            ),
            name=d.get("name", ""),
            request_streams=tuple(
                request_stream_from_dict(rs)
                for rs in d.get("request_streams", ())
            ),
        )

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    def dump(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json(indent=2))
            fh.write("\n")

    @classmethod
    def load(cls, path) -> "Scenario":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def scenario_from_legacy(
    jobs: Sequence[JobSpec],
    cluster_spec: ClusterSpec,
    faults: Optional[Sequence[Tuple[float, int]]] = None,
    degradations: Optional[Sequence[Tuple[float, int, float]]] = None,
    name: str = "",
) -> Scenario:
    """The legacy ``simulate(jobs, spec, faults=, degradations=)`` shim.

    Fault tuples become :class:`Fault` events, degradation triples become
    :class:`Degradation` events; the canonical ``Scenario`` ordering
    replaces the old input-sequence interleaving (same-(t, server)
    collisions now resolve deterministically — see module docstring).

    A :class:`JobStream` jobs source passes through un-tupled (tupling
    would consume — and defeat — the lazy source), so the legacy
    signature streams exactly like ``simulate(scenario, policy)``.
    """
    events: List[ClusterEvent] = [
        Fault(float(t), int(m)) for t, m in faults or ()
    ]
    events.extend(
        Degradation(float(t), int(m), factor=float(f))
        for t, m, f in degradations or ()
    )
    return Scenario(
        jobs=jobs if isinstance(jobs, JobStream) else tuple(jobs),
        cluster=cluster_spec, events=tuple(events),
        name=name,
    )


# ---------------------------------------------------------------------------
# Perturbation samplers: seeded Monte-Carlo variants of a base
# scenario.  Each sampler is a frozen config object; ``sample_events``
# draws a fresh batch of ClusterEvents from a caller-provided
# ``numpy.random.Generator`` (one generator per variant keeps variants
# independent and the whole fleet a pure function of the fleet seed), and
# ``perturb_jobs`` may rewrite the workload (arrival jitter).  Layering
# happens in ``perturb_scenario``; the batched fleet runner lives in
# ``repro.core.fleet``.
# ---------------------------------------------------------------------------


def _scenario_horizon(base: "Scenario") -> float:
    """Time scale the samplers draw windows against: the workload's last
    arrival (the trace horizon for generated traces; 0 for 1-job cases)."""
    if isinstance(base.jobs, JobStream):
        raise TypeError(
            "perturbation sampling needs a materialized workload; call "
            "scenario.materialize() first"
        )
    return max((j.arrival for j in base.jobs), default=0.0)


@dataclass(frozen=True)
class Perturbation:
    """Base sampler: no events, jobs unchanged, policy untouched.
    Subclasses override."""

    def sample_events(
        self, base: "Scenario", rng
    ) -> List[ClusterEvent]:
        return []

    def perturb_jobs(
        self, jobs: Tuple[JobSpec, ...], base: "Scenario", rng
    ) -> Tuple[JobSpec, ...]:
        return jobs

    def perturb_policy(self, policy, base: "Scenario", rng) -> None:
        """Policy-level perturbation hook: mutate one variant's
        freshly constructed, not-yet-bound policy — e.g. install a noisy
        prediction model (:class:`PredictionNoisePerturbation`).  The
        fleet runner calls it with a *separate* rng stream from the
        event sampler (``default_rng([seed, i, 1])``), so adding a
        policy perturbation never shifts the event draws — and existing
        fleet digests — of the samplers above.  Default: no-op.
        """


@dataclass(frozen=True)
class StragglerPerturbation(Perturbation):
    """Partial degradation on ``n_stragglers`` distinct servers: each
    slows to a uniform factor in ``[factor_low, factor_high)`` starting
    at a uniform fraction of the horizon inside ``start_window``;
    ``recover`` restores full speed ``duration_frac`` of the horizon
    later (mirrors ``trace.straggler_events``)."""

    n_stragglers: int = 4
    factor_low: float = 0.25
    factor_high: float = 0.75
    start_window: Tuple[float, float] = (0.2, 0.6)
    duration_frac: float = 0.25
    recover: bool = True

    def sample_events(self, base, rng):
        horizon = _scenario_horizon(base)
        n = base.cluster.num_servers
        k = min(self.n_stragglers, n)
        servers = rng.choice(n, size=k, replace=False)
        out: List[ClusterEvent] = []
        for m in servers:
            f = float(rng.uniform(self.factor_low, self.factor_high))
            t0 = float(horizon * rng.uniform(*self.start_window))
            out.append(Degradation(t0, int(m), factor=f))
            if self.recover:
                out.append(
                    Degradation(
                        t0 + horizon * self.duration_frac, int(m),
                        factor=1.0,
                    )
                )
        return out


@dataclass(frozen=True)
class ElasticPerturbation(Perturbation):
    """Elastic capacity: ``n_servers`` distinct servers leave at
    ``leave_frac`` of the horizon (0.0 == absent from the start, the
    ``--elastic`` maintenance-window regime) and rejoin at a uniform
    fraction inside ``join_window``."""

    n_servers: int = 2
    leave_frac: float = 0.0
    join_window: Tuple[float, float] = (0.3, 0.6)
    drain_timeout: float = 0.0

    def __post_init__(self) -> None:
        if self.join_window[0] <= self.leave_frac:
            raise ValueError(
                f"join_window must start after leave_frac="
                f"{self.leave_frac}, got {self.join_window}"
            )

    def sample_events(self, base, rng):
        horizon = _scenario_horizon(base)
        n = base.cluster.num_servers
        k = min(self.n_servers, n)
        servers = rng.choice(n, size=k, replace=False)
        out: List[ClusterEvent] = []
        for m in servers:
            t_join = float(horizon * rng.uniform(*self.join_window))
            out.append(
                ServerLeave(
                    self.leave_frac * horizon, int(m),
                    drain_timeout=self.drain_timeout,
                )
            )
            out.append(ServerJoin(t_join, int(m)))
        return out


@dataclass(frozen=True)
class FaultPerturbation(Perturbation):
    """Permanent full failures on ``n_faults`` distinct servers, each at
    a uniform fraction of the horizon inside ``window``."""

    n_faults: int = 1
    window: Tuple[float, float] = (0.2, 0.8)

    def sample_events(self, base, rng):
        horizon = _scenario_horizon(base)
        n = base.cluster.num_servers
        k = min(self.n_faults, n)
        servers = rng.choice(n, size=k, replace=False)
        return [
            Fault(float(horizon * rng.uniform(*self.window)), int(m))
            for m in servers
        ]


@dataclass(frozen=True)
class ArrivalJitterPerturbation(Perturbation):
    """Gaussian arrival jitter: every arrival shifts by N(0, sigma)
    seconds, clamped at 0 (the simulator stable-sorts unsorted tuples by
    arrival, so no re-sort is needed here)."""

    sigma: float = 60.0

    def perturb_jobs(self, jobs, base, rng):
        if not jobs:
            return jobs
        offs = rng.normal(0.0, self.sigma, size=len(jobs))
        return tuple(
            dataclasses.replace(
                j, arrival=max(0.0, j.arrival + float(dt))
            )
            for j, dt in zip(jobs, offs)
        )


@dataclass(frozen=True)
class PredictionNoisePerturbation(Perturbation):
    """Prediction-error injection as a first-class fleet axis:
    installs a seeded :class:`~repro.core.prediction_loop.NoisyModel` on
    each variant's policy via ``Policy.set_predictor``, so the
    Monte-Carlo fleet sweeps misprediction regimes exactly like it
    sweeps stragglers or faults.

    ``mode`` selects the error family (``"lognormal"`` multiplicative
    noise of width ``sigma``; ``"rankflip"`` sign-flipped rank order;
    ``"coldstart"`` a ``cold_frac`` fraction of jobs predicted 0 — the
    paper's unseen-job rule hitting a random subset).  Each variant
    draws one noise seed from the policy rng stream, so per-job noise is
    independent across variants yet the whole fleet stays a pure
    function of the fleet seed.  No cluster events and no job rewrites:
    only the policy's beliefs are perturbed.
    """

    mode: str = "lognormal"
    sigma: float = 0.5
    cold_frac: float = 0.3

    def __post_init__(self) -> None:
        from .prediction_loop import NOISE_MODES  # deferred: import cycle

        if self.mode not in NOISE_MODES:
            raise ValueError(
                f"unknown noise mode {self.mode!r} (one of {NOISE_MODES})"
            )

    def perturb_policy(self, policy, base, rng) -> None:
        from .prediction_loop import NoisyModel  # deferred: import cycle

        policy.set_predictor(
            NoisyModel(
                self.mode,
                sigma=self.sigma,
                cold_frac=self.cold_frac,
                seed=int(rng.integers(0, 2**31 - 1)),
            )
        )


def perturb_scenario(
    base: Scenario,
    perturbations: Sequence[Perturbation],
    rng,
    name: str = "",
) -> Scenario:
    """One seeded variant: base jobs/events plus every sampler's draw.

    Samplers are applied in list order against ``rng`` (a
    ``numpy.random.Generator``), so the variant is a pure function of
    ``(base, perturbations, generator state)``.  Sampled events merge
    with the base event stream under the canonical Scenario ordering.
    """
    if isinstance(base.jobs, JobStream):
        raise TypeError(
            "perturbation sampling needs a materialized workload; call "
            "scenario.materialize() first"
        )
    jobs: Tuple[JobSpec, ...] = base.jobs
    events: List[ClusterEvent] = list(base.events)
    for p in perturbations:
        jobs = p.perturb_jobs(jobs, base, rng)
        events.extend(p.sample_events(base, rng))
    return Scenario(
        jobs=jobs, cluster=base.cluster, events=tuple(events),
        name=name or base.name, request_streams=base.request_streams,
    )


# ---------------------------------------------------------------------------
# CLI: schema validation (wired into CI's scenario-schema step)
# ---------------------------------------------------------------------------


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.scenario",
        description="Validate scenario / frozen-trace JSON files "
                    "against the documented schema.",
    )
    ap.add_argument(
        "command", choices=("validate", "validate-jobs"),
        help="'validate' checks a full scenario file; 'validate-jobs' "
             "checks a bare jobs array (e.g. tests/golden/trace.json)",
    )
    ap.add_argument("path", help="JSON file to check")
    args = ap.parse_args(argv)

    try:
        if args.command == "validate":
            sc = Scenario.load(args.path)
            print(
                f"{args.path}: ok (schema {SCENARIO_SCHEMA_VERSION}, "
                f"name={sc.name!r}, {len(sc.jobs)} jobs, "
                f"{len(sc.events)} events, "
                f"{sc.cluster.num_servers} servers / "
                f"{sc.cluster.total_gpus} GPUs)"
            )
        else:
            with open(args.path) as fh:
                jobs = jobs_from_dicts(json.load(fh))
            if any(
                jobs[i].arrival > jobs[i + 1].arrival
                for i in range(len(jobs) - 1)
            ):
                raise ValueError("jobs array is not arrival-ordered")
            print(
                f"{args.path}: ok ({len(jobs)} jobs, "
                f"max g={max(j.g for j in jobs)})"
            )
    except (ValueError, TypeError, OSError, json.JSONDecodeError) as exc:
        print(f"{args.path}: INVALID — {exc}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
