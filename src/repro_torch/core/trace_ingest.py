"""Datacenter-trace ingestion: Philly/PAI-style CSV rows -> JobSpecs.

Production GPU-cluster traces (Microsoft Philly, Alibaba PAI; Hu et al.,
arXiv 2109.01313) ship as CSV: one row per job with a submit timestamp, a
GPU demand, an observed duration, and optional user/model tags.  This
module turns such rows into the simulator's :class:`JobSpec` s — either

* **lazily**, via :func:`iter_trace_csv` / :func:`trace_jobs_source`,
  holding O(1) rows resident (the bounded-memory path for million-job
  replays; rows must already be submit-ordered), or
* **eagerly**, via :func:`load_trace_csv` / :func:`ingest_scenario`,
  which sorts by submit time and can serialize to Scenario JSON v1.

CSV format
----------

A header row is required.  Column names are matched case-insensitively
against the alias table below; the canonical name is listed first.

===========  ==========================================  =========
column        aliases                                    required
===========  ==========================================  =========
submit_time  submitted_time, submit, start_time,         yes
             arrival
gpus         num_gpus, gpu_num, gpu_demand, plan_gpu     yes
duration     run_time, runtime, duration_s, run_time_s   one of
iterations   n_iters, iters                              the two
user         user_id, user_name                          no
model        model_name, workload                        no
group        group_id, group_tag                         no
===========  ==========================================  =========

* ``submit_time`` is either a float (seconds) or an ISO-8601 timestamp
  (``2017-10-03 14:21:09``).  ISO timestamps are converted to seconds
  relative to the first row's timestamp; numeric values pass through
  unchanged (override with an explicit ``t0``).
* ``gpus`` must parse as a positive integer (a float with zero
  fractional part is accepted — PAI's ``plan_gpu`` style ``800.0``
  means 800 GPUs only after the caller rescales; this module does not
  guess units).
* ``iterations`` wins when both it and ``duration`` are present.  A
  duration is converted to an iteration count by dividing by the
  assigned model profile's single-device iteration time (the quantity
  the paper's predictor estimates) — ``max(1, round(dur / t_iter))``.
* ``model``, when present, must name a profile in
  :data:`repro.core.profiles.PAPER_MODELS`.  When absent (or blank),
  a profile is assigned deterministically by hashing the recurrence
  tag, so resubmissions of the same group get the same model.
* ``user`` and ``group`` tags are interned to dense integer ids in
  first-seen order.  When ``group`` is absent the recurrence key falls
  back to ``(user, model, gpus)`` — the PAI notion that a user
  resubmitting the same workload shape is the same recurring job.

Malformed-row policy (fail-loud by default)
-------------------------------------------

Header-level problems — a missing required column, an unreadable header
— always raise :class:`TraceSchemaError`.  Row-level problems raise
``TraceSchemaError`` with a ``path:line:`` prefix naming the offending
row under the default ``on_error="raise"``; ``on_error="skip"`` instead
drops the row and counts it in :class:`IngestStats` (use for known-dirty
real traces, never silently).  A row is malformed when:

* a required field is missing or blank,
* ``submit_time`` parses as neither float nor ISO-8601, or is negative
  after ``t0`` normalization, or is NaN/inf,
* ``gpus`` is not a positive integer (zero-GPU rows — PAI CPU-only
  jobs — are *malformed here*: filter them upstream or use ``skip``),
* ``duration``/``iterations`` is not a positive finite number,
* ``model`` names an unknown profile.

Out-of-order submits are **not** a row-level defect: real traces are
logged by completion and arrive unsorted.  The eager loaders sort.  The
lazy iterator cannot (bounded memory), so it raises ``TraceSchemaError``
on the first regression unless constructed with ``sorted_input=False``
— in which case use it only to feed an eager sort or a JSONL re-shard
(the simulator enforces arrival order itself and would fail anyway).

CLI
---

``python -m repro.core.trace_ingest stats FILE.csv`` parses and prints
summary statistics (fail-loud).  ``convert FILE.csv --jsonl OUT.jsonl``
re-shards a CSV into the :class:`~repro.core.scenario.JsonlJobs` format
streamingly; ``convert FILE.csv --scenario OUT.json --servers N
--gpus-per-server G`` emits a full Scenario JSON v1 document (eager).
"""
from __future__ import annotations

import csv
import math
import zlib
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from .job import ClusterSpec, JobSpec, RAR
from .profiles import PAPER_MODELS, ModelProfile, build_stages
from .scenario import ClusterEvent, IterJobs, Scenario

__all__ = [
    "IngestStats",
    "TraceSchemaError",
    "ingest_scenario",
    "iter_trace_csv",
    "load_trace_csv",
    "trace_jobs_source",
]


class TraceSchemaError(ValueError):
    """A trace violates the documented CSV schema (header or row)."""


# canonical -> accepted header spellings (all matched lowercased)
_ALIASES: Dict[str, Tuple[str, ...]] = {
    "submit_time": (
        "submit_time", "submitted_time", "submit", "start_time", "arrival",
    ),
    "gpus": ("gpus", "num_gpus", "gpu_num", "gpu_demand", "plan_gpu"),
    "duration": ("duration", "run_time", "runtime", "duration_s",
                 "run_time_s"),
    "iterations": ("iterations", "n_iters", "iters"),
    "user": ("user", "user_id", "user_name"),
    "model": ("model", "model_name", "workload"),
    "group": ("group", "group_id", "group_tag"),
}

_MODEL_NAMES: Tuple[str, ...] = tuple(PAPER_MODELS)


@dataclass
class IngestStats:
    """Counters filled in while a trace is parsed (also under ``skip``)."""

    n_rows: int = 0  # data rows seen (header excluded)
    n_jobs: int = 0  # rows successfully converted
    n_skipped: int = 0  # malformed rows dropped (on_error="skip" only)
    skipped_lines: List[int] = field(default_factory=list)  # first 20
    n_users: int = 0
    n_groups: int = 0
    total_gpu_demand: int = 0
    first_submit: Optional[float] = None
    last_submit: Optional[float] = None


def _resolve_header(fieldnames: Sequence[str], path: str) -> Dict[str, int]:
    """Map canonical column -> index, applying the alias table."""
    lowered = [(name or "").strip().lower() for name in fieldnames]
    out: Dict[str, int] = {}
    for canon, aliases in _ALIASES.items():
        for alias in aliases:
            if alias in lowered:
                out[canon] = lowered.index(alias)
                break
    missing = [c for c in ("submit_time", "gpus") if c not in out]
    if "duration" not in out and "iterations" not in out:
        missing.append("duration|iterations")
    if missing:
        raise TraceSchemaError(
            f"{path}: header {list(fieldnames)!r} is missing required "
            f"column(s) {missing} (aliases: "
            + "; ".join(f"{c}={list(_ALIASES[c])}" for c in _ALIASES)
        )
    return out


def _parse_submit(raw: str) -> Tuple[float, bool]:
    """Returns (value, is_wallclock).  Wallclock = ISO-8601 timestamp."""
    try:
        return float(raw), False
    except ValueError:
        pass
    try:
        return datetime.fromisoformat(raw).timestamp(), True
    except ValueError:
        raise TraceSchemaError(
            f"submit_time {raw!r} is neither a float (seconds) nor an "
            f"ISO-8601 timestamp"
        ) from None


def _parse_gpus(raw: str) -> int:
    try:
        v = float(raw)
    except ValueError:
        raise TraceSchemaError(f"gpus {raw!r} is not a number") from None
    if not math.isfinite(v) or v <= 0 or v != int(v):
        raise TraceSchemaError(
            f"gpus {raw!r} is not a positive integer (zero-GPU / "
            f"fractional rows are malformed; filter or rescale upstream)"
        )
    return int(v)


def _pick_model(tag: str, group_tag: str) -> ModelProfile:
    if tag:
        profile = PAPER_MODELS.get(tag)
        if profile is None:
            raise TraceSchemaError(
                f"model {tag!r} is not a known profile "
                f"(known: {list(_MODEL_NAMES)})"
            )
        return profile
    # no tag: deterministic by recurrence key, so a recurring group
    # keeps one model across resubmissions
    idx = zlib.crc32(group_tag.encode()) % len(_MODEL_NAMES)
    return PAPER_MODELS[_MODEL_NAMES[idx]]


def _replicas_for(profile: ModelProfile, g: int) -> Tuple[int, ...]:
    """The profile's listed distributed config matching the GPU demand,
    else a pure data-parallel single stage (any g is schedulable)."""
    for cfg in profile.configs:
        if sum(cfg) == g:
            return cfg
    return (g,)


def iter_trace_csv(
    path,
    *,
    on_error: str = "raise",
    t0: Optional[float] = None,
    start_job_id: int = 0,
    sorted_input: bool = True,
    stats: Optional[IngestStats] = None,
) -> Iterator[JobSpec]:
    """Lazily parse a trace CSV into time-ordered :class:`JobSpec` s.

    O(1) rows resident (plus the user/group interning maps, which are
    O(distinct tags) — hundreds in real traces, not O(jobs)).  With the
    default ``sorted_input=True`` an out-of-order submit raises; see the
    module docstring for the full malformed-row policy.  Pass an
    :class:`IngestStats` to collect counters while streaming.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip': {on_error!r}")
    path = str(path)
    st = stats if stats is not None else IngestStats()
    users: Dict[str, int] = {}
    groups: Dict[str, int] = {}
    # per-(model, replicas) memoized stage tuples: recurrent jobs share
    # one stages object, which is what keeps a million-job pull small
    stage_cache: Dict[Tuple[str, Tuple[int, ...]], tuple] = {}
    job_id = start_job_id
    wall_t0: Optional[float] = None
    last_submit = -math.inf

    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        try:
            header = next(reader)
        except StopIteration:
            raise TraceSchemaError(f"{path}: empty file (no header)") \
                from None
        cols = _resolve_header(header, path)

        def get(row: Sequence[str], canon: str) -> str:
            i = cols.get(canon)
            if i is None or i >= len(row):
                return ""
            return row[i].strip()

        for lineno, row in enumerate(reader, start=2):
            if not row or all(not c.strip() for c in row):
                continue
            st.n_rows += 1
            try:
                raw_submit = get(row, "submit_time")
                if not raw_submit:
                    raise TraceSchemaError("submit_time is blank")
                submit, wallclock = _parse_submit(raw_submit)
                if wallclock:
                    if wall_t0 is None:
                        wall_t0 = submit if t0 is None else t0
                    submit -= wall_t0
                elif t0 is not None:
                    submit -= t0
                if not math.isfinite(submit) or submit < 0.0:
                    raise TraceSchemaError(
                        f"submit_time {raw_submit!r} normalizes to "
                        f"{submit!r} (negative or non-finite)"
                    )

                g = _parse_gpus(get(row, "gpus"))

                user_tag = get(row, "user")
                model_tag = get(row, "model")
                group_tag = get(row, "group")
                if not group_tag:
                    group_tag = f"{user_tag}/{model_tag}/g{g}"
                profile = _pick_model(model_tag, group_tag)

                raw_iters = get(row, "iterations")
                if raw_iters:
                    try:
                        n_iters = int(float(raw_iters))
                    except ValueError:
                        raise TraceSchemaError(
                            f"iterations {raw_iters!r} is not a number"
                        ) from None
                    if not 0 < n_iters < 2**62:
                        raise TraceSchemaError(
                            f"iterations {raw_iters!r} out of range"
                        )
                else:
                    raw_dur = get(row, "duration")
                    if not raw_dur:
                        raise TraceSchemaError(
                            "row has neither iterations nor duration"
                        )
                    try:
                        dur = float(raw_dur)
                    except ValueError:
                        raise TraceSchemaError(
                            f"duration {raw_dur!r} is not a number"
                        ) from None
                    if not math.isfinite(dur) or dur <= 0.0:
                        raise TraceSchemaError(
                            f"duration {raw_dur!r} is not positive finite"
                        )
                    n_iters = max(
                        1, int(round(dur / profile.iter_time_1dev))
                    )
            except TraceSchemaError as exc:
                if on_error == "raise":
                    raise TraceSchemaError(
                        f"{path}:{lineno}: {exc}"
                    ) from None
                st.n_skipped += 1
                if len(st.skipped_lines) < 20:
                    st.skipped_lines.append(lineno)
                continue

            if sorted_input and submit < last_submit:
                # not a row defect: the *file* isn't stream-ingestible
                raise TraceSchemaError(
                    f"{path}:{lineno}: out-of-order submit {submit!r} "
                    f"after {last_submit!r} — the lazy reader needs a "
                    f"submit-sorted trace; sort the CSV, or use "
                    f"load_trace_csv() (eager, sorts in memory)"
                )
            last_submit = max(last_submit, submit)

            replicas = _replicas_for(profile, g)
            skey = (profile.name, replicas)
            stages = stage_cache.get(skey)
            if stages is None:
                stages = stage_cache[skey] = build_stages(profile, replicas)

            st.n_jobs += 1
            st.total_gpu_demand += g
            if st.first_submit is None:
                st.first_submit = submit
            st.last_submit = submit
            yield JobSpec(
                job_id=job_id,
                stages=stages,
                n_iters=n_iters,
                arrival=submit,
                group_id=groups.setdefault(group_tag, len(groups)),
                user_id=users.setdefault(user_tag, len(users)),
                allreduce=RAR,
                model_name=profile.name,
            )
            job_id += 1
            st.n_users = len(users)
            st.n_groups = len(groups)


def trace_jobs_source(path, **kw) -> IterJobs:
    """Replayable :class:`~repro.core.scenario.JobStream` over a CSV —
    the ``Scenario.jobs`` / ``simulate`` input for bounded-memory replay
    (each iteration re-opens and re-parses the file)."""
    return IterJobs(
        lambda: iter_trace_csv(path, **kw), name=f"csv:{path}"
    )


def load_trace_csv(
    path,
    *,
    on_error: str = "raise",
    t0: Optional[float] = None,
    start_job_id: int = 0,
    stats: Optional[IngestStats] = None,
) -> List[JobSpec]:
    """Eagerly parse a trace CSV (O(jobs) memory): rows are sorted by
    submit time — out-of-order files are fine here — and job ids are
    reassigned in arrival order, so the result is directly a schema-v1
    ``jobs`` array."""
    jobs = list(
        iter_trace_csv(
            path, on_error=on_error, t0=t0, start_job_id=start_job_id,
            sorted_input=False, stats=stats,
        )
    )
    jobs.sort(key=lambda j: j.arrival)
    return [
        JobSpec(
            job_id=start_job_id + i,
            stages=j.stages,
            n_iters=j.n_iters,
            arrival=j.arrival,
            group_id=j.group_id,
            user_id=j.user_id,
            allreduce=j.allreduce,
            model_name=j.model_name,
        )
        for i, j in enumerate(jobs)
    ]


def ingest_scenario(
    path,
    cluster: ClusterSpec,
    events: Sequence[ClusterEvent] = (),
    name: str = "",
    **kw,
) -> Scenario:
    """Eager CSV -> :class:`Scenario` (serializable via ``to_json()``,
    Scenario JSON schema v1)."""
    return Scenario(
        jobs=load_trace_csv(path, **kw),
        cluster=cluster,
        events=tuple(events),
        name=name or f"csv:{path}",
    )


# ---------------------------------------------------------------------------
# CLI: python -m repro.core.trace_ingest {stats,convert} FILE.csv ...
# ---------------------------------------------------------------------------


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.trace_ingest",
        description="Philly/PAI-style CSV trace ingestion",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_stats = sub.add_parser("stats", help="parse + print trace statistics")
    p_conv = sub.add_parser(
        "convert", help="CSV -> JSONL shard (streaming) or Scenario JSON"
    )
    for p in (p_stats, p_conv):
        p.add_argument("csv", help="trace CSV file")
        p.add_argument(
            "--skip-malformed", action="store_true",
            help="drop malformed rows (default: fail loud)",
        )
    p_conv.add_argument("--jsonl", help="output JSONL shard (streaming)")
    p_conv.add_argument(
        "--scenario", help="output Scenario JSON v1 (eager, sorts)"
    )
    p_conv.add_argument("--servers", type=int, default=16)
    p_conv.add_argument("--gpus-per-server", type=int, default=8)
    p_conv.add_argument("--b-inter", type=float, default=1.25e9)
    p_conv.add_argument("--b-intra", type=float, default=300e9)
    args = ap.parse_args(argv)

    on_error = "skip" if args.skip_malformed else "raise"
    st = IngestStats()

    if args.cmd == "stats":
        for _ in iter_trace_csv(
            args.csv, on_error=on_error, sorted_input=False, stats=st,
        ):
            pass
    else:
        if bool(args.jsonl) == bool(args.scenario):
            ap.error("convert needs exactly one of --jsonl / --scenario")
        if args.jsonl:
            from .scenario import jobs_to_jsonl

            jobs_to_jsonl(
                iter_trace_csv(
                    args.csv, on_error=on_error, sorted_input=True,
                    stats=st,
                ),
                args.jsonl,
            )
            print(f"wrote {st.n_jobs} jobs -> {args.jsonl}")
        else:
            spec = ClusterSpec(
                num_servers=args.servers,
                gpus_per_server=args.gpus_per_server,
                b_inter=args.b_inter,
                b_intra=args.b_intra,
            )
            scn = ingest_scenario(
                args.csv, spec, on_error=on_error, stats=st,
            )
            with open(args.scenario, "w") as fh:
                fh.write(scn.to_json())
            print(f"wrote {st.n_jobs}-job scenario -> {args.scenario}")

    print(
        json.dumps(
            {
                "rows": st.n_rows,
                "jobs": st.n_jobs,
                "skipped": st.n_skipped,
                "users": st.n_users,
                "groups": st.n_groups,
                "total_gpu_demand": st.total_gpu_demand,
                "first_submit": st.first_submit,
                "last_submit": st.last_submit,
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
