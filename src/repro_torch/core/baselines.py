"""Baseline schedulers from the paper's evaluation (Sec. V-A.1-d).

* SPJF  — shortest *predicted job* first (MLaaS [6]); strict head-of-line.
* SPWF  — shortest *predicted workload* (duration x GPUs) first (Tiresias
          [14] style); strict head-of-line.
* WCS-Duration / WCS-Workload / WCS-SubTime — work-conserving scheduler [46]:
  scan the queue in key order and start *every* job that currently fits
  (backfilling), keyed by predicted duration / predicted workload /
  submission time respectively.

All baselines use the Heavy-Edge algorithm for GPU mapping (as in the paper)
with consolidating (most-available-first) server selection.
"""
from __future__ import annotations

import bisect
import heapq
from typing import Callable, Dict, List

from .cluster import ClusterState
from .heavy_edge import select_servers
from .job import ClusterSpec, JobSpec
from .migration import MIGRATION_PENALTY_DEFAULT, MigrationMixin
from .predictor import IterationPredictor
from .simulator import Policy, Start


class QueuePolicy(MigrationMixin, Policy):
    """Priority-queue scheduler parameterized by key and work-conservation.

    Strict head-of-line mode keeps one queue sorted in *descending*
    priority-key order so the next job to consider sits at the end of the
    list: arrivals insert with ``bisect.insort`` (no per-event re-sort) and
    starts pop from the end without rebuilding the list.

    Work-conserving mode additionally *capacity-indexes* the ready queue:
    jobs are bucketed by GPU demand ``g`` (a handful of distinct values —
    the profile configs — regardless of queue length), each bucket sorted
    the same way.  A scheduling pass merges the bucket heads through a
    small heap, visiting jobs in global key order but touching only
    buckets that still fit in the free capacity — a bucket whose demand
    exceeds the remaining free GPUs drops out of the pass wholesale
    instead of being re-scanned job by job.  Free capacity only shrinks
    within a pass, so the started set and start order are identical to the
    former full-queue backfilling scan.
    """

    def __init__(
        self,
        predictor: IterationPredictor,
        key: str,
        work_conserving: bool,
        migrate: bool = False,  # checkpoint-restart off degraded servers
        migration_penalty: float = MIGRATION_PENALTY_DEFAULT,
        # queue-aware race (migration.py); stays False — see the
        # sched_scale --guard verdict in asrpt.py
        migration_queue_guard: bool = False,
    ):
        if key not in ("duration", "workload", "subtime"):
            raise ValueError(key)
        self.predictor = predictor
        # prediction-loop opt-in (simulator.Policy / prediction_loop):
        # derived from the predictor so plain predictors keep the legacy
        # engine byte for byte
        self.track_overruns = bool(getattr(predictor, "track_overruns", False))
        self.key_kind = key
        self.work_conserving = work_conserving
        self.migrate = migrate
        self.migration_penalty = migration_penalty
        self.migration_queue_guard = migration_queue_guard
        # (-key, -arrival, -job_id, job): ascending sort puts the smallest
        # (key, arrival, job_id) — the next job to schedule — at the end.
        # Strict head-of-line uses the flat list; work-conserving buckets
        # the same tuples by job.g.
        self.waiting: List[tuple] = []
        self.waiting_by_g: Dict[int, List[tuple]] = {}
        self._n_waiting = 0

    def bind(self, cluster_spec: ClusterSpec) -> None:
        super().bind(cluster_spec)
        self.alpha_cache = self._make_alpha_cache(cluster_spec)
        self._pcache = self._make_placement_cache(cluster_spec)

    def _key(self, job: JobSpec) -> float:
        if self.key_kind == "subtime":
            return job.arrival
        n_pred = self.predictor.predict(job)
        _, a_min = self.alpha_cache.bounds(job)
        dur = n_pred * a_min
        if self.key_kind == "duration":
            return dur
        return dur * job.g  # workload

    def on_arrival(self, t: float, job: JobSpec) -> None:
        # Key is fixed at arrival (prediction with information available now).
        entry = (-self._key(job), -job.arrival, -job.job_id, job)
        if self.work_conserving:
            bucket = self.waiting_by_g.get(job.g)
            if bucket is None:
                bucket = self.waiting_by_g[job.g] = []
            bisect.insort(bucket, entry)
            self._n_waiting += 1
        else:
            bisect.insort(self.waiting, entry)

    def on_completion(self, t: float, job: JobSpec) -> None:
        self.predictor.observe(job, job.n_iters)

    def _start(self, job: JobSpec, cluster: ClusterState, starts) -> None:
        caps = select_servers(
            cluster.free, job.g, consolidate=True, spec=self.cluster_spec,
            buckets=cluster.free_buckets, total_free=cluster.total_free,
            ranks=cluster.effective_bw_ranks,
        )
        speeds = cluster.speeds_for(caps) if cluster.has_degraded else None
        placement, a = self._pcache.map_job(job, caps, speeds=speeds)
        starts.append(Start(job, placement, a, n_pred=self._n_pred(job)))
        cluster.allocate(job.job_id, placement, counts=dict(caps))

    def plan_pass(self, t: float, cluster: ClusterState) -> List[Start]:
        starts: List[Start] = []
        free = cluster.total_free
        if free == 0:
            return starts

        if not self.work_conserving:
            waiting = self.waiting
            # Strict head-of-line: start from the head until one doesn't fit.
            while waiting and waiting[-1][3].g <= cluster.total_free:
                self._start(waiting.pop()[3], cluster, starts)
            return starts

        if self._n_waiting == 0:
            return starts
        # Work-conserving backfill over the capacity-indexed queue: merge
        # the per-demand bucket heads in key order; a popped head whose
        # demand no longer fits retires its whole bucket for this pass
        # (free never grows mid-pass).
        by_g = self.waiting_by_g
        # bucket tails hold the *smallest* (key, arrival, job_id) — negate
        # the stored (-key, ...) tuples back for the min-heap merge
        heads = [
            ((-b[-1][0], -b[-1][1], -b[-1][2]), g)
            for g, b in by_g.items()
            if b and g <= free
        ]
        heapq.heapify(heads)
        while heads:
            _, g = heapq.heappop(heads)
            free = cluster.total_free
            if free == 0:
                break
            if g > free:
                continue  # whole bucket too big for the rest of the pass
            bucket = by_g[g]
            entry = bucket.pop()
            self._n_waiting -= 1
            self._start(entry[3], cluster, starts)
            if bucket:
                nxt = bucket[-1]
                heapq.heappush(heads, ((-nxt[0], -nxt[1], -nxt[2]), g))
        return starts

    def migration_queue_head(self, t: float) -> "JobSpec | None":
        """Queue-aware migration guard hook: the job the next pass would
        consider first — the tail of the strict queue, or the smallest
        (key, arrival, job_id) across the capacity-indexed bucket tails
        (a handful of buckets; same order the heap merge visits)."""
        if not self.work_conserving:
            return self.waiting[-1][3] if self.waiting else None
        best = None
        for bucket in self.waiting_by_g.values():
            if not bucket:
                continue
            e = bucket[-1]
            key = (-e[0], -e[1], -e[2])
            if best is None or key < best[0]:
                best = (key, e[3])
        return best[1] if best is not None else None

    def queue_depth(self) -> int:
        return self._n_waiting if self.work_conserving else len(self.waiting)


def spjf(predictor: IterationPredictor, **kw) -> QueuePolicy:
    return QueuePolicy(predictor, key="duration", work_conserving=False, **kw)


def spwf(predictor: IterationPredictor, **kw) -> QueuePolicy:
    return QueuePolicy(predictor, key="workload", work_conserving=False, **kw)


def wcs_duration(predictor: IterationPredictor, **kw) -> QueuePolicy:
    return QueuePolicy(predictor, key="duration", work_conserving=True, **kw)


def wcs_workload(predictor: IterationPredictor, **kw) -> QueuePolicy:
    return QueuePolicy(predictor, key="workload", work_conserving=True, **kw)


def wcs_subtime(predictor: IterationPredictor, **kw) -> QueuePolicy:
    return QueuePolicy(predictor, key="subtime", work_conserving=True, **kw)


BASELINES: dict[str, Callable[[IterationPredictor], Policy]] = {
    "SPJF": spjf,
    "SPWF": spwf,
    "WCS-Duration": wcs_duration,
    "WCS-Workload": wcs_workload,
    "WCS-SubTime": wcs_subtime,
}
