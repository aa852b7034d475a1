"""Checkpoint-restart migration off degraded capacity.

The paper's online setting is non-preemptive: once placed, a job holds its
GPUs to completion.  Under *partial* degradation (straggler servers — see
cluster.py) that assumption is exactly what drives tail flow-time:
characterization studies of production GPU datacenters (Hu et al., arXiv
2109.01313) attribute most slowdowns to degraded-but-alive capacity, and
contention-aware schedulers (Wang et al.) show that reacting to
effective-bandwidth changes mid-run is where the wins are.

``MigrationMixin`` adds the one carefully-scoped exception: when a
degradation event re-times a running job (simulator.py), the policy may
*checkpoint-restart* it onto currently-free capacity.  The decision is a
straight predicted-time race,

    migrate  iff  penalty + iters_rem * alpha_new  <  iters_rem * alpha_cur

with ``alpha_cur`` the post-stretch in-place rate, ``alpha_new`` the
Heavy-Edge alpha on the candidate fresh capacity (speed-aware), and
``penalty`` the configured checkpoint + restart downtime in seconds.  The
candidate placement draws from *currently free* GPUs only — the job's own
(degraded) GPUs are not reused, matching checkpoint-restart semantics
where the replacement allocation must exist before the old one is torn
down.  ``iters_rem`` is true remaining work as tracked by the simulator —
an online quantity (iterations completed so far are observable), unlike
the total iteration count, which stays a prediction.

Re-placement stays on the array fast path: candidate capacity vectors come
from one consolidating ``FreeCapsSnapshot`` per (event, free-state) —
carved per demand, invalidated on every migration — and the mapping is
answered by the shared ``PlacementCache`` keyed with the per-slot speed
factors (or the retained pure-Python reference pipeline on the uncached
engine, keeping the cached/uncached bit-identical property intact under
degradation).

With ``migrate=False`` (default) or an infinite penalty no job ever
moves, which is what makes the finish-in-place baseline and the
bit-identical clean-run property (tests/test_degradation.py) hold.

Queue-aware race guard (``migration_queue_guard=True``): the per-job
race above is greedy — it ignores the opportunity cost of the free
capacity it claims, and under deep queue pressure it can lose: moving a
long stretched job onto the only free servers makes every queued job
behind it wait out the migrant's full occupancy.  With the guard on,
each accepted migration is first *charged against the head of the ready
queue* (``Policy.migration_queue_head``): when a queued job fits in the
claimed capacity (``g_head <= g``) and its predicted duration is
shorter than the migrant's post-move occupancy (``penalty + rem *
alpha_new``), the migration is skipped — SRPT says the shorter queued
job deserves those GPUs first, and the migrant keeps running in place
(it is re-offered on every later pass, so it still moves once the
queue drains).  The guard is opt-in: it changes schedules, and the
golden fixtures pin the unguarded race.
"""
from __future__ import annotations

from typing import List

from .cluster import ClusterState
from .heavy_edge import ConsolidatingLadder, map_job_canonical
from .simulator import Migration

# Default checkpoint + restart downtime, seconds: the scale of writing a
# sharded checkpoint and cold-starting the training processes elsewhere.
MIGRATION_PENALTY_DEFAULT = 120.0


class MigrationMixin:
    """Degradation reaction shared by A-SRPT and the queue baselines.

    Host classes provide ``cluster_spec`` (Policy.bind), ``_pcache`` (a
    ``PlacementCache`` or None for the reference engine), and set
    ``migrate``/``migration_penalty``/``migration_queue_guard`` in their
    constructors.  The queue guard additionally needs ``predictor`` and
    ``alpha_cache`` (both hosts have them) plus a
    ``migration_queue_head`` implementation (see simulator.Policy).
    """

    migrate: bool = False
    migration_penalty: float = MIGRATION_PENALTY_DEFAULT
    migration_queue_guard: bool = False

    def _map_migration(self, job, caps, speeds):
        pcache = getattr(self, "_pcache", None)
        if pcache is not None:
            return pcache.map_job(job, caps, speeds=speeds)
        return map_job_canonical(
            job, caps, self.cluster_spec,
            refine=getattr(self, "refine_mapping", False),
            reference=True, speeds=speeds,
        )

    def plan_migrations(
        self, t: float, cluster: ClusterState, candidates: list
    ) -> List[Migration]:
        if not self.migrate:
            return []
        penalty = self.migration_penalty
        migs: List[Migration] = []
        # Queue-aware guard: resolve the ready-queue head once per sweep
        # (migrations never mutate the queue, so it stays valid).  The
        # head's predicted duration is the opportunity cost every
        # accepted migration is charged against.
        head = head_work = None
        if self.migration_queue_guard:
            head = self.migration_queue_head(t)
            if head is not None:
                _, a_min = self.alpha_cache.bounds(head)
                head_work = self.predictor.predict(head) * a_min
        # Shared snapshot-or-select ladder (same protocol as A-SRPT step
        # 2): any actual migration changes the free state and resets it.
        ladder = ConsolidatingLadder(
            cluster, self.cluster_spec, ranks=cluster.effective_bw_ranks
        )
        for r in candidates:
            g = r.job.g
            if g > cluster.total_free:
                continue  # nowhere to go; finish in place
            caps = ladder.caps_for(g)
            speeds = cluster.speeds_for(caps)
            placement, a_new = self._map_migration(r.job, caps, speeds)
            # Online information only: under the prediction loop the
            # policy races *predicted* remaining iterations (what it
            # believes), not the simulator's true bookkeeping — believing
            # a job nearly done keeps it in place; an overrun re-estimate
            # re-opens the race on a later pass.  Legacy runs
            # (pred_rem None) keep racing true remaining work verbatim.
            rem = r.pred_rem if r.pred_rem is not None else r.iters_rem
            stay = rem * r.alpha
            if r.since > t:
                # mid-restart from an earlier migration: finishing in
                # place still owes the rest of that downtime
                stay += r.since - t
            move = penalty + rem * a_new
            if move >= stay - 1e-12:
                continue
            if head is not None and head.g <= g and head_work < move:
                # the queued job fits in the claimed caps and finishes
                # sooner than the migrant would occupy them: let the next
                # pass start it instead (the migrant is re-offered later)
                continue
            cluster.release(r.job.job_id)
            cluster.allocate(r.job.job_id, placement, counts=dict(caps))
            migs.append(Migration(r.job, placement, a_new, penalty))
            ladder.reset()
        return migs
