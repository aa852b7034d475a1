"""A-SRPT: adaptive shortest-remaining-processing-time-first (paper Alg. 1).

Pipeline of decisions per scheduling event:

1. advance the virtual single machine (instance A1-tilde, preemptive SRPT on
   predicted scaled work ``(g_i/G) n~_i alpha~_i^min``) to the current time;
   newly (virtually) completed jobs join ``pending_queue`` in completion
   order — this is the release order for the real cluster;
2. re-evaluate *delayed* communication-heavy jobs: start if the achievable
   per-iteration time improved (``alpha < kappa``), dropped under the
   COMM_HEAVY ratio, or the delay budget ``tau (g_i/G) n~_i alpha~_i^min``
   expired;
3. pop the head of ``pending_queue`` while it fits:
   - communication-heavy (``alpha_max / alpha~_min >= COMM_HEAVY``): place on
     the *most*-available servers (consolidation); if still comm-heavy,
     delay (step 2 takes over);
   - otherwise: place on the *least*-available servers (fragmentation-aware)
     and start immediately.

Incremental evaluation (trace scale, default on): a delayed job's
evaluation is a pure function of the capacity vector ``select_servers``
returns for it, so it is skipped outright while the cluster state — and
hence that vector — is unchanged (``ClusterState.epoch``), re-selected
but not re-mapped when the vector comes back equal, and answered from the
memoized Heavy-Edge mapping (``heavy_edge.PlacementCache``) otherwise.
(Note a *stronger* skip — "allocations can only worsen alpha, so only
releases invalidate" — is unsound: Heavy-Edge is greedy, and shrinking
capacities can reshuffle the selected vector into one greedy maps
better.)  Deadline expiry is checked unconditionally.  The schedule is
bit-identical to exhaustive re-evaluation (property-tested in
tests/test_sched_cache.py) while per-event work drops by an order of
magnitude on congested traces.

Degraded clusters (stragglers, see cluster.py): while any server carries
a speed factor != 1.0, server selection tie-breaks by *effective*
bandwidth, placements are evaluated (and cached) per speed signature,
and the step-2 skip keys on (caps, speeds) so a speed change alone
re-evaluates delayed jobs.  All of it is gated on
``cluster.has_degraded`` — clean passes run the original code paths
byte for byte.  With ``migrate=True`` the policy also checkpoint-
restarts running jobs off degraded capacity (migration.py).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .cluster import ClusterState
from .heavy_edge import (
    ConsolidatingLadder,
    PlacementCache,
    map_job_canonical,
    select_servers,
)
from .job import ClusterSpec, JobSpec
from .migration import MIGRATION_PENALTY_DEFAULT, MigrationMixin
from .predictor import IterationPredictor
from .simulator import Policy, Start
from .srpt import VirtualSRPT

COMM_HEAVY_DEFAULT = 1.5


class _Delayed:
    __slots__ = ("job", "kappa", "deadline", "eval_epoch", "eval_caps")

    def __init__(self, job: JobSpec, kappa: float, deadline: float):
        self.job = job
        self.kappa = kappa
        self.deadline = deadline
        # cluster.epoch and (selected caps, their speed factors, the
        # admission a_min bound) at the last placement evaluation.  While
        # the cluster is unchanged — or changes leave the capacity vector,
        # those servers' speeds, and the degradation-aware bound all
        # identical — the evaluation outcome is unchanged (the mapping is
        # a pure function of caps + speeds; the decision additionally
        # reads the bound).
        self.eval_epoch = -1
        self.eval_caps: Optional[tuple] = None


class ASRPTPolicy(MigrationMixin, Policy):
    def __init__(
        self,
        predictor: IterationPredictor,
        comm_heavy: float = COMM_HEAVY_DEFAULT,
        tau: float = 2.0,
        refine_mapping: bool = False,  # beyond-paper local-search swaps
        placement_cache: bool = True,  # incremental eval + memoized mapping
        migrate: bool = False,  # checkpoint-restart off degraded servers
        migration_penalty: float = MIGRATION_PENALTY_DEFAULT,
        # queue-aware race (migration.py).  Default stays False: the
        # `sched_scale --guard` A/B at 20k-job straggler scale measured
        # flow_vs_unguarded = 1.20 — deferring migrations behind a deep
        # queue (peak ~13k) starves stretched jobs of healthy capacity.
        migration_queue_guard: bool = False,
        degraded_admission: bool = True,  # speed-aware alpha bounds (AlphaCache)
        # Heterogeneity-aware server *selection*:
        # score candidate capacity vectors by mapped alpha across server
        # classes instead of only tie-breaking by NIC bandwidth within
        # equal free counts.  Opt-in: it changes schedules, and the
        # golden fixtures pin the default.  Only bites on heterogeneous
        # clusters (homogeneous specs have a single class).
        hetero_selection: bool = False,
    ):
        self.predictor = predictor
        self.comm_heavy = comm_heavy
        self.tau = tau
        self.refine_mapping = refine_mapping
        self.placement_cache = placement_cache
        self.migrate = migrate
        self.migration_penalty = migration_penalty
        self.migration_queue_guard = migration_queue_guard
        self.degraded_admission = degraded_admission
        self.hetero_selection = hetero_selection
        # prediction-loop opt-in (simulator.Policy / prediction_loop):
        # derived from the predictor so plain predictors keep the legacy
        # engine byte for byte
        self.track_overruns = bool(getattr(predictor, "track_overruns", False))
        # no history: the vm's completion log is unread here, and dropping
        # it keeps policy memory bounded by the live queue on job streams
        self.vm = VirtualSRPT(keep_history=False)
        self.pending: Deque[JobSpec] = deque()
        self.delayed: "OrderedDict[int, _Delayed]" = OrderedDict()
        self._by_id: Dict[int, JobSpec] = {}
        self._pred_work: Dict[int, float] = {}
        # (deadline, job_id) heap over self.delayed; stale entries (started
        # jobs) and past deadlines are pruned lazily.  Used by next_wakeup
        # and by the step-2 settled-epoch gate.
        self._dheap: List[tuple] = []
        # cluster.epoch at the end of the last scheduling pass that started
        # nothing: while unchanged, every delayed job's evaluation would
        # repeat verbatim, so step 2 is skipped outright (deadline expiry
        # aside).  Only consulted in incremental mode.
        self._settled_epoch: int = -1

    def bind(self, cluster_spec: ClusterSpec) -> None:
        super().bind(cluster_spec)
        # built through the Policy helpers so a fleet run (fleet_shared
        # set) hands out fleet-shared caches instead of cold private ones
        self.alpha_cache = self._make_alpha_cache(cluster_spec)
        self._pcache: Optional[PlacementCache] = (
            self._make_placement_cache(
                cluster_spec, refine=self.refine_mapping
            )
            if self.placement_cache
            else None
        )
        self._hetero_sel = self.hetero_selection and cluster_spec.is_heterogeneous
        if self._hetero_sel:
            by_cls: Dict[int, List[int]] = {}
            for m in range(cluster_spec.num_servers):
                by_cls.setdefault(cluster_spec.class_of(m), []).append(m)
            self._class_servers = [by_cls[c] for c in sorted(by_cls)]

    # -- event hooks --------------------------------------------------------

    def on_arrival(self, t: float, job: JobSpec) -> None:
        n_pred = self.predictor.predict(job)
        _, a_min = self.alpha_cache.bounds(job)
        g_frac = job.g / self.cluster_spec.total_gpus
        work = g_frac * n_pred * a_min
        self._by_id[job.job_id] = job
        self._pred_work[job.job_id] = work
        self.vm.arrive(t, job.job_id, work)
        self._drain_vm(t)

    def on_completion(self, t: float, job: JobSpec) -> None:
        self.predictor.observe(job, job.n_iters)
        # a completed job's spec and predicted work are never read again
        # (virtual completion precedes the real start, which precedes this);
        # dropping them keeps policy state bounded by the live job count
        self._by_id.pop(job.job_id, None)
        self._pred_work.pop(job.job_id, None)

    def _drain_vm(self, t: float) -> None:
        vm = self.vm
        if vm.is_idle:
            return
        for _ct, jid in vm.advance(t):
            self.pending.append(self._by_id[jid])

    # -- placement helpers ---------------------------------------------------

    def _map(self, job: JobSpec, caps, speeds=None) -> tuple:
        if self._pcache is not None:
            return self._pcache.map_job(job, caps, speeds=speeds)
        # Uncached reference path: identical canonicalization, no memo,
        # and the retained pure-Python greedy/alpha pipeline — the cached
        # array-native engine must be bit-identical to this.
        return map_job_canonical(
            job, caps, self.cluster_spec, refine=self.refine_mapping,
            reference=True, speeds=speeds,
        )

    def _scored_consolidating(
        self, job: JobSpec, cluster: ClusterState, bw_ranks, speeds_for,
        caps: tuple, sp,
    ) -> tuple:
        """Score candidate capacity vectors by mapped alpha across server
        classes (hetero_selection).

        The default most-available-first pick (``caps``, already
        selected) competes with one class-restricted consolidation per
        server class whose free capacity alone holds the job: on a
        heterogeneous cluster the globally most-available servers are
        often the *slow-NIC* class (biggest servers drain last), while a
        comm-heavy job consolidated on fewer fast-NIC servers maps to a
        strictly better alpha.  Every candidate goes through the same
        memoized Heavy-Edge mapping; the lowest alpha wins, ties keep
        the default (deterministic: candidates are visited in fixed
        class order).  Returns ``(alpha, placement, caps, speeds)``.
        """
        placement, a = self._map(job, caps, sp)
        best = (a, placement, caps, sp)
        free = cluster.free
        g = job.g
        spec = self.cluster_spec
        seen = {caps}
        for servers in self._class_servers:
            cfree: Dict[int, int] = {}
            total = 0
            for m in servers:
                f = free.get(m, 0)
                if f > 0:
                    cfree[m] = f
                    total += f
            if total < g:
                continue  # this class alone cannot hold the job
            c_caps = tuple(
                select_servers(
                    cfree, g, consolidate=True, spec=spec, ranks=bw_ranks
                )
            )
            if c_caps in seen:
                continue
            seen.add(c_caps)
            c_sp = speeds_for(c_caps) if speeds_for else None
            c_pl, c_a = self._map(job, c_caps, c_sp)
            if c_a < best[0]:
                best = (c_a, c_pl, c_caps, c_sp)
        return best

    # -- main scheduling pass -------------------------------------------------

    def _min_deadline(self) -> Optional[float]:
        """Earliest deadline among still-delayed jobs (lazily pruned)."""
        h = self._dheap
        delayed = self.delayed
        while h:
            if h[0][1] in delayed:
                return h[0][0]
            heapq.heappop(h)  # job already started: stale entry
        return None

    def plan_pass(self, t: float, cluster: ClusterState) -> List[Start]:
        self._drain_vm(t)
        starts: List[Start] = []
        incremental = self._pcache is not None
        # Degradation-aware admission: classify against speed-aware alpha
        # bounds while any allocatable server is degraded (None on clean
        # clusters — the clean AlphaCache path runs byte-identical).
        bcluster = (
            cluster
            if self.degraded_admission and cluster.has_degraded
            else None
        )

        # Step 2: re-evaluate delayed communication-heavy jobs (Alg. 1 l.16-19).
        run_step2 = bool(self.delayed)
        if run_step2 and incremental and cluster.epoch == self._settled_epoch:
            # Cluster untouched since a pass where every delayed job stayed
            # delayed: re-evaluation would repeat verbatim.  Only a deadline
            # expiring at/before t can change an outcome.
            dl = self._min_deadline()
            run_step2 = dl is not None and t >= dl - 1e-12
        # Batched step-2 state (incremental mode): the consolidating pick
        # order is shared by every evaluation against one free state, so
        # the second evaluation onward carves its capacity vector from a
        # prefix-sum snapshot (``ConsolidatingLadder``; reset on every
        # start — the free state changed).  Jobs sharing (config, g) —
        # hence provably the same caps, placement, and alpha — share one
        # evaluation via ``memo``.
        memo: Dict[tuple, tuple] = {}
        spec = self.cluster_spec
        # Degradation state (None on clean clusters — every added branch
        # below degrades to the original clean code path): effective-
        # bandwidth ranks steer selection away from stragglers, per-slot
        # speed factors key the mapping.  Speeds only change between
        # passes (simulator events), never inside one.
        bw_ranks = cluster.effective_bw_ranks
        speeds_for = cluster.speeds_for if cluster.has_degraded else None
        ladder = ConsolidatingLadder(cluster, spec, ranks=bw_ranks)
        consolidating_caps = ladder.caps_for

        if run_step2:
            for jid in list(self.delayed.keys()):
                d = self.delayed[jid]
                g = d.job.g
                if g > cluster.total_free:
                    continue  # cannot fit yet; keep waiting
                expired = t >= d.deadline - 1e-12
                if incremental:
                    if not expired and d.eval_epoch == cluster.epoch:
                        # The evaluation is a pure function of the selected
                        # capacity vector; skip it when that provably
                        # didn't change.  (Sound under hetero_selection
                        # too: the epoch covers every free-count and
                        # speed change the scored choice reads.)
                        continue
                    caps = consolidating_caps(g)
                    sp = speeds_for(caps) if speeds_for else None
                    # a_min joins the skip signature: the degradation-aware
                    # bound shifts with speed changes *outside* the
                    # selected caps, so equal (caps, speeds) alone no
                    # longer implies an equal decision (clean runs see a
                    # constant — skip behavior there is unchanged)
                    _, a_min = self.alpha_cache.bounds(d.job, bcluster)
                    if not expired:
                        d.eval_epoch = cluster.epoch
                        if not self._hetero_sel:
                            if (caps, sp, a_min) == d.eval_caps:
                                continue  # same caps+speeds+bound -> same decision
                            d.eval_caps = (caps, sp, a_min)
                        # hetero_selection reads the *whole* free state:
                        # an equal default pick no longer implies an equal
                        # decision, so only the epoch skip applies
                    key = (d.job.config_key, g)
                    hit = memo.get(key)
                    if hit is None:
                        if self._hetero_sel:
                            hit = self._scored_consolidating(
                                d.job, cluster, bw_ranks, speeds_for,
                                caps, sp,
                            )
                        else:
                            placement, a = self._map(d.job, caps, sp)
                            hit = (a, placement, caps, sp)
                        memo[key] = hit
                    a, placement, caps, sp = hit
                else:
                    caps = tuple(
                        select_servers(
                            cluster.free, g,
                            consolidate=True, spec=spec,
                            ranks=bw_ranks,
                        )
                    )
                    sp = speeds_for(caps) if speeds_for else None
                    if self._hetero_sel:
                        a, placement, caps, sp = self._scored_consolidating(
                            d.job, cluster, bw_ranks, speeds_for, caps, sp
                        )
                    else:
                        placement, a = self._map(d.job, caps, sp)
                    _, a_min = self.alpha_cache.bounds(d.job, bcluster)
                if a < d.kappa or a / a_min <= self.comm_heavy or expired:
                    del self.delayed[jid]
                    starts.append(
                        Start(d.job, placement, a, n_pred=self._n_pred(d.job))
                    )
                    cluster.allocate(jid, placement, counts=dict(caps))
                    # free capacity changed: drop every per-state structure
                    ladder.reset()
                    memo = {}
                # else: stay delayed

        # Step 3: Alg. 1 main loop over the head of pending_queue.  The
        # consolidating snapshot stays valid across heads that delay
        # (delaying changes nothing) and is dropped on every allocation.
        while self.pending:
            job = self.pending[0]
            if job.g > cluster.total_free:
                break  # head-of-line blocking (Alg. 1 line 25)
            self.pending.popleft()
            a_max, a_min = self.alpha_cache.bounds(job, bcluster)
            if a_max / a_min >= self.comm_heavy:
                if incremental:
                    caps = consolidating_caps(job.g)
                else:
                    caps = tuple(
                        select_servers(
                            cluster.free, job.g,
                            consolidate=True, spec=spec,
                            ranks=bw_ranks,
                        )
                    )
                sp = speeds_for(caps) if speeds_for else None
                if self._hetero_sel:
                    a, placement, caps, sp = self._scored_consolidating(
                        job, cluster, bw_ranks, speeds_for, caps, sp
                    )
                else:
                    placement, a = self._map(job, caps, sp)
                delay_budget = self.tau * self._pred_work[job.job_id]
                if a / a_min <= self.comm_heavy or delay_budget <= 0.0:
                    starts.append(
                        Start(job, placement, a, n_pred=self._n_pred(job))
                    )
                    cluster.allocate(job.job_id, placement, counts=dict(caps))
                    ladder.reset()
                else:
                    d = _Delayed(job, kappa=a, deadline=t + delay_budget)
                    # Seed with this evaluation: caps were selected at the
                    # current cluster state, so step 2 can skip until the
                    # state (and the resulting caps or the admission
                    # bound) actually changes.
                    d.eval_epoch = cluster.epoch
                    d.eval_caps = (caps, sp, a_min)
                    self.delayed[job.job_id] = d
                    heapq.heappush(self._dheap, (d.deadline, job.job_id))
            else:
                if incremental:
                    caps = select_servers(
                        cluster.free, job.g,
                        consolidate=False, spec=spec,
                        buckets=cluster.free_buckets,
                        total_free=cluster.total_free,
                        ranks=bw_ranks,
                    )
                else:
                    caps = select_servers(
                        cluster.free, job.g,
                        consolidate=False, spec=spec,
                        ranks=bw_ranks,
                    )
                sp = speeds_for(caps) if speeds_for else None
                placement, a = self._map(job, caps, sp)
                starts.append(
                    Start(job, placement, a, n_pred=self._n_pred(job))
                )
                cluster.allocate(job.job_id, placement, counts=dict(caps))
                ladder.reset()

        # A pass that started nothing left the cluster exactly as it found
        # it; record the epoch so step 2 can skip until something changes.
        self._settled_epoch = cluster.epoch if not starts else -1
        return starts

    def next_wakeup(self, t: float) -> Optional[float]:
        eps = 1e-9 * max(1.0, abs(t))
        best: Optional[float] = None
        if not self.pending:
            # With a non-empty pending queue the head did not fit (strict
            # head-of-line), and virtual completions only append behind it —
            # a wake could not start anything, so don't schedule one.
            nxt = self.vm.next_completion_time()
            if nxt is not None:
                # The vm holds finite work; a completion at/behind t is
                # float-ulp residue — nudge once so it drains. (Bounded: the
                # residue job completes on that wake.)
                best = max(nxt, t + 1e-6)
        # Earliest future delay-deadline.  Entries already expired can only
        # start after a *real* completion event — never wake for them (a
        # nudge would busy-loop); prune so they don't mask later deadlines.
        h = self._dheap
        delayed = self.delayed
        while h:
            dl, jid = h[0]
            if jid not in delayed:
                heapq.heappop(h)  # stale: job started
                continue
            if dl <= t + eps:
                heapq.heappop(h)  # expired: real events drive it from here
                continue
            if best is None or dl < best:
                best = dl
            break
        return best

    def migration_queue_head(self, t: float) -> Optional[JobSpec]:
        """Queue-aware migration guard hook: the next job ``plan_pass``
        would pop.  The virtual machine is drained to ``t`` first so
        jobs whose virtual completion already passed are visible — the
        hook runs before the pass that would release them for real."""
        self._drain_vm(t)
        return self.pending[0] if self.pending else None

    def plan_preemptions(
        self, t: float, cluster: ClusterState, candidates, gpus_needed: int
    ):
        """Serving-lane preemption: pick comm-heavy victims.

        Only communication-heavy jobs (``alpha_max / alpha~_min >=
        comm_heavy`` — the same classification Alg. 1 consolidates and
        delays by) are evictable: they make the worst use of the GPUs a
        latency-bound replica needs, and their checkpoint-restart cost
        amortizes over the longest remaining runtimes.  Victims are
        ordered longest-predicted-remaining-first (remaining iterations
        x current alpha; job id breaks ties), and the list is truncated
        to the prefix whose hypothetically freed capacity first gives
        *some* active server ``gpus_needed`` free GPUs — if even evicting
        every comm-heavy job cannot host the replica, nothing is
        preempted (pointless evictions would only stretch training flow
        time).  The simulator owns the actual eviction (release +
        :meth:`on_preemption`); no allocations change here.
        """
        heavy = []
        for r in candidates:
            a_max, a_min = self.alpha_cache.bounds(r.job)
            if a_max / a_min >= self.comm_heavy:
                heavy.append(r)
        if not heavy:
            return []
        heavy.sort(key=lambda r: (-(r.iters_rem * r.alpha), r.job.job_id))
        inactive = cluster.downed_servers | cluster.draining_servers
        free = {
            m: f for m, f in cluster.free.items() if m not in inactive
        }
        out = []
        for r in heavy:
            out.append(r)
            for m, x in r.placement.items():
                if m in free:
                    free[m] += int(np.asarray(x).sum())
            if any(f >= gpus_needed for f in free.values()):
                return out
        return []

    def on_preemption(self, t: float, job: JobSpec) -> None:
        """An evicted job re-enters at the *head* of the release queue: it
        already virtually completed (that is why it was running), so it
        outranks everything the virtual machine has yet to release."""
        self.pending.appendleft(job)

    def queue_depth(self) -> int:
        return len(self.pending) + len(self.delayed)
