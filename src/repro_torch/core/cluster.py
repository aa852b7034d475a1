"""Mutable cluster state for the schedulers/simulator.

Change-tracking for incremental schedulers (see asrpt.py): every mutation
bumps ``epoch``.  While ``epoch`` is unchanged a policy may reuse any
decision that is a pure function of the free-capacity state; nothing
weaker is sound — in particular "only releases can improve a placement"
does NOT hold, because Heavy-Edge is greedy and shrinking capacities can
reshuffle the selected capacity vector into one the greedy maps better.

Degradation (straggler) state: ``set_server_speed`` records a per-server
speed factor in (0, 1] ∪ (1, ∞) that scales the server's *effective*
compute and NIC bandwidth — every stage term evaluated on that server
stretches by ``1/factor`` (see timing.py).  GPU *counts* are unaffected:
a half-speed server still holds its GPUs, they just run slower.  A
factor of exactly ``0.0`` is a full failure and degrades to
``mark_server_down`` (the fault path).  Speed changes bump
``epoch`` (placement decisions depend on them) and a separate
``speed_version`` so policies can cheaply detect "speeds changed while
caps stayed equal".

Elastic capacity (ServerJoin/ServerLeave scenario events, scenario.py):
``drain_server`` starts a *graceful* leave — free capacity is withdrawn
immediately (no new allocations) but the server keeps computing, so
running jobs are unaffected (and remain migratable off it, unlike a
dead server whose checkpoint state is lost); ``finish_drain`` ends the
window (the server is then down for good).  ``activate_server``
resurrects any inactive slot — a drained, left, or failed server —
restoring its class capacity minus GPUs still held by running jobs.  A
server rejoining from *down* starts clean at speed 1.0 (replacement
hardware); one rejoining from a cancelled *drain* keeps its speed
factor (it never stopped).  Three disjoint server states follow:
active, draining (no free caps, still computing), down (no free caps,
not computing); ``_inactive`` is draining ∪ down — the one set the
release/allocation paths consult.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .job import ClusterSpec, build_bw_ranks


class ClusterState:
    """Tracks free GPUs per server and per-job allocations.

    Alongside the ``free`` dict the state maintains ``free_buckets`` —
    server ids grouped by free-GPU count, ascending ids within a bucket
    (the exact structure ``heavy_edge.select_servers`` builds per call) —
    so per-event server selection walks the buckets directly instead of
    re-sorting all servers.  Buckets update in O(servers touched) per
    allocate/release; ascending-id order is preserved by ``bisect.insort``
    and matches dict-iteration order (ids are inserted 0..M-1 and never
    removed), keeping bucket-based selection bit-identical.
    """

    def __init__(self, spec: ClusterSpec):
        self.spec = spec
        if spec.is_heterogeneous:
            # per-server capacity follows the server's class
            self._cap: Dict[int, int] = {
                m: spec.server_gpus(m) for m in range(spec.num_servers)
            }
        else:
            self._cap = {
                m: spec.gpus_per_server for m in range(spec.num_servers)
            }
        self.free: Dict[int, int] = dict(self._cap)
        self.free_buckets: List[List[int]] = [
            [] for _ in range(spec.gpus_per_server + 1)
        ]
        for m in range(spec.num_servers):  # ascending ids per bucket
            self.free_buckets[self.free[m]].append(m)
        self._job_alloc: Dict[int, Dict[int, int]] = {}
        self.total_free: int = spec.total_gpus
        self._down: set = set()
        self._draining: set = set()
        self._inactive: set = set()  # _down | _draining, maintained inline
        self.epoch: int = 0
        # sparse straggler state: only servers with factor != 1.0 appear
        self._speed: Dict[int, float] = {}
        self.speed_version: int = 0
        self._bw_ranks: Optional[Tuple[tuple, tuple]] = None

    def _move_bucket(self, m: int, old: int, new: int) -> None:
        if old > 0:
            self.free_buckets[old].remove(m)
        if new > 0:
            bisect.insort(self.free_buckets[new], m)

    def can_fit(self, g_needed: int) -> bool:
        return self.total_free >= g_needed

    def allocate(
        self,
        job_id: int,
        placement: Mapping[int, np.ndarray],
        counts: Optional[Dict[int, int]] = None,
    ) -> None:
        """Reserve GPUs for ``placement``.

        ``counts`` optionally supplies the per-server GPU totals (callers
        that selected capacities already know them; ownership transfers to
        the cluster state — don't mutate it afterwards); otherwise they
        are summed from the placement vectors.
        """
        free = self.free
        if counts is not None:
            per_server = counts
        else:
            per_server = {
                m: int(x.sum()) if isinstance(x, np.ndarray)
                else int(np.asarray(x).sum())
                for m, x in placement.items()
            }
        for m, n in per_server.items():
            if n > free.get(m, 0):
                raise ValueError(
                    f"server {m} has {free.get(m, 0)} free GPUs, "
                    f"job {job_id} wants {n}"
                )
        total = 0
        for m, n in per_server.items():
            old = free[m]
            free[m] = old - n
            self._move_bucket(m, old, old - n)
            total += n
        self.total_free -= total
        self._job_alloc[job_id] = per_server
        self.epoch += 1

    def release(self, job_id: int) -> None:
        cap = self._cap
        gone = self._inactive
        total = 0
        for m, n in self._job_alloc.pop(job_id).items():
            if m in gone:
                continue  # capacity on a failed/leaving server never returns
            old = self.free[m]
            self.free[m] = old + n
            self._move_bucket(m, old, old + n)
            total += n
            if self.free[m] > cap[m]:
                raise AssertionError(f"server {m} over-freed")
        self.total_free += total
        self.epoch += 1

    def mark_server_down(self, server_id: int) -> None:
        """Fault-tolerance hook: a failed server contributes no capacity.

        Free GPUs are removed immediately; GPUs still held by running jobs
        are forfeited as those jobs release (they never rejoin ``free``).
        """
        if server_id not in self.free:
            raise ValueError(
                f"unknown server {server_id} "
                f"(cluster has {self.spec.num_servers})"
            )
        if server_id in self._down:
            return
        self._draining.discard(server_id)  # a drain overtaken by failure
        self._down.add(server_id)
        self._inactive.add(server_id)
        if self._speed.pop(server_id, None) is not None:
            # a dead straggler is just dead: its speed no longer matters,
            # and dropping it lets a now-clean cluster take the fast path
            self._bw_ranks = None
            self.speed_version += 1
        old = self.free[server_id]
        self.total_free -= old
        self.free[server_id] = 0
        self._move_bucket(server_id, old, 0)
        self.epoch += 1

    def drain_server(self, server_id: int) -> bool:
        """Elastic hook: begin a graceful leave (``ServerLeave``).

        Free capacity is withdrawn at once (no new allocations land
        here) and GPUs held by running jobs are forfeited as they
        release — exactly the ``mark_server_down`` capacity semantics —
        but the server *keeps computing*: running jobs are neither
        re-timed nor stranded, and the simulator offers them to
        ``plan_migrations`` while the drain window is open.  Returns
        True when state changed (False for an already-inactive server).
        """
        if server_id not in self.free:
            raise ValueError(
                f"unknown server {server_id} "
                f"(cluster has {self.spec.num_servers})"
            )
        if server_id in self._inactive:
            return False  # already down or draining
        self._draining.add(server_id)
        self._inactive.add(server_id)
        old = self.free[server_id]
        self.total_free -= old
        self.free[server_id] = 0
        self._move_bucket(server_id, old, 0)
        self.epoch += 1
        return True

    def finish_drain(self, server_id: int) -> bool:
        """Close a drain window: the server is now gone for good.

        Capacity effects all happened at ``drain_server``; this only
        flips draining -> down (jobs still on it finish in place and can
        no longer checkpoint-restart — their state leaves with the
        server) and drops the speed entry like ``mark_server_down``
        does.  No epoch bump: free capacity is unchanged.
        """
        if server_id not in self._draining:
            return False
        self._draining.discard(server_id)
        self._down.add(server_id)
        if self._speed.pop(server_id, None) is not None:
            self._bw_ranks = None
            self.speed_version += 1
        return True

    def activate_server(self, server_id: int) -> bool:
        """Elastic hook: an inactive server slot comes online
        (``ServerJoin``) with its class capacity minus GPUs still held
        by running jobs (those return to ``free`` as the jobs release,
        now that the server is active again).  Resurrects drained, left,
        *and* failed slots — a join on a downed slot models replacement
        hardware arriving at the same spec position (clean, speed 1.0).
        Returns True when state changed (False if already active — a
        no-op join triggers no scheduling pass).
        """
        if server_id not in self.free:
            raise ValueError(
                f"unknown server {server_id} "
                f"(cluster has {self.spec.num_servers})"
            )
        if server_id not in self._inactive:
            return False
        self._down.discard(server_id)
        self._draining.discard(server_id)
        self._inactive.discard(server_id)
        held = 0
        for alloc in self._job_alloc.values():
            held += alloc.get(server_id, 0)
        new_free = self._cap[server_id] - held
        old = self.free[server_id]  # 0 while inactive
        self.free[server_id] = new_free
        self._move_bucket(server_id, old, new_free)
        self.total_free += new_free - old
        self.epoch += 1
        return True

    def set_server_speed(self, server_id: int, factor: float) -> bool:
        """Degradation hook: scale a server's effective speed by ``factor``.

        ``factor == 1.0`` restores full speed (recovery), ``factor == 0.0``
        is a full failure and takes the ``mark_server_down`` path verbatim.
        Returns True when the state actually changed — a repeated event
        with the server's current factor is a no-op (no epoch bump), so
        all-1.0 degradation schedules stay bit-identical to clean runs.
        """
        if server_id not in self.free:
            raise ValueError(
                f"unknown server {server_id} "
                f"(cluster has {self.spec.num_servers})"
            )
        if factor < 0.0:
            raise ValueError(f"speed factor must be >= 0, got {factor}")
        if factor == 0.0:
            if server_id in self._down:
                return False
            self.mark_server_down(server_id)
            return True
        if server_id in self._down:
            return False  # dead servers don't recover (restart = new server)
        if factor == self._speed.get(server_id, 1.0):
            return False
        if factor == 1.0:
            del self._speed[server_id]
        else:
            self._speed[server_id] = factor
        self._bw_ranks = None
        self.speed_version += 1
        self.epoch += 1
        return True

    @property
    def has_degraded(self) -> bool:
        return bool(self._speed)

    @property
    def speed_factors(self) -> Dict[int, float]:
        """Sparse {server_id: factor} map (only factors != 1.0); treat as
        read-only — the timing layer takes it as the ``speeds`` mapping."""
        return self._speed

    def speed_of(self, server_id: int) -> float:
        return self._speed.get(server_id, 1.0)

    def speeds_for(
        self, caps: Sequence[Tuple[int, int]]
    ) -> Optional[Tuple[float, ...]]:
        """Per-slot factors aligned with a ``select_servers`` capacity
        vector, or None when no server is degraded (the clean fast path —
        callers skip speed threading entirely)."""
        sp = self._speed
        if not sp:
            return None
        get = sp.get
        return tuple(get(m, 1.0) for m, _c in caps)

    @property
    def effective_bw_ranks(self) -> Optional[Tuple[tuple, tuple]]:
        """(descending, ascending) effective-bandwidth rank tuples for the
        ``select_servers`` tiebreak, where effective bandwidth is the
        class NIC bandwidth times the server's speed factor.  None while
        no server is degraded — callers then fall back to the static
        ``ClusterSpec.bw_order_ranks`` (heterogeneous) or no tiebreak
        (homogeneous), keeping clean schedules byte-identical.
        """
        if not self._speed:
            return None
        ranks = self._bw_ranks
        if ranks is None:
            spec = self.spec
            sp = self._speed
            ranks = self._bw_ranks = build_bw_ranks(
                [
                    spec.server_geom(m)[1] * sp.get(m, 1.0)
                    for m in range(spec.num_servers)
                ]
            )
        return ranks

    @property
    def downed_servers(self) -> frozenset:
        return frozenset(self._down)

    @property
    def draining_servers(self) -> frozenset:
        return frozenset(self._draining)

    def snapshot_free(self) -> Dict[int, int]:
        return dict(self.free)
