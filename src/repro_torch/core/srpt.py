"""Preemptive single-machine SRPT — the virtual instances A1 / A1-tilde.

The paper maps the cluster problem onto a hypothetical single machine where
job ``i`` has work ``(g_i / G) * n_i * alpha_i_min`` (instance A1) or, with
predicted iterations, ``(g_i / G) * n_tilde_i * alpha_i_min`` (A1-tilde).
On heterogeneous clusters ``G`` is the class-weighted total GPU count and
``alpha_i_min`` the Heavy-Edge estimate on the biggest/fastest-NIC servers
(see heavy_edge.consolidated_caps) — the virtual machine itself stays a
unit-speed single machine.
Preemptive SRPT is optimal for total completion time on one machine; the
*virtual completion order* then drives the real scheduler.

``VirtualSRPT`` is an online incremental simulator: jobs arrive with a work
amount; ``advance(t)`` returns jobs that complete by ``t``; the next virtual
completion time is exposed so the event-driven cluster simulator can wake
the policy exactly when the pending queue grows.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple


class VirtualSRPT:
    """Incremental preemptive SRPT on a unit-speed single machine.

    ``keep_history=False`` drops the ``completion_times`` log (an
    O(all-jobs) dict nothing in the online pipeline reads — A-SRPT only
    consumes the ``advance`` backlog), keeping memory bounded by the
    *live* virtual queue on million-job streams.  The offline helper
    ``srpt_total_completion`` is the one history consumer.
    """

    def __init__(self, keep_history: bool = True) -> None:
        # (remaining_work, tiebreak_seq, job_id)
        self._heap: List[Tuple[float, int, int]] = []
        self._seq = itertools.count()
        self._now = 0.0
        self.completion_times: Optional[Dict[int, float]] = (
            {} if keep_history else None
        )
        self._unreleased: List[Tuple[float, int]] = []  # completion backlog

    def _complete(self, jid: int, t: float) -> None:
        if self.completion_times is not None:
            self.completion_times[jid] = t
        self._unreleased.append((t, jid))

    def arrive(self, t: float, job_id: int, work: float) -> None:
        if t + 1e-12 < self._now:
            raise ValueError(f"arrival at {t} before current time {self._now}")
        self._run_until(t)
        if work <= 0.0:
            # Zero predicted work (unseen job): completes instantly.
            self._complete(job_id, t)
        else:
            heapq.heappush(self._heap, (work, next(self._seq), job_id))

    def _run_until(self, t: float) -> None:
        """Execute the machine from self._now to t (no arrivals inside)."""
        while self._heap and self._now < t:
            rem, seq, jid = self._heap[0]
            dt = t - self._now
            if rem <= dt + 1e-9:  # absolute-seconds tolerance (ulp guard)
                heapq.heappop(self._heap)
                self._now += rem
                self._complete(jid, self._now)
            else:
                heapq.heapreplace(self._heap, (rem - dt, seq, jid))
                self._now = t
        self._now = max(self._now, t)

    def advance(self, t: float) -> List[Tuple[float, int]]:
        """Run to ``t``; return the completion backlog [(time, job_id)],
        ordered by completion time (arrival order breaks ties)."""
        self._run_until(t)
        done = self._unreleased
        self._unreleased = []
        done.sort(key=lambda cj: cj[0])
        return done

    def next_completion_time(self) -> Optional[float]:
        """Time of the next completion assuming no further arrivals."""
        if not self._heap:
            return None
        return self._now + self._heap[0][0]

    @property
    def is_idle(self) -> bool:
        """No queued work and no unreleased completions: advance is a no-op."""
        return not self._heap and not self._unreleased

    @property
    def now(self) -> float:
        return self._now


def srpt_total_completion(
    jobs: List[Tuple[int, float, float]]
) -> Tuple[float, Dict[int, float]]:
    """Offline helper: total completion time of preemptive SRPT.

    ``jobs``: (job_id, arrival, work). Returns (sum of completions, per-job
    completion times). Used by tests to check optimality against brute force.
    """
    vm = VirtualSRPT()
    for jid, r, w in sorted(jobs, key=lambda x: x[1]):
        vm.arrive(r, jid, w)
    vm.advance(float("inf"))
    total = sum(vm.completion_times.values())
    return total, dict(vm.completion_times)
