"""Job model for DDLwMP (distributed DL with mixed parallelisms) scheduling.

Mirrors the paper's Section III system model:

* a job ``i`` trains a DNN for ``n_i`` iterations, split into ``S_i``
  pipeline stages; stage ``s`` is replicated over ``k_{i,s}`` accelerators
  (data parallelism inside the stage), so the job needs
  ``g_i = sum_s k_{i,s}`` accelerators in total;
* per-stage profile: forward/backward compute time ``p_f``/``p_b`` (seconds
  per mini-batch on one replica), per-iteration in/out activation bytes
  ``d_in``/``d_out`` per replica, and trainable-parameter bytes ``h``.

A single-GPU job is a job with one non-replicated stage.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

RAR = "rar"  # ring all-reduce
TAR = "tar"  # (double binary) tree all-reduce

# process-wide intern table for JobSpec.config_key (see below)
_CONFIG_IDS: dict = {}


def _intern_config(key: tuple) -> int:
    cid = _CONFIG_IDS.get(key)
    if cid is None:
        cid = len(_CONFIG_IDS)
        _CONFIG_IDS[key] = cid
    return cid


@dataclass(frozen=True)
class StageSpec:
    """Profile of a single pipeline stage (see paper Sec. III-A)."""

    p_f: float  # forward time per mini-batch, seconds
    p_b: float  # backward time per mini-batch, seconds
    d_in: float  # incoming activation bytes per iteration per replica
    d_out: float  # outgoing activation/gradient bytes per iteration per replica
    h: float  # trainable parameter bytes of this stage
    k: int = 1  # number of data-parallel replicas (== GPUs for this stage)

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"stage replica count must be >= 1, got {self.k}")
        for name in ("p_f", "p_b", "d_in", "d_out", "h"):
            if getattr(self, name) < 0:
                raise ValueError(f"stage field {name} must be non-negative")


@dataclass(frozen=True)
class JobSpec:
    """A DDLwMP job: model stages + arrival + (true) iteration count.

    ``n_iters`` is the *actual* number of training iterations, unknown to the
    scheduler until completion; schedulers must rely on a prediction.
    """

    job_id: int
    stages: Tuple[StageSpec, ...]
    n_iters: int
    arrival: float = 0.0
    group_id: int = -1  # recurrence group (hash of meta-info); -1 = unseen
    user_id: int = 0
    allreduce: str = RAR  # RAR or TAR intra-stage synchronization
    model_name: str = ""

    def __post_init__(self) -> None:
        if not self.stages:
            raise ValueError("job must have at least one stage")
        if self.n_iters < 1:
            raise ValueError("job must run at least one iteration")
        if self.allreduce not in (RAR, TAR):
            raise ValueError(f"unknown allreduce kind {self.allreduce!r}")

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @functools.cached_property
    def g(self) -> int:
        """Total accelerators required: g_i = sum_s k_{i,s}.

        cached_property writes to the instance ``__dict__`` directly, which
        is allowed on frozen dataclasses — ``g`` is read on every capacity
        check in the scheduling hot path.
        """
        return sum(st.k for st in self.stages)

    @functools.cached_property
    def config_key(self) -> int:
        """Small interned id of the *structural* config (stages, allreduce).

        Jobs with equal config ids map identically onto equal server
        capacities; caches key on this id instead of re-hashing the whole
        stage tuple on every probe (recurring MLaaS jobs share configs, so
        the intern table stays small).
        """
        return _intern_config((self.stages, self.allreduce))

    @property
    def is_single_gpu(self) -> bool:
        return self.g == 1

    def with_iters(self, n_iters: int) -> "JobSpec":
        return dataclasses.replace(self, n_iters=n_iters)

    def replica_vertices(self) -> Sequence[Tuple[int, int]]:
        """Vertices of the job graph: (stage_index, replica_index)."""
        return [
            (s, r) for s, st in enumerate(self.stages) for r in range(st.k)
        ]


@dataclass(frozen=True)
class ServerClass:
    """One generation/SKU of servers in a heterogeneous cluster.

    Real GPU datacenters mix generations (mixed per-node GPU counts and NIC
    speeds — Hu et al., arXiv 2109.01313); a ``ClusterSpec`` is a sequence
    of these classes.  ``b_intra == 0`` inherits the cluster-wide intra
    bandwidth.
    """

    count: int  # servers of this class
    gpus_per_server: int
    b_inter: float  # NIC bandwidth of this class, bytes/s
    b_intra: float = 0.0  # 0.0 -> inherit ClusterSpec.b_intra
    name: str = ""  # e.g. "a100x8"

    def __post_init__(self) -> None:
        if self.count < 1 or self.gpus_per_server < 1:
            raise ValueError("server class needs >= 1 server and >= 1 GPU")
        if self.b_inter <= 0 or self.b_intra < 0:
            raise ValueError("class bandwidths must be positive")


# (gpus_per_server, b_inter, b_intra) of one server — the only attributes
# the timing model reads (the ``geom``/``geoms`` params in timing.py).
ServerGeom = Tuple[int, float, float]


def build_bw_ranks(
    bandwidths: Sequence[float],
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Per-server positions in the ``(-bw, id)`` and ``(bw, id)`` orderings.

    The one definition of the ``select_servers`` bandwidth-tiebreak rank
    construction, shared by the static ``ClusterSpec.bw_order_ranks``
    (class NIC bandwidths) and the dynamic
    ``ClusterState.effective_bw_ranks`` (bandwidth x speed factor).
    """
    n = len(bandwidths)
    desc = sorted(range(n), key=lambda m: (-bandwidths[m], m))
    asc = sorted(range(n), key=lambda m: (bandwidths[m], m))
    desc_rank = [0] * n
    asc_rank = [0] * n
    for r, m in enumerate(desc):
        desc_rank[m] = r
    for r, m in enumerate(asc):
        asc_rank[m] = r
    return tuple(desc_rank), tuple(asc_rank)


@dataclass(frozen=True)
class ClusterSpec:
    """Cluster of M servers (paper Sec. III, extended to mixed generations).

    The paper models a homogeneous cluster (one ``gpus_per_server``, one
    NIC bandwidth); that remains the default construction.  Passing
    ``server_classes`` generalizes to a heterogeneous cluster: server ids
    are laid out class by class in the order given (class 0 owns ids
    ``[0, count_0)``, class 1 the next ``count_1`` ids, ...).  For a
    heterogeneous spec ``gpus_per_server`` must be the *maximum* per-server
    count and ``b_inter`` the *minimum* NIC bandwidth (the conservative
    values every homogeneous-era formula degrades to); use
    ``ClusterSpec.heterogeneous`` to get those invariants for free.
    """

    num_servers: int  # M
    gpus_per_server: int  # g (max per-server count when heterogeneous)
    b_inter: float  # NIC bandwidth, bytes/s (min over classes when het.)
    b_intra: float  # intra-server (NVLink/ICI) bandwidth, bytes/s
    server_classes: Tuple[ServerClass, ...] = ()

    def __post_init__(self) -> None:
        if self.num_servers < 1 or self.gpus_per_server < 1:
            raise ValueError("cluster must have >= 1 server and >= 1 GPU each")
        if self.b_inter <= 0 or self.b_intra <= 0:
            raise ValueError("bandwidths must be positive")
        if self.server_classes:
            if sum(c.count for c in self.server_classes) != self.num_servers:
                raise ValueError("server class counts must sum to num_servers")
            if max(c.gpus_per_server for c in self.server_classes) != (
                self.gpus_per_server
            ):
                raise ValueError(
                    "gpus_per_server must be the max over server classes"
                )
            if min(c.b_inter for c in self.server_classes) != self.b_inter:
                raise ValueError(
                    "b_inter must be the min over server classes"
                )

    @classmethod
    def heterogeneous(
        cls, classes: Sequence[ServerClass], b_intra: float
    ) -> "ClusterSpec":
        """Build a mixed-generation spec; derives the scalar summary fields."""
        classes = tuple(classes)
        if not classes:
            raise ValueError("need at least one server class")
        return cls(
            num_servers=sum(c.count for c in classes),
            gpus_per_server=max(c.gpus_per_server for c in classes),
            b_inter=min(c.b_inter for c in classes),
            b_intra=b_intra,
            server_classes=classes,
        )

    @property
    def is_heterogeneous(self) -> bool:
        return bool(self.server_classes)

    @functools.cached_property
    def _class_bounds(self) -> Tuple[int, ...]:
        """Cumulative server-id upper bound per class (for bisect lookup)."""
        bounds = []
        acc = 0
        for c in self.server_classes:
            acc += c.count
            bounds.append(acc)
        return tuple(bounds)

    @functools.cached_property
    def _class_geoms(self) -> Tuple[ServerGeom, ...]:
        return tuple(
            (c.gpus_per_server, c.b_inter, c.b_intra or self.b_intra)
            for c in self.server_classes
        )

    def class_of(self, server_id: int) -> int:
        """Class index of server ``server_id`` (0 on homogeneous specs)."""
        if not self.server_classes:
            return 0
        return bisect.bisect_right(self._class_bounds, server_id)

    def server_gpus(self, server_id: int) -> int:
        if not self.server_classes:
            return self.gpus_per_server
        return self._class_geoms[self.class_of(server_id)][0]

    def server_geom(self, server_id: int) -> ServerGeom:
        """(gpus, b_inter, b_intra) of one server; see timing.py."""
        if not self.server_classes:
            return (self.gpus_per_server, self.b_inter, self.b_intra)
        return self._class_geoms[self.class_of(server_id)]

    def class_geom(self, class_id: int) -> ServerGeom:
        if not self.server_classes:
            return (self.gpus_per_server, self.b_inter, self.b_intra)
        return self._class_geoms[class_id]

    @functools.cached_property
    def total_gpus(self) -> int:  # G
        if self.server_classes:
            return sum(c.count * c.gpus_per_server for c in self.server_classes)
        return self.num_servers * self.gpus_per_server

    @functools.cached_property
    def bw_order_ranks(self) -> "Tuple[Tuple[int, ...], Tuple[int, ...]]":
        """Per-server positions in the ``(-b_inter, id)`` and
        ``(b_inter, id)`` orderings — the ``select_servers`` bandwidth
        tiebreaks, precomputed once so the per-event hot path sorts
        buckets on a plain indexed int key instead of a geometry lookup.
        """
        return build_bw_ranks(
            [self.server_geom(m)[1] for m in range(self.num_servers)]
        )


Placement = dict  # {server_id: np.ndarray[S_i]} -- x_{i,s}^m, see timing.py
