"""Per-iteration training-time model: paper Eqs. (4)-(7).

A *placement* is ``{server_id: x}`` where ``x`` is an int vector of length
``S_i`` with ``x[s] = x_{i,s}^m`` = number of GPUs that server ``m``
contributes to stage ``s``.  Constraint (2): ``sum_m x[s] == k_{i,s}``.

Per-stage, per-server time  beta_{i,s}^m = comp + comm + AllReduce:

* comp (Eq. 4):     ``p_f + p_b``                  if ``x_s^m > 0``
* comm (Eq. 5):     inter-server traffic over the reserved NIC share
                    ``(x_s^m / g) * B_inter`` plus co-located traffic over
                    ``B_intra``;
* AllReduce (Eq. 6): ring/tree all-reduce moves ``2 (k-1)/k * h`` bytes per
  replica; bottleneck bandwidth is the stage's reserved NIC share when the
  replicas span servers, else ``B_intra``.  (The published Eq. (6) is
  typographically ambiguous about the ``1/k`` factor; we keep the NCCL
  ``2(k-1)/k`` data-size model consistently, as in the graph edge weights.)

alpha_i (Eq. 7) = max over (server, stage) of beta — the bottleneck stage of
the fully-pipelined (asynchronous) execution.

Degradation (straggler) support: a per-server *speed factor* ``f`` models a
partially-degraded server (thermally throttled GPUs, slowed NIC).  It
scales the server's effective compute throughput and both bandwidths by
``f`` at once, so every stage term evaluated on that server stretches by
exactly ``1/f`` — the whole ``beta`` is divided by ``f`` as the final
operation, identically on the scalar reference and the array engine (the
two stay bit-identical under degradation).  ``speeds`` mappings are
sparse: absent servers are at full speed.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from .job import ClusterSpec, JobSpec, ServerGeom

# ``geom``: (gpus_per_server, b_inter, b_intra) of the server whose stage
# vector is being timed.  ``None`` means the cluster-wide (homogeneous)
# values — the fast path every pre-heterogeneity formula reduces to.
Geoms = Mapping[int, ServerGeom]  # server id (or rank) -> geometry


def _stage_comm_time(
    job: JobSpec,
    x_m: np.ndarray,
    s: int,
    cluster: ClusterSpec,
    nic_share: float | None = None,
    geom: Optional[ServerGeom] = None,
) -> float:
    """Eq. (5): inter-stage communication time of stage ``s`` on one server.

    ``x_m`` is this server's GPU vector; ``nic_share`` optionally overrides
    the reserved NIC bandwidth (used for the alpha_max bound); ``geom``
    supplies this server's (gpus, b_inter, b_intra) on heterogeneous
    clusters.
    """
    st = job.stages[s]
    x_s = int(x_m[s])
    if x_s == 0:
        return 0.0
    if geom is None:
        g, b_inter, b_intra = (
            cluster.gpus_per_server, cluster.b_inter, cluster.b_intra
        )
    else:
        g, b_inter, b_intra = geom
    if nic_share is None:
        nic_share = (x_s / g) * b_inter

    inter_bytes = 0.0  # bytes crossing the NIC, per replica-pair fractioning
    intra_bytes = 0.0
    if s > 0:
        k_prev = job.stages[s - 1].k
        x_prev = int(x_m[s - 1])
        frac_remote = (k_prev - x_prev) / k_prev
        inter_bytes += 2.0 * st.d_in * frac_remote
        intra_bytes += 2.0 * st.d_in * (x_prev / k_prev)
    if s < job.num_stages - 1:
        k_next = job.stages[s + 1].k
        x_next = int(x_m[s + 1])
        frac_remote = (k_next - x_next) / k_next
        inter_bytes += 2.0 * st.d_out * frac_remote
        intra_bytes += 2.0 * st.d_out * (x_next / k_next)

    t = 0.0
    if inter_bytes > 0.0:
        # numerator carries x_s replicas' traffic; reserved share scales with
        # x_s too, so the ratio equals inter_bytes * g / B_inter (Eq. 5).
        t += inter_bytes * x_s / nic_share
    if intra_bytes > 0.0:
        t += intra_bytes / b_intra
    return t


def _stage_allreduce_time(
    job: JobSpec,
    x_m: np.ndarray,
    s: int,
    cluster: ClusterSpec,
    nic_share: float | None = None,
    geom: Optional[ServerGeom] = None,
) -> float:
    """Eq. (6): intra-stage parameter synchronization time on one server."""
    st = job.stages[s]
    x_s = int(x_m[s])
    if x_s == 0 or st.k < 2 or st.h <= 0.0:
        return 0.0
    if geom is None:
        g, b_inter, b_intra = (
            cluster.gpus_per_server, cluster.b_inter, cluster.b_intra
        )
    else:
        g, b_inter, b_intra = geom
    data = 2.0 * (st.k - 1) / st.k * st.h  # bytes per replica (RAR == TAR)
    if x_s == st.k:  # all replicas co-located: intra-server only
        return data / b_intra
    if nic_share is None:
        nic_share = (x_s / g) * b_inter
    return data * x_s / nic_share


def beta(
    job: JobSpec,
    x_m: np.ndarray,
    s: int,
    cluster: ClusterSpec,
    geom: Optional[ServerGeom] = None,
    speed: float = 1.0,
) -> float:
    """beta_{i,s}^m: per-iteration time of stage ``s`` on one server.

    ``geom`` identifies the server's class geometry on heterogeneous
    clusters (``None`` = the homogeneous cluster-wide values).  ``speed``
    is the server's degradation factor: compute and bandwidths all scale
    by it, so the whole term is divided by it (a lone final division —
    ``speed == 1.0`` leaves the clean float chain untouched).
    """
    if int(x_m[s]) == 0:
        return 0.0
    st = job.stages[s]
    comp = st.p_f + st.p_b  # Eq. (4)
    b = (
        comp
        + _stage_comm_time(job, x_m, s, cluster, geom=geom)
        + _stage_allreduce_time(job, x_m, s, cluster, geom=geom)
    )
    if speed != 1.0:
        b = b / speed
    return b


def alpha_reference(
    job: JobSpec,
    placement: Mapping[int, np.ndarray],
    cluster: ClusterSpec,
    geoms: Optional[Geoms] = None,
    speeds: Optional[Mapping[int, float]] = None,
) -> float:
    """Pure-Python Eq. (7): max over (server, stage) of ``beta`` calls.

    Retained as the property-test reference for the array-native ``alpha``
    (tests/test_vectorized.py) and used by the reference engine
    (``heavy_edge.map_job(..., reference=True)``).  ``speeds``: sparse
    per-server degradation factors (keys match the placement's).
    """
    het = geoms is not None or cluster.is_heterogeneous
    best = 0.0
    for m, x_m in placement.items():
        x_m = np.asarray(x_m)
        if het:
            geom = geoms[m] if geoms is not None else cluster.server_geom(m)
        else:
            geom = None
        f = speeds.get(m, 1.0) if speeds else 1.0
        for s in range(job.num_stages):
            if x_m[s] > 0:
                b = beta(job, x_m, s, cluster, geom=geom, speed=f)
                if b > best:
                    best = b
    return best


class _ConfigArrays:
    """Per-stage profile vectors of one job config (keyed by config_key).

    Every quantity Eqs. (4)-(7) read per stage, precomputed with the exact
    arithmetic of the scalar reference (``two_d_in = 2.0 * d_in`` etc.) so
    the vectorized evaluation reproduces its floats bit for bit.
    """

    __slots__ = (
        "S", "comp", "two_d_in_tail", "two_d_out_head", "k_head", "k_tail",
        "k_i", "ar_data", "has_ar", "has_ar_any",
        "comp_l", "tdi_l", "tdo_l", "k_lf", "k_li", "ar_l", "har_l",
    )

    def __init__(self, job: JobSpec):
        stages = job.stages
        self.S = len(stages)
        self.comp = np.array([st.p_f + st.p_b for st in stages])
        two_d_in = np.array([2.0 * st.d_in for st in stages])
        two_d_out = np.array([2.0 * st.d_out for st in stages])
        self.k_i = np.array([st.k for st in stages], dtype=np.int64)
        k_f = self.k_i.astype(np.float64)
        # pre-sliced neighbor views (stage s reads k_{s-1} / k_{s+1})
        self.two_d_in_tail = two_d_in[1:]
        self.two_d_out_head = two_d_out[:-1]
        self.k_head = k_f[:-1]
        self.k_tail = k_f[1:]
        h = np.array([st.h for st in stages])
        self.ar_data = 2.0 * (self.k_i - 1) / self.k_i * h
        self.has_ar = (self.k_i >= 2) & (h > 0.0)
        self.has_ar_any = bool(self.has_ar.any())
        # Python-scalar mirrors for the small-placement path (identical
        # IEEE doubles: .tolist() is exact)
        self.comp_l = self.comp.tolist()
        self.tdi_l = two_d_in.tolist()
        self.tdo_l = two_d_out.tolist()
        self.k_lf = k_f.tolist()
        self.k_li = self.k_i.tolist()
        self.ar_l = self.ar_data.tolist()
        self.har_l = self.has_ar.tolist()


_CONFIG_ARRAYS: Dict[int, _ConfigArrays] = {}


def config_arrays(job: JobSpec) -> _ConfigArrays:
    key = job.config_key
    ca = _CONFIG_ARRAYS.get(key)
    if ca is None:
        ca = _CONFIG_ARRAYS[key] = _ConfigArrays(job)
    return ca


_SCALAR_CELLS = 64  # below this, Python scalars beat numpy dispatch


def _alpha_rows_scalar(ca, rows, g_l, bi_l, bx_l, f_l=None):
    """Scalar evaluation of ``alpha_matrix`` for a list of K x S int-list
    placements — the identical IEEE operation chain on Python floats, used
    when the whole batch is smaller than numpy's per-op dispatch cost.
    ``f_l``: optional per-server speed factors (divides each cell like the
    reference's final ``b / speed``)."""
    S = ca.S
    comp = ca.comp_l
    tdi, tdo = ca.tdi_l, ca.tdo_l
    kf, ki = ca.k_lf, ca.k_li
    ar_d, har = ca.ar_l, ca.har_l
    out = []
    for Xr in rows:
        best = 0.0
        for m, xm in enumerate(Xr):
            g_m, bi_m, bx_m = g_l[m], bi_l[m], bx_l[m]
            f_m = f_l[m] if f_l is not None else 1.0
            for s in range(S):
                x = xm[s]
                if x <= 0:
                    continue
                nic = (x / g_m) * bi_m
                if S > 1:
                    if s > 0:
                        kp = kf[s - 1]
                        xp = xm[s - 1]
                        inter = tdi[s] * ((kp - xp) / kp)
                        intra = tdi[s] * (xp / kp)
                    else:
                        inter = 0.0
                        intra = 0.0
                    if s < S - 1:
                        kn = kf[s + 1]
                        xn = xm[s + 1]
                        inter = inter + tdo[s] * ((kn - xn) / kn)
                        intra = intra + tdo[s] * (xn / kn)
                    core = comp[s] + (inter * x / nic + intra / bx_m)
                else:
                    core = comp[s]
                if har[s]:
                    if x == ki[s]:
                        core = core + ar_d[s] / bx_m
                    else:
                        core = core + ar_d[s] * x / nic
                if f_m != 1.0:
                    core = core / f_m
                if core > best:
                    best = core
        out.append(best)
    return out


def alpha_matrix(job: JobSpec, X: np.ndarray, g, b_inter, b_intra, speed=None):
    """Eqs. (4)-(7) for whole placements as one (servers x stages) array
    expression.

    ``X``: int GPU matrix, shape ``(K, S)`` or batched ``(B, K, S)`` (the
    refine path evaluates every candidate placement in one call).
    ``g``/``b_inter``/``b_intra``: scalars on homogeneous clusters, or
    per-server ``(K, 1)`` arrays carrying each rank's class geometry.
    ``speed``: optional ``(K, 1)`` per-server degradation factors — each
    server's beta row is divided by its factor as the final op, mirroring
    the reference's ``b / speed``.
    Returns a float for 2-D ``X``, else a ``(B,)`` array of alphas.

    Bit-identical to ``alpha_reference``: every elementwise op mirrors the
    scalar chain (same association order), masked terms reproduce the
    ``if bytes > 0`` skips, and the final max equals the loop's running max.
    """
    ca = config_arrays(job)
    if X.size == 0:
        return 0.0 if X.ndim == 2 else np.zeros(X.shape[0])
    if X.size <= _SCALAR_CELLS:
        K = X.shape[-2]
        if isinstance(g, np.ndarray):
            g_l = g.ravel().tolist()
            bi_l = b_inter.ravel().tolist()
            bx_l = b_intra.ravel().tolist()
        else:
            g_l = [g] * K
            bi_l = [b_inter] * K
            bx_l = [b_intra] * K
        f_l = speed.ravel().tolist() if speed is not None else None
        if X.ndim == 2:
            return _alpha_rows_scalar(
                ca, [X.tolist()], g_l, bi_l, bx_l, f_l
            )[0]
        return np.array(
            _alpha_rows_scalar(ca, X.tolist(), g_l, bi_l, bx_l, f_l)
        )
    Xf = X.astype(np.float64)
    pos = X > 0
    S = ca.S
    nic = np.where(pos, (Xf / g) * b_inter, 1.0)  # 1.0: masked, avoids 0/0
    if S > 1:
        inter = np.zeros(Xf.shape)
        intra = np.zeros(Xf.shape)
        xp = Xf[..., :-1]
        kp = ca.k_head
        inter[..., 1:] = ca.two_d_in_tail * ((kp - xp) / kp)
        intra[..., 1:] = ca.two_d_in_tail * (xp / kp)
        xn = Xf[..., 1:]
        kn = ca.k_tail
        inter[..., :-1] += ca.two_d_out_head * ((kn - xn) / kn)
        intra[..., :-1] += ca.two_d_out_head * (xn / kn)
        # zero-byte terms contribute exact zeros, matching the reference's
        # ``if bytes > 0`` skips without the branch
        comm = inter * Xf / nic + intra / b_intra
    else:
        comm = None  # single stage: no pipeline neighbors, Eq. (5) is 0
    if ca.has_ar_any:
        ar = np.where(
            ca.has_ar & pos,
            np.where(X == ca.k_i, ca.ar_data / b_intra, ca.ar_data * Xf / nic),
            0.0,
        )
        core = (ca.comp + comm) + ar if comm is not None else ca.comp + ar
    else:
        core = ca.comp + comm if comm is not None else ca.comp
    beta_ = np.where(pos, core, 0.0)
    if speed is not None:
        # per-server stretch: same final division as the scalar chain
        # (masked zeros stay exact zeros — factors are > 0)
        beta_ = beta_ / speed
    if X.ndim == 2:
        return float(beta_.max())
    return beta_.reshape(X.shape[0], -1).max(axis=1)


def _geom_columns(placement_keys, cluster: ClusterSpec, geoms: Optional[Geoms]):
    """(g, b_inter, b_intra) broadcast columns for a list of server keys."""
    if geoms is not None:
        geo = [geoms[m] for m in placement_keys]
    else:
        geo = [cluster.server_geom(m) for m in placement_keys]
    g = np.array([t[0] for t in geo], dtype=np.float64)[:, None]
    bi = np.array([t[1] for t in geo])[:, None]
    bx = np.array([t[2] for t in geo])[:, None]
    return g, bi, bx


def alpha(
    job: JobSpec,
    placement: Mapping[int, np.ndarray],
    cluster: ClusterSpec,
    geoms: Optional[Geoms] = None,
    speeds: Optional[Mapping[int, float]] = None,
) -> float:
    """Eq. (7): alpha_i = max over (server, stage) of beta_{i,s}^m.

    Array-native: evaluates the whole placement through ``alpha_matrix``
    (bit-identical to ``alpha_reference``, property-tested).  ``geoms``
    overrides the per-server geometry lookup (used by the canonical
    rank-relabeled mapping, whose placement keys are ranks, not physical
    server ids); without it heterogeneous specs resolve each key through
    ``cluster.server_geom``, homogeneous specs use the cluster scalars.
    ``speeds``: sparse per-server degradation factors (see module doc);
    an empty/None mapping is the clean fast path.
    """
    if not placement:
        return 0.0
    ms = list(placement)
    # int() in the reference truncates toward zero; astype matches for the
    # non-negative vectors every caller passes
    X = np.array([np.asarray(placement[m]) for m in ms]).astype(np.int64)
    if geoms is not None or cluster.is_heterogeneous:
        g, bi, bx = _geom_columns(ms, cluster, geoms)
    else:
        g, bi, bx = cluster.gpus_per_server, cluster.b_inter, cluster.b_intra
    f_col = None
    if speeds:
        get = speeds.get
        fs = [get(m, 1.0) for m in ms]
        if any(f != 1.0 for f in fs):
            f_col = np.array(fs)[:, None]
    return alpha_matrix(job, X, g, bi, bx, speed=f_col)


def validate_placement(
    job: JobSpec, placement: Mapping[int, np.ndarray]
) -> None:
    """Check constraint (2): every stage fully allocated."""
    total = np.zeros(job.num_stages, dtype=np.int64)
    for x_m in placement.values():
        x = np.asarray(x_m)
        if np.any(x < 0):
            raise ValueError("negative GPU allocation")
        total += x
    expected = np.array([st.k for st in job.stages])
    if not np.array_equal(total, expected):
        raise ValueError(
            f"placement allocates {total.tolist()} GPUs per stage, "
            f"job requires {expected.tolist()}"
        )


def alpha_max(
    job: JobSpec, cluster: ClusterSpec, nic_share: Optional[float] = None
) -> float:
    """Worst-case per-iteration time (paper Sec. III-B).

    The job is hypothetically spread over ``g_i`` servers, one replica each,
    with NIC share fixed at ``(1/g) * B_inter``.  On a heterogeneous
    cluster the bound takes the worst reserved share over the server
    classes (slowest NIC relative to its per-server GPU count), keeping
    alpha_max an upper bound for every feasible placement.

    ``nic_share`` overrides the reserved-share computation — the
    degradation-aware admission bounds (simulator.AlphaCache) evaluate
    the spread bound per server class, then stretch it by that class's
    straggler factor (a degraded server slows compute and NIC alike, so
    the whole per-stage time divides by the factor).
    """
    if nic_share is None:
        if cluster.is_heterogeneous:
            nic_share = min(
                b_inter / g for g, b_inter, _b_intra in
                (
                    cluster.class_geom(c)
                    for c in range(len(cluster.server_classes))
                )
            )
        else:
            nic_share = cluster.b_inter / cluster.gpus_per_server
    worst = 0.0
    for s, st in enumerate(job.stages):
        x_m = np.zeros(job.num_stages, dtype=np.int64)
        x_m[s] = 1  # lone replica of stage s on its own server
        comp = st.p_f + st.p_b
        comm = _stage_comm_time(job, x_m, s, cluster, nic_share=nic_share)
        ar = _stage_allreduce_time(job, x_m, s, cluster, nic_share=nic_share)
        worst = max(worst, comp + comm + ar)
    return worst


def placement_from_assignment(
    job: JobSpec, assignment: Mapping[tuple, int]
) -> Dict[int, np.ndarray]:
    """Convert a vertex->server assignment into x_{i,s}^m vectors."""
    placement: Dict[int, np.ndarray] = {}
    for (s, _r), m in assignment.items():
        if m not in placement:
            placement[m] = np.zeros(job.num_stages, dtype=np.int64)
        placement[m][s] += 1
    return placement


def servers_touched(placement: Mapping[int, np.ndarray]) -> Sequence[int]:
    return [m for m, x in placement.items() if np.asarray(x).sum() > 0]


def alpha_sync(
    job: JobSpec,
    placement: Mapping[int, np.ndarray],
    cluster: ClusterSpec,
    n_microbatches: int = 4,
) -> float:
    """Synchronous (GPipe-style) per-iteration time variant (paper Sec.
    III-B remark, following the analytic model of [20]).

    With m micro-batches and S stages, the pipeline fills/drains:
        T = (m + S - 1)/m * beta_bottleneck(comp+comm) + AllReduce
    where AllReduce is paid once per iteration at the sync barrier.
    """
    S = job.num_stages
    het = cluster.is_heterogeneous
    bottleneck = 0.0
    ar = 0.0
    for m, x_m in placement.items():
        x_m = np.asarray(x_m)
        geom = cluster.server_geom(m) if het else None
        for s in range(S):
            if x_m[s] == 0:
                continue
            st = job.stages[s]
            comp = st.p_f + st.p_b
            comm = _stage_comm_time(job, x_m, s, cluster, geom=geom)
            bottleneck = max(bottleneck, comp + comm)
            ar = max(ar, _stage_allreduce_time(job, x_m, s, cluster, geom=geom))
    m = max(1, n_microbatches)
    return (m + S - 1) / m * bottleneck + ar
