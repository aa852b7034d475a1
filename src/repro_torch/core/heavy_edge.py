"""Heavy-Edge GPU mapping (paper Sec. IV-B, Fig. 2).

Given a job graph and a list of servers with available-GPU counts summing to
``g_i``, partition the vertices (stage replicas) into per-server groups so
that heavy communication edges stay inside a server.

Greedy procedure (faithful to the paper):
  1. sort servers by available GPUs, descending;
  2. for each server ``m`` with capacity ``c``:
     - if the remaining vertex count equals ``c``: assign all of them;
     - if ``c == 1``: assign the unassigned vertex with minimum total edge
       weight (to other unassigned vertices);
     - else: seed ``node_set`` with the heaviest remaining edge's endpoints,
       then repeatedly add the unassigned vertex connected to ``node_set`` by
       the heaviest edge; if none is connected, add an arbitrary
       (deterministically: smallest-id) unassigned vertex; stop at ``c``.

Ties are broken by vertex order for determinism.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .graph import DenseGraph, JobGraph, Vertex, build_job_graph
from .job import ClusterSpec, JobSpec, ServerGeom
from . import timing


def heavy_edge_reference(
    graph: JobGraph, server_caps: Sequence[Tuple[int, int]]
) -> Dict[Vertex, int]:
    """Pure-Python greedy (the paper's procedure, dict walks).

    Retained as the property-test reference for the array-native
    ``heavy_edge`` (tests/test_vectorized.py) and used by the reference
    engine (``map_job(..., reference=True)``).
    """
    total_cap = sum(c for _, c in server_caps)
    if total_cap != len(graph.vertices):
        raise ValueError(
            f"server capacities sum to {total_cap}, "
            f"job needs {len(graph.vertices)} GPUs"
        )
    # Descending capacity; stable on server id for determinism.
    order = sorted(server_caps, key=lambda mc: (-mc[1], mc[0]))

    unassigned = set(graph.vertices)
    assignment: Dict[Vertex, int] = {}

    for server_id, cap in order:
        if cap <= 0:
            continue
        if cap >= len(unassigned):
            for v in sorted(unassigned):
                assignment[v] = server_id
            unassigned.clear()
            break
        if cap == 1:
            v = min(
                sorted(unassigned),
                key=lambda u: (
                    sum(
                        w
                        for nb, w in graph.neighbors(u).items()
                        if nb in unassigned
                    ),
                    u,
                ),
            )
            assignment[v] = server_id
            unassigned.discard(v)
            continue

        node_set: List[Vertex] = []
        # Seed with the heaviest edge among unassigned vertices.
        best_w, best_pair = -1.0, None
        for u in sorted(unassigned):
            for nb, w in graph.neighbors(u).items():
                if nb in unassigned and u < nb and w > best_w:
                    best_w, best_pair = w, (u, nb)
        if best_pair is None:
            node_set.append(min(unassigned))
        else:
            node_set.extend(best_pair)
        for v in node_set:
            unassigned.discard(v)

        while len(node_set) < cap and unassigned:
            best_w, best_v = -1.0, None
            for u in node_set:
                for nb, w in graph.neighbors(u).items():
                    if nb in unassigned and (
                        w > best_w or (w == best_w and (best_v is None or nb < best_v))
                    ):
                        best_w, best_v = w, nb
            if best_v is None:  # disconnected: arbitrary (smallest) vertex
                best_v = min(unassigned)
            node_set.append(best_v)
            unassigned.discard(best_v)

        for v in node_set:
            assignment[v] = server_id

    if unassigned:
        raise AssertionError("heavy_edge left vertices unassigned")
    return assignment


def _min_weight_vertex(
    graph: JobGraph, d: DenseGraph, mask: np.ndarray
) -> int:
    """Capacity-1 branch of the greedy, verbatim from the reference.

    The reference sums each candidate's edge weights in adjacency
    *insertion* order (Python float addition); replicating that exact
    accumulation vectorized would cost more than the branch is worth —
    single-GPU slots pick one vertex — so the array engine shares this
    code with the reference instead of mirroring it.
    """
    verts = d.verts
    unassigned = {verts[i] for i in np.flatnonzero(mask)}
    v = min(
        sorted(unassigned),
        key=lambda u: (
            sum(
                w
                for nb, w in graph.neighbors(u).items()
                if nb in unassigned
            ),
            u,
        ),
    )
    return d.index[v]


def _heavy_edge_positions(
    graph: JobGraph,
    d: DenseGraph,
    caps: Sequence[int],
    order: Sequence[int],
) -> np.ndarray:
    """Array-native greedy: vertex index -> position in ``caps``.

    Same procedure and tiebreaks as ``heavy_edge_reference``, expressed on
    the dense weight matrix:

    * the "heaviest remaining edge" seed is the first edge of the
      config's precomputed ``(-w, a, rank)``-sorted edge list whose
      endpoints are both unassigned (one masked ``argmax`` instead of the
      nested neighbor scan);
    * growth keeps ``maxw[v] = max edge weight from node_set to v``
      incrementally (``np.maximum`` with the newly added row) and picks
      the next vertex by masked ``argmax`` — argmax's first-max rule is
      exactly the reference's ``nb < best_v`` tiebreak, and an all-zero
      candidate row degrades to the reference's "smallest unassigned
      vertex" fallback for disconnected remainders.
    """
    n = len(d.verts)
    out = np.empty(n, dtype=np.int64)
    mask = np.ones(n, dtype=bool)
    n_un = n
    W = d.W
    ea, eb = d.edge_a, d.edge_b
    have_edges = len(ea) > 0
    for p in order:
        cap = caps[p]
        if cap <= 0:
            continue
        if cap >= n_un:
            out[mask] = p
            n_un = 0
            break
        if cap == 1:
            i0 = _min_weight_vertex(graph, d, mask)
            out[i0] = p
            mask[i0] = False
            n_un -= 1
            continue
        seeded2 = False
        if have_edges:
            ok = mask[ea] & mask[eb]
            e = int(ok.argmax())
            seeded2 = bool(ok[e])
        if seeded2:
            i0, j0 = int(ea[e]), int(eb[e])
            out[i0] = out[j0] = p
            mask[i0] = mask[j0] = False
            n_un -= 2
            count = 2
            maxw = np.maximum(W[i0], W[j0])
        else:
            i0 = int(mask.argmax())  # first unassigned == smallest vertex
            out[i0] = p
            mask[i0] = False
            n_un -= 1
            count = 1
            maxw = W[i0].copy()
        while count < cap and n_un:
            v = int(np.where(mask, maxw, -np.inf).argmax())
            out[v] = p
            mask[v] = False
            n_un -= 1
            count += 1
            if count < cap and n_un:
                np.maximum(maxw, W[v], out=maxw)
    if n_un:
        raise AssertionError("heavy_edge left vertices unassigned")
    return out


def heavy_edge(
    graph: JobGraph, server_caps: Sequence[Tuple[int, int]]
) -> Dict[Vertex, int]:
    """Map each vertex to a server id (array-native greedy).

    ``server_caps``: (server_id, available_gpus) pairs; capacities must sum
    to the number of vertices.  Bit-identical to ``heavy_edge_reference``
    (property-tested in tests/test_vectorized.py).
    """
    total_cap = sum(c for _, c in server_caps)
    if total_cap != len(graph.vertices):
        raise ValueError(
            f"server capacities sum to {total_cap}, "
            f"job needs {len(graph.vertices)} GPUs"
        )
    d = graph.dense()
    ids = [m for m, _c in server_caps]
    caps = [c for _m, c in server_caps]
    order = sorted(range(len(ids)), key=lambda p: (-caps[p], ids[p]))
    pos = _heavy_edge_positions(graph, d, caps, order)
    return {v: ids[pos[i]] for i, v in enumerate(d.verts)}


def _bw_weights(
    servers: Sequence[int],
    geoms: Optional[Mapping[int, ServerGeom]],
    speeds: Optional[Mapping[int, float]] = None,
) -> Optional[np.ndarray]:
    """Normalized inverse effective-bandwidth weights over ``servers``.

    The single definition of the weight chain ``refine_assignment`` and
    ``_position_r_server`` share: inverse of ``b_inter * speed`` per
    server (bandwidth from ``geoms``, 1.0 when absent), None when the
    weights are uniform, else scale-free-normalized so the improvement
    threshold stays in the same (byte-weight) units as the unweighted
    objective.  Order of ``servers`` fixes the summation order, hence
    the exact floats — callers pass sorted ids.
    """
    if speeds and any(speeds.get(m, 1.0) != 1.0 for m in servers):
        sget = speeds.get
        if geoms is not None:
            inv = np.array(
                [1.0 / (geoms[m][1] * sget(m, 1.0)) for m in servers]
            )
        else:
            inv = np.array([1.0 / sget(m, 1.0) for m in servers])
    elif geoms is not None:
        inv = np.array([1.0 / geoms[m][1] for m in servers])
    else:
        return None
    if np.all(inv == inv[0]):
        return None
    return inv * (len(inv) / inv.sum())


def refine_assignment(
    graph: JobGraph,
    assignment: Dict[Vertex, int],
    max_passes: int = 3,
    geoms: Optional[Mapping[int, ServerGeom]] = None,
    speeds: Optional[Mapping[int, float]] = None,
) -> Dict[Vertex, int]:
    """Beyond-paper local search: best-improvement pairwise swaps.

    The paper's greedy is myopic (it can split an AllReduce ring whose
    members it seeded apart); a few swap passes repair those cases.  The
    swap deltas are evaluated for *all* vertex pairs at once on an
    adjacency matrix: with ``D[k, u]`` the total weight from vertex ``u``
    into server ``k`` and ``s`` the current assignment,

        delta(u, v) = (D[s_u,u] - D[s_v,u]) + (D[s_v,v] - D[s_u,v]) + 2 W[u,v]

    (the ``2 W[u,v]`` corrects for the u-v edge itself, which stays cut).
    Kept separate from the faithful greedy so the paper baseline remains
    measurable (see benchmarks/table2).

    ``geoms`` (heterogeneous clusters) switches the objective from the raw
    cut weight to the *bandwidth-weighted* cut: an edge crossing servers
    ``a, b`` costs ``w * (r_a + r_b)`` with ``r_k`` the inverse NIC
    bandwidth of ``k`` — cutting an AllReduce onto a slow-NIC server is
    penalized more than onto a fast one.  The weighted objective
    decomposes per vertex (``C = sum_x r[s_x] * cut_x``), so the swap
    delta stays a single vectorized expression:

        delta(u, v) =   r_u * (2 D[s_u,u] - 2 D[s_u,v] + 2 W[u,v] + T_v - T_u)
                      + r_v * (2 D[s_v,v] - 2 D[s_v,u] + 2 W[u,v] + T_u - T_v)

    with ``T_x`` the total incident weight of ``x``.  When every server's
    bandwidth is equal this reduces to exactly ``2 r`` times the
    homogeneous delta, so the unweighted formula is kept verbatim on that
    path (identical swap sequences — no behavior change).

    ``speeds`` (degraded clusters) folds each server's speed factor into
    its effective NIC bandwidth (``b_inter * f``): cutting an edge onto a
    degraded server is penalized like cutting onto a proportionally
    slower NIC.  Absent/all-1.0 factors leave the objective untouched.
    """
    d = graph.dense()
    verts = d.verts
    n = len(verts)
    if n < 2:
        return dict(assignment)
    W = d.W  # cached per config; values identical to the per-call rebuild

    servers = sorted({assignment[v] for v in verts})
    server_index = {m: k for k, m in enumerate(servers)}
    s = np.array([server_index[assignment[v]] for v in verts])
    arange = d.arange

    r_server = _bw_weights(servers, geoms, speeds)
    tot = d.incident if r_server is not None else None

    for _ in range(max_passes):
        ind = np.zeros((len(servers), n))
        ind[s, arange] = 1.0
        D = ind @ W  # D[k, u]: weight from vertex u into server k
        Ds = D[s]  # Ds[j, u] = D[s_j, u]
        d_own = Ds[arange, arange]
        if r_server is None:
            delta = (
                (d_own[:, None] - Ds.T) + (d_own[None, :] - Ds) + 2.0 * W
            )
        else:
            rv = r_server[s]
            base = (
                2.0 * d_own[:, None] - 2.0 * Ds + 2.0 * W
                + tot[None, :] - tot[:, None]
            )
            delta = rv[:, None] * base + rv[None, :] * base.T
        # only ordered pairs on different servers are candidate swaps
        invalid = (s[:, None] == s[None, :]) | d.swap_invalid
        delta[invalid] = np.inf
        flat = int(np.argmin(delta))
        i, j = divmod(flat, n)
        if delta[i, j] >= -1e-12:
            break
        s[i], s[j] = s[j], s[i]

    return {v: servers[s[i]] for i, v in enumerate(verts)}


def _refine_positions_batched(
    d: DenseGraph,
    seeds: np.ndarray,
    K: int,
    r_server: Optional[np.ndarray],
    max_passes: int = 3,
) -> np.ndarray:
    """``refine_assignment`` for a whole stack of seeds at once.

    ``seeds``: (B, n) position arrays over the same ``K`` capacity slots.
    Each row follows exactly the trajectory ``refine_assignment`` would
    (same matmul shapes per slice, same association order, same argmin
    flat-index tiebreak), so the results are bit-identical per seed while
    the numpy call count is paid once for the batch instead of per seed.
    Rows freeze as soon as their best swap stops improving; ``r_server``
    is indexed by position (see ``_position_r_server``).
    """
    B, n = seeds.shape
    W = d.W
    arange = d.arange
    S_ = seeds  # owned by this call: rows are refined in place
    tot = d.incident if r_server is not None else None
    if B == 1:
        # single distinct seed: the 2-D ops of the reference loop verbatim
        # (no batch gathers)
        s = S_[0]
        for _ in range(max_passes):
            ind = np.zeros((K, n))
            ind[s, arange] = 1.0
            D = ind @ W
            Ds = D[s]
            d_own = Ds[arange, arange]
            if r_server is None:
                delta = (
                    (d_own[:, None] - Ds.T) + (d_own[None, :] - Ds) + 2.0 * W
                )
            else:
                rv = r_server[s]
                base = (
                    2.0 * d_own[:, None] - 2.0 * Ds + 2.0 * W
                    + tot[None, :] - tot[:, None]
                )
                delta = rv[:, None] * base + rv[None, :] * base.T
            invalid = (s[:, None] == s[None, :]) | d.swap_invalid
            delta[invalid] = np.inf
            f = int(delta.argmin())
            i, j = f // n, f % n
            if delta[i, j] >= -1e-12:
                break
            s[i], s[j] = s[j], s[i]
        return S_
    act = list(range(B))  # rows still swapping; frozen rows drop out
    for _ in range(max_passes):
        b_n = len(act)
        Sa = S_[act]
        bcol = np.arange(b_n)[:, None]
        IND = np.zeros((b_n, K, n))
        IND[bcol, Sa, arange] = 1.0
        D = IND @ W  # per-slice dgemm == the reference's 2-D matmul
        Ds = D[bcol, Sa]  # Ds[b, j, u] = D[b, s_j, u]
        d_own = Ds[:, arange, arange]
        if r_server is None:
            delta = (
                (d_own[:, :, None] - Ds.transpose(0, 2, 1))
                + (d_own[:, None, :] - Ds)
                + 2.0 * W
            )
        else:
            rv = r_server[Sa]
            base = (
                2.0 * d_own[:, :, None] - 2.0 * Ds + 2.0 * W
                + tot[None, None, :] - tot[None, :, None]
            )
            delta = (
                rv[:, :, None] * base
                + rv[:, None, :] * base.transpose(0, 2, 1)
            )
        invalid = (Sa[:, :, None] == Sa[:, None, :]) | d.swap_invalid
        delta[invalid] = np.inf
        flat = delta.reshape(b_n, -1).argmin(axis=1)
        # scalar reads beat fancy gathers at this batch width (<= 3 rows)
        still = []
        for k in range(b_n):
            f = int(flat[k])
            i, j = f // n, f % n
            if delta[k, i, j] < -1e-12:
                b = act[k]
                S_[b, i], S_[b, j] = S_[b, j], S_[b, i]
                still.append(b)
        act = still
        if not act:
            break
    return S_


def _position_r_server(
    ids: Sequence[int],
    geoms: Optional[Mapping[int, ServerGeom]],
    speeds: Optional[Mapping[int, float]] = None,
) -> Optional[np.ndarray]:
    """``refine_assignment``'s bandwidth weights, permuted to positions.

    The reference normalizes over servers in sorted-id order (see
    ``_bw_weights``); summing in any other order could shift the last
    ulp, so the shared chain runs in that exact order before re-indexing
    by the caller's position layout.
    """
    servers = sorted(ids)
    r = _bw_weights(servers, geoms, speeds)
    if r is None:
        return None
    lookup = {m: r[k] for k, m in enumerate(servers)}
    return np.array([lookup[m] for m in ids])


def contiguous_assignment(
    graph: JobGraph, server_caps: Sequence[Tuple[int, int]]
) -> Dict[Vertex, int]:
    """Second seed for the local search: fill servers in (stage, replica)
    order, which tends to keep AllReduce rings and pipeline neighbours
    together when capacities align with stage sizes."""
    order = sorted(server_caps, key=lambda mc: (-mc[1], mc[0]))
    assign: Dict[Vertex, int] = {}
    it = iter(sorted(graph.vertices))
    for server_id, cap in order:
        for _ in range(cap):
            assign[next(it)] = server_id
    return assign


def stage_aligned_assignment(
    graph: JobGraph, server_caps: Sequence[Tuple[int, int]]
) -> Dict[Vertex, int]:
    """Third seed: best-fit-decreasing bin packing of *whole stages*.

    Swap-based local search cannot relabel an entire AllReduce ring; packing
    stages as units (heaviest internal weight first, tightest-fitting server)
    finds those placements directly.  Spillover vertices fall back to the
    heaviest-connection rule.
    """
    from collections import defaultdict

    stages = defaultdict(list)
    for v in sorted(graph.vertices):
        stages[v[0]].append(v)

    # one pass over the edges: intra-stage weight per stage
    internal = defaultdict(float)
    for (u, v), w in graph.edges.items():
        if u[0] == v[0]:
            internal[u[0]] += w

    order = sorted(
        stages.values(), key=lambda vs: (-internal[vs[0][0]], vs[0])
    )
    free = dict(server_caps)
    assign: Dict[Vertex, int] = {}
    leftovers: List[Vertex] = []
    for verts in order:
        # tightest server that fits the whole stage
        need = len(verts)
        best = None
        for m, c in free.items():
            if c >= need and (best is None or (c, m) < best):
                best = (c, m)
        if best is not None:
            m = best[1]
            for v in verts:
                assign[v] = m
            free[m] -= need
        else:
            leftovers.extend(verts)
    for v in leftovers:
        # most-connected server with capacity, else any with capacity
        best_m, best_w = None, -1.0
        for m, c in free.items():
            if c <= 0:
                continue
            w = sum(
                wt for nb, wt in graph.neighbors(v).items()
                if assign.get(nb) == m
            )
            if w > best_w:
                best_w, best_m = w, m
        assign[v] = best_m
        free[best_m] -= 1
    return assign


def _contiguous_positions(
    d: DenseGraph, caps: Sequence[int], order: Sequence[int]
) -> np.ndarray:
    """``contiguous_assignment`` as a position array: verts are sorted and
    the fill order is exactly ``order``, so it is one ``np.repeat``."""
    return np.repeat(
        np.array(order, dtype=np.int64),
        np.array([caps[p] for p in order]),
    )


def _stage_aligned_positions(
    graph: JobGraph,
    d: DenseGraph,
    server_caps: Sequence[Tuple[int, int]],
) -> np.ndarray:
    """``stage_aligned_assignment`` as a position array.

    Bin packing and spillover run as plain Python over the dense form's
    cached structures (intra-stage weights, contiguous stage slices,
    insertion-ordered neighbor lists) — the problem sizes (vertices,
    servers, stages) are tiny, so scalar loops beat per-op numpy
    dispatch while replicating the reference's float-accumulation
    sequences and first-max-in-caps-order tiebreak exactly (positions
    enumerate ``server_caps``, the reference's ``free.items()`` order).
    """
    ids = [m for m, _c in server_caps]
    internal = d.stage_internal
    order = sorted(range(d.n_stages), key=lambda st: (-internal[st], st))
    free = [c for _m, c in server_caps]
    K = len(free)
    bounds = d.stage_bounds
    n = len(d.verts)
    pos = [0] * n
    placed = [True] * n
    spill: List[int] = []
    for st in order:
        b0, b1 = int(bounds[st]), int(bounds[st + 1])
        need = b1 - b0
        best = None
        best_p = -1
        for p in range(K):
            c = free[p]
            if c >= need and (best is None or (c, ids[p]) < best):
                best = (c, ids[p])
                best_p = p
        if best is None:
            for i in range(b0, b1):
                placed[i] = False
            spill.append(st)
            continue
        for i in range(b0, b1):
            pos[i] = best_p
        free[best_p] -= need
    if spill:
        nbr_pairs = d.nbr_pairs
        wsum = [0.0] * K
        for st in spill:
            for i in range(int(bounds[st]), int(bounds[st + 1])):
                for p in range(K):
                    wsum[p] = 0.0
                for nb, w in nbr_pairs[i]:
                    if placed[nb]:
                        wsum[pos[nb]] += w
                best_w = -1.0
                best_p = -1
                for p in range(K):
                    if free[p] > 0 and wsum[p] > best_w:
                        best_w = wsum[p]
                        best_p = p
                pos[i] = best_p
                placed[i] = True
                free[best_p] -= 1
    return np.array(pos, dtype=np.int64)


def _placement_matrices(
    d: DenseGraph, positions: np.ndarray, K: int, S: int
) -> np.ndarray:
    """(B, n) position arrays -> (B, K, S) GPU matrices via one bincount."""
    B = positions.shape[0]
    KS = K * S
    offs = (np.arange(B) * KS)[:, None]
    flat = (positions * S + d.stage_of) + offs
    return np.bincount(flat.ravel(), minlength=B * KS).reshape(B, K, S)


def map_job(
    job: JobSpec,
    server_caps: Sequence[Tuple[int, int]],
    cluster: ClusterSpec,
    refine: bool = False,
    graph: Optional[JobGraph] = None,
    geoms: Optional[Mapping[int, ServerGeom]] = None,
    reference: bool = False,
    speeds: Optional[Sequence[float]] = None,
    _het_ctx: Optional[tuple] = None,
    _seed_cache: Optional[Dict[tuple, list]] = None,
) -> Tuple[Dict[int, np.ndarray], float]:
    """Run Heavy-Edge (optionally multi-start + local search).

    ``refine`` (beyond-paper): swap-based local search from three seeds
    (the paper's greedy, a contiguous fill, and whole-stage bin packing),
    keeping the placement with the lowest per-iteration time alpha.
    ``graph``: pre-built communication graph (it depends only on the job
    config, so callers mapping recurring jobs can share one).
    ``geoms``: per-server geometry override for the alpha evaluation
    (required when ``server_caps`` uses rank labels on a heterogeneous
    cluster; see ``map_job_canonical``).
    ``reference``: run the retained pure-Python pipeline (dict-walk greedy
    + per-(server, stage) beta alpha) instead of the array engine; the two
    are bit-identical (tests/test_vectorized.py) and the reference backs
    the uncached A-SRPT engine the property tests simulate against.
    ``speeds``: per-slot degradation factors aligned with ``server_caps``
    (see timing.py) — they stretch the alpha evaluation and fold into the
    refine objective's effective bandwidths; the greedy itself is
    weight-only and unaffected.  All-1.0 (or None) is the clean path.
    ``_het_ctx``: PlacementCache-precomputed (rank geoms, geometry
    columns, r_server) for the caller's class layout, shared across every
    capacity shape with the same classes (same values as the per-call
    construction, computed once).
    ``_seed_cache``: (config, caps) -> [seeds, uniq, uniq_of, refined-by-
    bandwidth-pattern] (heterogeneous clusters): the greedy and both
    auxiliary seeds are pure functions of the config and capacity vector
    — they never read server classes — so distinct class layouts over the
    same caps share them; the batched-refine output depends on geometry
    only through the per-slot NIC-bandwidth pattern (the ``r_server``
    weights), so layouts sharing that pattern share it too.  Entries hold
    exactly the arrays recomputation would produce and are immutable.
    """
    if graph is None:
        graph = build_job_graph(job)
    if _het_ctx is not None:
        geoms = _het_ctx[0]
    elif geoms is None and cluster.is_heterogeneous:
        # caller passed physical ids on a mixed cluster: resolve their
        # geometry here so refine + alpha see the per-class bandwidths
        geoms = {m: cluster.server_geom(m) for m, _c in server_caps}
    if speeds is not None and all(f == 1.0 for f in speeds):
        speeds = None  # normalize: full speed everywhere == clean path
    speed_by_id = (
        {m: f for (m, _c), f in zip(server_caps, speeds) if f != 1.0}
        if speeds is not None
        else None
    )
    if reference:
        assignment = heavy_edge_reference(graph, server_caps)
        placement = timing.placement_from_assignment(job, assignment)
        best_alpha = timing.alpha_reference(
            job, placement, cluster, geoms=geoms, speeds=speed_by_id
        )
        if refine:
            seeds = (
                assignment,
                contiguous_assignment(graph, server_caps),
                stage_aligned_assignment(graph, server_caps),
            )
            for seed in seeds:
                cand = refine_assignment(
                    graph, seed, geoms=geoms, speeds=speed_by_id
                )
                cand_placement = timing.placement_from_assignment(job, cand)
                a = timing.alpha_reference(
                    job, cand_placement, cluster, geoms=geoms,
                    speeds=speed_by_id,
                )
                if a < best_alpha - 1e-12:
                    best_alpha, placement = a, cand_placement
        return placement, best_alpha

    # -- array-native engine -------------------------------------------------
    d = graph.dense()
    n = len(d.verts)
    total_cap = sum(c for _m, c in server_caps)
    if total_cap != n:
        raise ValueError(
            f"server capacities sum to {total_cap}, job needs {n} GPUs"
        )
    ids = [m for m, _c in server_caps]
    caps = [c for _m, c in server_caps]
    K = len(ids)
    S = job.num_stages
    if _het_ctx is not None:
        g_col, bi_col, bx_col = _het_ctx[1]
    elif geoms is not None:
        g_col, bi_col, bx_col = timing._geom_columns(ids, cluster, geoms)
    else:
        g_col, bi_col, bx_col = (
            cluster.gpus_per_server, cluster.b_inter, cluster.b_intra
        )
    f_col = np.array(speeds)[:, None] if speeds is not None else None
    if speeds is not None:
        # degraded mode is rare and speed-dependent: don't pollute the
        # speed-agnostic shared seed/refine store
        _seed_cache = None
    if K == 1:
        # single server: every seed and every swap collapses to the same
        # trivial placement, so only the alpha evaluation remains
        X = np.bincount(d.stage_of, minlength=S)[None, :]
        a = timing.alpha_matrix(job, X, g_col, bi_col, bx_col, speed=f_col)
        return {ids[0]: X[0]}, a

    def _order():
        # canonical callers (PlacementCache ranks) pass caps sorted
        # descending with ids ascending — (-cap, id) order is the identity
        if all(caps[p] >= caps[p + 1] for p in range(K - 1)) and (
            ids == sorted(ids)
        ):
            return range(K)
        return sorted(range(K), key=lambda p: (-caps[p], ids[p]))

    if not refine:
        pos_greedy = _heavy_edge_positions(graph, d, caps, _order())
        X0 = _placement_matrices(d, pos_greedy[None, :], K, S)[0]
        best_alpha = timing.alpha_matrix(
            job, X0, g_col, bi_col, bx_col, speed=f_col
        )
        best_X = X0
    else:
        ent = None
        if _seed_cache is not None:
            sc_key = (job.config_key, tuple(caps))
            ent = _seed_cache.get(sc_key)
        if ent is None:
            order = _order()
            seeds = [
                _heavy_edge_positions(graph, d, caps, order),
                _contiguous_positions(d, caps, order),
                _stage_aligned_positions(graph, d, server_caps),
            ]
            # identical seeds refine identically: batch the distinct rows
            uniq: List[np.ndarray] = []
            uniq_of: List[int] = []
            seen: Dict[bytes, int] = {}
            for s_arr in seeds:
                key = s_arr.tobytes()
                idx = seen.get(key)
                if idx is None:
                    idx = seen[key] = len(uniq)
                    uniq.append(s_arr)
                uniq_of.append(idx)
            ent = [seeds, uniq, uniq_of, {}]
            if _seed_cache is not None:
                _seed_cache[sc_key] = ent
        seeds, uniq, uniq_of = ent[0], ent[1], ent[2]
        pos_greedy = seeds[0]
        if _het_ctx is not None:
            r_server = _het_ctx[2]
            bw_key = _het_ctx[3]
        else:
            r_server = _position_r_server(ids, geoms, speed_by_id)
            bw_key = ()  # hom callers: r_server is None
        refined = ent[3].get(bw_key)
        if refined is None:
            seed_mat = np.empty((len(uniq), n), dtype=np.int64)
            for u_i, row in enumerate(uniq):
                seed_mat[u_i] = row
            refined = _refine_positions_batched(d, seed_mat, K, r_server)
            ent[3][bw_key] = refined
        # one batched alpha evaluation: the unrefined greedy placement
        # (the pre-refine incumbent) plus every distinct refined candidate
        rows = [pos_greedy] + list(refined)
        cand_uniq: List[np.ndarray] = []
        cand_of: List[int] = []
        seen2: Dict[bytes, int] = {}
        for r_arr in rows:
            key = r_arr.tobytes()
            idx = seen2.get(key)
            if idx is None:
                idx = seen2[key] = len(cand_uniq)
                cand_uniq.append(r_arr)
            cand_of.append(idx)
        cand_mat = np.empty((len(cand_uniq), n), dtype=np.int64)
        for u_i, row in enumerate(cand_uniq):
            cand_mat[u_i] = row
        Xs = _placement_matrices(d, cand_mat, K, S)
        alphas = timing.alpha_matrix(
            job, Xs, g_col, bi_col, bx_col, speed=f_col
        )
        best_u = cand_of[0]
        best_alpha = float(alphas[best_u])
        # replay the reference's sequential best-of comparison in seed order
        for c_seed in range(len(seeds)):
            u = cand_of[1 + uniq_of[c_seed]]
            a = float(alphas[u])
            if a < best_alpha - 1e-12:
                best_alpha = a
                best_u = u
        best_X = Xs[best_u]
    placement = {
        ids[p]: best_X[p] for p in range(K) if caps[p] > 0
    }
    return placement, best_alpha


def _rank_geoms(
    cluster: ClusterSpec, server_caps: Sequence[Tuple[int, int]]
) -> Optional[Dict[int, ServerGeom]]:
    """Rank -> geometry of the physical server holding that rank (het only)."""
    if not cluster.is_heterogeneous:
        return None
    return {
        i: cluster.server_geom(m) for i, (m, _c) in enumerate(server_caps)
    }


def map_job_canonical(
    job: JobSpec,
    server_caps: Sequence[Tuple[int, int]],
    cluster: ClusterSpec,
    refine: bool = False,
    reference: bool = False,
    speeds: Optional[Sequence[float]] = None,
) -> Tuple[Dict[int, np.ndarray], float]:
    """``map_job`` on rank-relabeled servers, mapped back to the caller's ids.

    Within one server *class* the mapping problem depends on server
    *capacities*, never on physical server ids: running the algorithm on
    caps relabeled 0..k-1 (in the caller's order) and substituting the real
    ids afterwards yields an equally-good placement, and makes the result a
    pure function of the (capacity, class) sequence — which is what lets
    ``PlacementCache`` share one computation across every server subset
    with the same shape.  On heterogeneous clusters each rank carries its
    physical server's class geometry into the alpha evaluation, so the
    relabeling is a *within-class* permutation: rank i may stand for any
    server of the same class with the same free capacity, never for one of
    a different class.  (For the paper's greedy the relabeling is an exact
    no-op: ``select_servers`` emits caps sorted by capacity with ids
    ascending within ties, so rank order coincides with every id tiebreak
    the greedy performs.  The ``refine`` seeds may break capacity ties
    differently than physical ids would — quality is identical by
    symmetry.)  ``speeds`` (per-slot degradation factors, aligned with
    ``server_caps``) ride along to the rank labels unchanged — the
    relabeling is then a within-(class, speed) permutation.
    """
    ranked = [(i, c) for i, (_m, c) in enumerate(server_caps)]
    geoms = _rank_geoms(cluster, server_caps)
    placement, a = map_job(
        job, ranked, cluster, refine=refine, geoms=geoms,
        reference=reference, speeds=speeds,
    )
    return {server_caps[i][0]: x for i, x in placement.items()}, a


class PlacementCache:
    """Memoized Heavy-Edge mapping: (job config, capacity shape) -> result.

    Two jobs with identical stage profiles and allreduce kind map
    identically onto identical server capacity shapes — MLaaS traces are
    dominated by recurring job configs and ``select_servers`` emits
    canonically-ordered capacity vectors, so the hit rate at trace scale
    is high.  Stores rank-labeled placements (see ``map_job_canonical``)
    and relabels to the caller's server ids per call; the numpy stage
    vectors are shared between hits and must be treated as immutable.
    LRU-bounded.

    On heterogeneous clusters the key carries each slot's server *class*
    alongside its capacity, and each rank is evaluated with its class
    geometry — so a cached entry is only ever relabeled within a class
    (equal GPUs-per-server and bandwidths), never onto a class whose
    per-server capacity or comm cost differs.  Homogeneous specs keep the
    single-class capacity-shape key verbatim (one class, no behavior change).
    """

    __slots__ = (
        "cluster", "refine", "maxsize", "hits", "misses", "_lru", "_graphs",
        "_het", "_class_of", "_hetctx", "_seeds", "_classes_memo", "key_log",
    )

    def __init__(
        self,
        cluster: ClusterSpec,
        refine: bool = False,
        maxsize: int = 1 << 16,
        key_log: Optional[list] = None,
    ):
        from collections import OrderedDict

        self.cluster = cluster
        self.refine = refine
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        # Optional miss recorder (fleet prewarm, repro.core.fleet): every
        # clean-path miss appends ``(job, server_caps)`` so a scout run's
        # working set can be replayed into another cache via ``warm``.
        self.key_log = key_log
        self._het = cluster.is_heterogeneous
        self._lru: "OrderedDict[tuple, Tuple[Dict[int, np.ndarray], float]]" = (
            OrderedDict()
        )
        self._graphs: Dict[int, JobGraph] = {}  # config_key -> comm graph
        if self._het:
            # bisect-free per-server lookups for the hot key construction
            self._class_of = tuple(
                cluster.class_of(m) for m in range(cluster.num_servers)
            )
        else:
            self._class_of = ()
        # class-shape tuple -> (rank geoms, geometry columns, r_server):
        # rank geometry depends only on each slot's class, so it is shared
        # across every capacity shape with the same class layout
        self._hetctx: Dict[tuple, tuple] = {}
        # (config, caps) -> seed/refine arrays shared across class layouts
        # (the seeds never read classes).  On mixed clusters most misses
        # are new class layouts over seen capacity shapes; on homogeneous
        # clusters the store mainly serves ``warm`` (entries hold exactly
        # the arrays recomputation would produce, so pre-populating them
        # is behavior-neutral).
        self._seeds: Optional[Dict[tuple, list]] = {}
        # ids tuple -> classes tuple (server subsets recur heavily)
        self._classes_memo: Dict[tuple, tuple] = {}

    def _het_context(self, classes: tuple) -> tuple:
        ctx = self._hetctx.get(classes)
        if ctx is None:
            K = len(classes)
            geoms = {
                i: self.cluster.class_geom(c) for i, c in enumerate(classes)
            }
            cols = timing._geom_columns(range(K), self.cluster, geoms)
            r_server = _position_r_server(list(range(K)), geoms)
            # refine sees geometry only through the per-slot NIC pattern
            # (None == uniform): layouts sharing it share refined seeds
            bw_key = (
                () if r_server is None
                else tuple(geoms[i][1] for i in range(K))
            )
            ctx = self._hetctx[classes] = (geoms, cols, r_server, bw_key)
        return ctx

    def map_job(
        self,
        job: JobSpec,
        server_caps: Sequence[Tuple[int, int]],
        speeds: Optional[Tuple[float, ...]] = None,
    ) -> Tuple[Dict[int, np.ndarray], float]:
        """``speeds``: per-slot degradation factors aligned with
        ``server_caps`` (``ClusterState.speeds_for``), or None while no
        server is degraded.  The cache key carries the factor tuple, so
        relabeling stays within (capacity, class, speed) — a degraded
        slot is never answered from a clean slot's entry or vice versa;
        clean calls keep the original key shape and hit the same entries
        as before.
        """
        ids, shape = zip(*server_caps)
        if speeds is not None and all(f == 1.0 for f in speeds):
            speeds = None  # clean vector: share the clean entries
        if self._het:
            classes = self._classes_memo.get(ids)
            if classes is None:
                if len(self._classes_memo) >= self.maxsize:
                    self._classes_memo.clear()  # bound the memo like _lru
                class_of = self._class_of
                classes = self._classes_memo[ids] = tuple(
                    class_of[m] for m in ids
                )
            key = (job.config_key, shape, classes)
        else:
            classes = None
            key = (job.config_key, shape)
        if speeds is not None:
            key = key + (speeds,)
        lru = self._lru
        hit = lru.get(key)
        if hit is not None:
            self.hits += 1
            if len(lru) * 2 >= self.maxsize:  # recency only matters near cap
                lru.move_to_end(key)
        else:
            self.misses += 1
            if self.key_log is not None and speeds is None:
                self.key_log.append((job, tuple(server_caps)))
            cfg_key = job.config_key
            graph = self._graphs.get(cfg_key)
            if graph is None:
                graph = self._graphs[cfg_key] = build_job_graph(job)
            if self._seeds is not None and len(self._seeds) >= self.maxsize:
                self._seeds.clear()  # bound the seed store like _lru
            if speeds is not None:
                # degraded slots: per-call geometry + speed columns (rare
                # path; the class-layout fast context is speed-agnostic)
                placement, a = map_job(
                    job,
                    list(enumerate(shape)),
                    self.cluster,
                    refine=self.refine,
                    graph=graph,
                    geoms=(
                        self._het_context(classes)[0] if self._het else None
                    ),
                    speeds=speeds,
                )
            else:
                placement, a = map_job(
                    job,
                    list(enumerate(shape)),
                    self.cluster,
                    refine=self.refine,
                    graph=graph,
                    _het_ctx=self._het_context(classes) if self._het else None,
                    _seed_cache=self._seeds,
                )
            # every cap in the vector is fully used, so ranks 0..k-1 are
            # all present; store the stage vectors in rank order
            hit = ([placement[i] for i in range(len(ids))], a)
            lru[key] = hit
            if len(lru) > self.maxsize:
                # detlint: skip=DET007(digest-safe eviction: entries are pure functions of their key — map_job and warm produce byte-identical vectors on recomputation, property-tested warm-vs-cold — so evicting only moves work, never results)
                lru.popitem(last=False)
        vectors, a = hit
        return dict(zip(ids, vectors)), a

    def warm(self, requests) -> Tuple[int, int]:
        """Pre-compute missing clean entries, batching the cold refines.

        ``requests``: iterable of ``(job, server_caps)`` pairs — typically
        another cache's ``key_log`` from a cheap scout run (see
        ``repro.core.fleet``).  Misses are grouped by ``(config,
        slot-count, NIC-bandwidth pattern)`` and every group's distinct
        seed rows — across all its capacity shapes and class layouts —
        are refined in ONE ``_refine_positions_batched`` call, instead of
        one three-seed program per ``(config, shape)`` miss.  Grouping on
        equal slot count keeps every slice's op shapes equal to the
        sequential path's, and the batched refine is bit-identical per
        row (see its docstring), so a warmed entry equals what the
        on-demand miss would compute — ``map_job`` then finishes each
        entry (candidate alpha + best-of) through its normal path against
        the pre-populated seed store.

        Returns ``(n_entries_computed, n_batched_refine_calls)``.  On a
        non-refine cache there is no batched program; entries are simply
        computed via ``map_job``.
        """
        pending: List[tuple] = []
        seen: set = set()
        lru = self._lru
        for job, server_caps in requests:
            ids, shape = zip(*server_caps)
            # mirror map_job's key construction (kept inline there for the
            # hot path)
            if self._het:
                classes = self._classes_memo.get(ids)
                if classes is None:
                    if len(self._classes_memo) >= self.maxsize:
                        self._classes_memo.clear()
                    class_of = self._class_of
                    classes = self._classes_memo[ids] = tuple(
                        class_of[m] for m in ids
                    )
                key = (job.config_key, shape, classes)
            else:
                classes = None
                key = (job.config_key, shape)
            if key in lru or key in seen:
                continue
            seen.add(key)
            pending.append((job, server_caps, shape, classes))
        if not pending:
            return 0, 0

        n_groups = 0
        if self.refine:
            # (config, K, bw pattern) -> refine work; r_server depends on
            # geometry only through the per-slot NIC bandwidths (bw_key),
            # so one group shares a single (K,)-shaped weight vector
            groups: Dict[tuple, list] = {}
            group_seen: set = set()
            for job, _sc, shape, classes in pending:
                K = len(shape)
                if K == 1:
                    continue  # single-server path has no refine work
                cfg_key = job.config_key
                graph = self._graphs.get(cfg_key)
                if graph is None:
                    graph = self._graphs[cfg_key] = build_job_graph(job)
                d = graph.dense()
                if sum(shape) != len(d.verts):
                    continue  # map_job raises the loud ValueError below
                if self._seeds is not None and (
                    len(self._seeds) >= self.maxsize
                ):
                    self._seeds.clear()
                sc_key = (cfg_key, shape)
                ent = self._seeds.get(sc_key)
                if ent is None:
                    # seed construction exactly as map_job's miss path
                    # (rank ids 0..K-1 ascending; identity order when the
                    # shape is already descending)
                    caps = list(shape)
                    if all(caps[p] >= caps[p + 1] for p in range(K - 1)):
                        order = range(K)
                    else:
                        order = sorted(
                            range(K), key=lambda p: (-caps[p], p)
                        )
                    seeds = [
                        _heavy_edge_positions(graph, d, caps, order),
                        _contiguous_positions(d, caps, order),
                        _stage_aligned_positions(
                            graph, d, list(enumerate(shape))
                        ),
                    ]
                    uniq: List[np.ndarray] = []
                    uniq_of: List[int] = []
                    sb: Dict[bytes, int] = {}
                    for s_arr in seeds:
                        bkey = s_arr.tobytes()
                        idx = sb.get(bkey)
                        if idx is None:
                            idx = sb[bkey] = len(uniq)
                            uniq.append(s_arr)
                        uniq_of.append(idx)
                    ent = [seeds, uniq, uniq_of, {}]
                    self._seeds[sc_key] = ent
                if self._het:
                    ctx = self._het_context(classes)
                    r_server, bw_key = ctx[2], ctx[3]
                else:
                    r_server, bw_key = None, ()
                if bw_key in ent[3]:
                    continue  # refined rows already known for this pattern
                mark = (id(ent), bw_key)
                if mark in group_seen:
                    continue
                group_seen.add(mark)
                groups.setdefault((cfg_key, K, bw_key), []).append(
                    (ent, r_server, bw_key)
                )
            for (cfg_key, _K, _bw), members in groups.items():
                d = self._graphs[cfg_key].dense()
                n = len(d.verts)
                slices: List[tuple] = []
                total = 0
                for ent, _rs, bw in members:
                    cnt = len(ent[1])
                    slices.append((ent, bw, total, cnt))
                    total += cnt
                seed_mat = np.empty((total, n), dtype=np.int64)
                for ent, _bw, ofs, cnt in slices:
                    for u_i, row in enumerate(ent[1]):
                        seed_mat[ofs + u_i] = row
                refined = _refine_positions_batched(
                    d, seed_mat, _K, members[0][1]
                )
                for ent, bw, ofs, cnt in slices:
                    ent[3][bw] = refined[ofs:ofs + cnt]
                n_groups += 1
        for job, server_caps, _shape, _classes in pending:
            self.map_job(job, server_caps)
        return len(pending), n_groups


def consolidated_caps(job: JobSpec, cluster: ClusterSpec) -> List[Tuple[int, int]]:
    """Fewest-servers capacity profile: full servers + one remainder.

    Heterogeneous clusters pack biggest-then-fastest-NIC servers first —
    the same most-available-first order ``select_servers`` produces on an
    empty cluster with the bandwidth tiebreak.
    """
    if not cluster.is_heterogeneous:
        g = cluster.gpus_per_server
        n_full, rem = divmod(job.g, g)
        caps = [(m, g) for m in range(n_full)]
        if rem:
            caps.append((n_full, rem))
        return caps
    starts: List[int] = []
    acc = 0
    for sc in cluster.server_classes:
        starts.append(acc)
        acc += sc.count
    order = sorted(
        range(len(cluster.server_classes)),
        key=lambda c: (
            -cluster.server_classes[c].gpus_per_server,
            -cluster.server_classes[c].b_inter,
            starts[c],
        ),
    )
    caps: List[Tuple[int, int]] = []
    remaining = job.g
    for c in order:
        sc = cluster.server_classes[c]
        for m in range(starts[c], starts[c] + sc.count):
            take = sc.gpus_per_server if sc.gpus_per_server < remaining \
                else remaining
            caps.append((m, take))
            remaining -= take
            if remaining == 0:
                return caps
    raise ValueError(
        f"job {job.job_id} needs {job.g} GPUs, cluster has "
        f"{cluster.total_gpus}"
    )


def alpha_min_estimate(job: JobSpec, cluster: ClusterSpec) -> float:
    """alpha-tilde_i^min (paper Sec. IV-B): Heavy-Edge on the consolidated
    (fewest possible servers, fully packed) allocation.  ``map_job``
    resolves the per-server geometry itself on heterogeneous clusters."""
    _, a = map_job(job, consolidated_caps(job, cluster), cluster)
    return a


def select_servers(
    free: Mapping[int, int],
    g_needed: int,
    consolidate: bool,
    spec: Optional[ClusterSpec] = None,
    buckets: Optional[Sequence[Sequence[int]]] = None,
    total_free: Optional[int] = None,
    ranks: Optional[Tuple[Sequence[int], Sequence[int]]] = None,
) -> List[Tuple[int, int]]:
    """Pick servers/GPU counts for a job (paper Alg. 1 lines 9 and 22).

    ``consolidate=True``  -> most-available-first (communication-heavy jobs);
    ``consolidate=False`` -> least-available-first (fragmentation-aware
                             placement of non-communication-heavy jobs).
    ``spec`` (heterogeneous clusters only) breaks free-count ties by NIC
    bandwidth: consolidating jobs prefer the fastest NICs among
    equally-free servers, fragmentation-aware placement prefers the
    slowest — keeping fast-NIC capacity free for the jobs that need it.
    Homogeneous specs are unaffected (one class, id tiebreak as before).
    ``ranks`` overrides the static spec ranks with *effective*-bandwidth
    ranks (``ClusterState.effective_bw_ranks``) while servers are
    degraded: among equally-free servers a straggler sorts like a
    proportionally slower NIC, so consolidating placement avoids
    degraded capacity whenever a healthy server offers the same count.
    ``buckets``/``total_free`` (hot path): ``ClusterState.free_buckets``
    maintained incrementally — skips the per-call counting sort; the
    bucket walk is identical because the maintained buckets hold exactly
    the servers the sort would produce, in the same ascending-id order.
    Returns (server_id, gpus_taken) or raises if capacity is insufficient.
    """
    if buckets is None:
        # Counting sort by capacity: free-GPU counts are bounded by the
        # server size, and dict iteration yields servers in ascending id,
        # so walking the buckets reproduces the (-cap, id) / (cap, id)
        # orderings exactly.
        counted: Dict[int, List[int]] = {}
        total = 0
        max_c = 0
        for m, c in free.items():
            if c > 0:
                b = counted.get(c)
                if b is None:
                    counted[c] = [m]
                else:
                    b.append(m)
                total += c
                if c > max_c:
                    max_c = c
        counted_get = counted.get
    else:
        total = total_free if total_free is not None else sum(
            c * len(b) for c, b in enumerate(buckets)
        )
        max_c = len(buckets) - 1
        counted_get = None

    if total < g_needed:
        raise ValueError("not enough free GPUs")
    tiebreak = ranks is not None or (
        spec is not None and spec.is_heterogeneous
    )
    order = range(max_c, 0, -1) if consolidate else range(1, max_c + 1)
    picks: List[Tuple[int, int]] = []
    remaining = g_needed
    if tiebreak:
        desc_rank, asc_rank = ranks if ranks is not None else (
            spec.bw_order_ranks
        )
        rank = desc_rank if consolidate else asc_rank
    for c in order:
        bucket = buckets[c] if counted_get is None else counted_get(c, ())
        if not bucket:
            continue
        if tiebreak and len(bucket) > 1:
            bucket = sorted(bucket, key=rank.__getitem__)
        for m in bucket:
            take = c if c < remaining else remaining
            picks.append((m, take))
            remaining -= take
            if remaining == 0:
                return picks
    return picks


class FreeCapsSnapshot:
    """One scheduling pass's sorted free-capacity structure.

    The pick *order* ``select_servers`` walks does not depend on
    ``g_needed`` — only the prefix taken does — so a pass that evaluates
    many delayed jobs against an unchanged cluster can run the counting
    sort once (over the full free capacity) and carve each job's capacity
    vector from the prefix sums.  ``caps_for`` memoizes per distinct
    demand ``g``: equal-``g`` jobs provably select the same vector, and
    the shared tuple makes the step-2 caps-equality skip an identity
    comparison in the common case.  Invalidate (drop) the snapshot after
    any allocation — the free state it sorted no longer exists.
    """

    __slots__ = ("ids", "caps", "cum", "_by_g")

    def __init__(self, picks: Sequence[Tuple[int, int]]):
        self.ids = [m for m, _c in picks]
        self.caps = [c for _m, c in picks]
        cum: List[int] = []
        acc = 0
        for c in self.caps:
            acc += c
            cum.append(acc)
        self.cum = cum
        self._by_g: Dict[int, tuple] = {}

    @classmethod
    def consolidating(
        cls,
        free: Mapping[int, int],
        total_free: int,
        spec: Optional[ClusterSpec] = None,
        buckets: Optional[Sequence[Sequence[int]]] = None,
        ranks: Optional[Tuple[Sequence[int], Sequence[int]]] = None,
    ) -> "FreeCapsSnapshot":
        return cls(
            select_servers(
                free, total_free, consolidate=True, spec=spec,
                buckets=buckets, total_free=total_free, ranks=ranks,
            )
        )

    def caps_for(self, g: int) -> tuple:
        """The tuple ``select_servers(free, g, consolidate=True)`` returns.

        Bit-identical by construction: full servers in pick order until
        the remaining demand is smaller than the next capacity, which is
        taken as the remainder (property-tested in tests/test_vectorized.py).
        """
        hit = self._by_g.get(g)
        if hit is None:
            i = bisect.bisect_left(self.cum, g)
            prev = self.cum[i - 1] if i else 0
            ids, caps = self.ids, self.caps
            hit = tuple((ids[k], caps[k]) for k in range(i)) + (
                (ids[i], g - prev),
            )
            self._by_g[g] = hit
        return hit


class ConsolidatingLadder:
    """Snapshot-or-select ladder over one ``ClusterState``'s free capacity.

    The protocol A-SRPT's step 2/3 and the migration planner share: the
    *first* consolidating demand after any allocation runs a plain
    ``select_servers`` (building the full-order snapshot for a single
    carve would cost more than it saves); from the second demand on, one
    ``FreeCapsSnapshot`` per free state serves every demand by prefix
    carving.  Call ``reset()`` after any allocation — the sorted free
    state the snapshot captured no longer exists.  ``ranks`` (effective-
    bandwidth tiebreak) is fixed at construction: allocations never
    change speed factors, so it stays valid across resets within one
    scheduling pass / migration sweep.

    ``cluster`` is duck-typed (``free``/``free_buckets``/``total_free``)
    to keep this module import-cycle-free with cluster.py.
    """

    __slots__ = ("cluster", "spec", "ranks", "_snapshot", "_selected_once")

    def __init__(self, cluster, spec: Optional[ClusterSpec], ranks=None):
        self.cluster = cluster
        self.spec = spec
        self.ranks = ranks
        self._snapshot: Optional[FreeCapsSnapshot] = None
        self._selected_once = False

    def caps_for(self, g_need: int) -> tuple:
        cluster = self.cluster
        if self._snapshot is not None:
            return self._snapshot.caps_for(g_need)
        if self._selected_once:
            self._snapshot = FreeCapsSnapshot.consolidating(
                cluster.free, cluster.total_free, self.spec,
                buckets=cluster.free_buckets, ranks=self.ranks,
            )
            return self._snapshot.caps_for(g_need)
        self._selected_once = True
        return tuple(
            select_servers(
                cluster.free, g_need,
                consolidate=True, spec=self.spec,
                buckets=cluster.free_buckets,
                total_free=cluster.total_free,
                ranks=self.ranks,
            )
        )

    def reset(self) -> None:
        self._snapshot = None
        self._selected_once = False
