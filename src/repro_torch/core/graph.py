"""Job communication graph Omega = (V, E)  (paper Sec. IV-B).

Vertices are stage replicas ``(stage, replica)``. Edges carry communication
bytes per iteration:

* inter-stage: complete bipartite edges between replicas of stage ``s-1`` and
  ``s`` with weight ``2 d_out_{s-1} / k_s == 2 d_in_s / k_{s-1}``;
* intra-stage AllReduce for stage ``s`` with ``k >= 2`` replicas:
    - RAR: ring edges, each weighted ``2 (k-1)/k * h``;
    - TAR: double-binary-tree edges, each weighted ``(k-1)/k * h`` (half of
      RAR: each of the two trees carries half the data, NCCL 2.4 model).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .job import JobSpec, RAR, TAR

Vertex = Tuple[int, int]  # (stage_index, replica_index)
EdgeWeights = Dict[Tuple[Vertex, Vertex], float]


def _edge_key(u: Vertex, v: Vertex) -> Tuple[Vertex, Vertex]:
    return (u, v) if u <= v else (v, u)


class DenseGraph:
    """Array form of a ``JobGraph``, built once and shared by every placement
    computed for the job config (see ``heavy_edge.PlacementCache._graphs``).

    ``W`` is the vertex-indexed symmetric weight matrix over ``verts`` (the
    vertices in sorted order — the order every tiebreak in the greedy uses).
    ``edge_a/edge_b`` list the edge endpoint indices sorted by
    ``(-w, a, rank[a, b])`` with ``rank[i, j]`` the position at which
    vertex ``j`` was inserted into ``i``'s adjacency dict — the precise
    order in which the reference seed scan prefers equally-heavy edges —
    so "heaviest edge among unassigned" is one masked ``argmax``.
    ``stage_internal`` accumulates intra-stage edge weights in the same
    edge-iteration order as the former per-call loop (bit-identical sums).
    """

    __slots__ = (
        "verts", "index", "W", "incident", "edge_a", "edge_b",
        "stage_of", "stage_bounds", "n_stages", "stage_internal", "arange",
        "swap_invalid", "nbr_pairs",
    )

    def __init__(self, graph: "JobGraph"):
        verts = sorted(graph.vertices)
        n = len(verts)
        index = {v: i for i, v in enumerate(verts)}
        W = np.zeros((n, n))
        rank = np.full((n, n), n * n, dtype=np.int64)
        counters = [0] * n
        edges = []
        for (u, v), w in graph.edges.items():
            i, j = index[u], index[v]
            W[i, j] += w
            W[j, i] += w
            if rank[i, j] == n * n:
                rank[i, j] = counters[i]
                counters[i] += 1
            if rank[j, i] == n * n:
                rank[j, i] = counters[j]
                counters[j] += 1
            a, b = (i, j) if i < j else (j, i)
            edges.append((w, a, b))
        edges.sort(key=lambda e: (-e[0], e[1], rank[e[1], e[2]]))
        # rank stays local: only the edge sort above needs it
        self.verts = verts
        self.index = index
        self.W = W
        self.incident = W.sum(axis=1)
        self.edge_a = np.array([a for _w, a, _b in edges], dtype=np.int64)
        self.edge_b = np.array([b for _w, _a, b in edges], dtype=np.int64)
        # verts are sorted (stage, replica): stages occupy contiguous slices
        self.stage_of = np.array([s for s, _r in verts], dtype=np.int64)
        n_stages = int(self.stage_of[-1]) + 1 if n else 0
        self.n_stages = n_stages
        bounds = np.searchsorted(self.stage_of, np.arange(n_stages + 1))
        self.stage_bounds = bounds
        internal = [0.0] * n_stages
        for (u, v), w in graph.edges.items():
            if u[0] == v[0]:
                internal[u[0]] += w
        self.stage_internal = internal
        self.arange = np.arange(n)
        # ordered-pair / same-index mask shared by the refine swap search
        self.swap_invalid = self.arange[:, None] >= self.arange[None, :]
        # per-vertex neighbor lists in adjacency *insertion* order, for
        # exact replication of reference float-accumulation sequences
        self.nbr_pairs = [
            [(index[nb], w) for nb, w in graph._adj[v].items()]
            for v in verts
        ]


class JobGraph:
    """Undirected weighted communication graph of one DDLwMP job."""

    def __init__(self, vertices: List[Vertex], edges: EdgeWeights):
        self.vertices = list(vertices)
        self.edges = dict(edges)
        self._adj: Dict[Vertex, Dict[Vertex, float]] = {v: {} for v in vertices}
        for (u, v), w in self.edges.items():
            self._adj[u][v] = self._adj[u].get(v, 0.0) + w
            self._adj[v][u] = self._adj[v].get(u, 0.0) + w
        self._dense: DenseGraph | None = None

    def dense(self) -> DenseGraph:
        """Cached array form (weight matrix, tiebreak ranks, stage slices)."""
        d = self._dense
        if d is None:
            d = self._dense = DenseGraph(self)
        return d

    def neighbors(self, v: Vertex) -> Dict[Vertex, float]:
        return self._adj[v]

    def incident_weight(self, v: Vertex) -> float:
        return sum(self._adj[v].values())

    def total_weight(self) -> float:
        return sum(self.edges.values())

    def cut_weight(self, assignment: Dict[Vertex, int]) -> float:
        """Total weight of edges whose endpoints land on different servers."""
        return sum(
            w
            for (u, v), w in self.edges.items()
            if assignment[u] != assignment[v]
        )


def _double_binary_tree_edges(k: int) -> List[Tuple[int, int]]:
    """Parent-child pairs of NCCL-style double binary trees over ranks [0,k).

    Tree 1 is the balanced binary tree in in-order rank layout (rank r's
    parent flips the lowest set bit region); tree 2 is tree 1 with ranks
    shifted by 1 (mod k), the classic "mirrored/shifted" construction in
    which every rank is a leaf in one tree and interior in the other.
    """
    if k < 2:
        return []

    def tree1(n: int) -> List[Tuple[int, int]]:
        # In-order labeled complete-ish binary tree over 0..n-1.
        edges: List[Tuple[int, int]] = []

        def build(lo: int, hi: int, parent: int | None) -> None:
            if lo > hi:
                return
            mid = (lo + hi) // 2
            if parent is not None:
                edges.append((parent, mid))
            build(lo, mid - 1, mid)
            build(mid + 1, hi, mid)

        build(0, n - 1, None)
        return edges

    t1 = tree1(k)
    t2 = [((u + 1) % k, (v + 1) % k) for (u, v) in t1]
    return t1 + t2


def build_job_graph(job: JobSpec) -> JobGraph:
    vertices = list(job.replica_vertices())
    edges: EdgeWeights = {}

    def add(u: Vertex, v: Vertex, w: float) -> None:
        if u == v or w <= 0.0:
            return
        key = _edge_key(u, v)
        edges[key] = edges.get(key, 0.0) + w

    # Inter-stage bipartite edges.
    for s in range(1, job.num_stages):
        prev, cur = job.stages[s - 1], job.stages[s]
        if prev.d_out <= 0:
            continue
        w = 2.0 * prev.d_out / cur.k
        for r_prev in range(prev.k):
            for r_cur in range(cur.k):
                add((s - 1, r_prev), (s, r_cur), w)

    # Intra-stage AllReduce edges.
    for s, st in enumerate(job.stages):
        k = st.k
        if k < 2 or st.h <= 0:
            continue
        if job.allreduce == RAR:
            w = 2.0 * (k - 1) / k * st.h
            if k == 2:
                add((s, 0), (s, 1), w)
            else:
                for r in range(k):
                    add((s, r), (s, (r + 1) % k), w)
        else:  # TAR
            w = (k - 1) / k * st.h
            for (u, v) in _double_binary_tree_edges(k):
                add((s, u), (s, v), w)

    return JobGraph(vertices, edges)
