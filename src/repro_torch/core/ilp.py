"""Exact balanced-graph-cut placement (the paper's Table II ILP baseline).

Gurobi is unavailable offline; the same optimum is found by depth-first
branch-and-bound with an admissible bound (accumulated cut weight only) and
symmetry pruning over equal-capacity parts.  Exact for the small instances
(<= ~16 stage replicas) used in the Heavy-Edge comparison.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .graph import JobGraph, Vertex


def exact_min_cut(
    graph: JobGraph,
    server_caps: Sequence[Tuple[int, int]],
    node_limit: int = 2_000_000,
) -> Tuple[Dict[Vertex, int], float]:
    """Minimize total cut weight subject to per-server capacities.

    Returns (assignment, cut_weight). Raises if the search exceeds
    ``node_limit`` B&B nodes (instance too large for the exact solver).
    """
    caps = [(m, c) for m, c in server_caps if c > 0]
    if sum(c for _, c in caps) != len(graph.vertices):
        raise ValueError("capacities must sum to the vertex count")

    # Order vertices by incident weight, descending: heavy vertices first
    # tightens the bound early.
    vertices = sorted(
        graph.vertices, key=lambda v: -graph.incident_weight(v)
    )
    n_parts = len(caps)
    cap_left = [c for _, c in caps]
    cap_sizes = [c for _, c in caps]

    best_cost = float("inf")
    best_assign: List[int] = []
    assign: List[int] = [-1] * len(vertices)
    vidx = {v: i for i, v in enumerate(vertices)}
    nodes_visited = 0

    def rec(i: int, cost: float) -> None:
        nonlocal best_cost, best_assign, nodes_visited
        nodes_visited += 1
        if nodes_visited > node_limit:
            raise RuntimeError("exact_min_cut: node limit exceeded")
        if cost >= best_cost:
            return
        if i == len(vertices):
            best_cost = cost
            best_assign = assign.copy()
            return
        v = vertices[i]
        seen_empty_caps = set()
        for p in range(n_parts):
            if cap_left[p] == 0:
                continue
            # Symmetry: among still-empty parts of equal capacity, only try
            # the first one.
            if cap_left[p] == cap_sizes[p]:
                if cap_sizes[p] in seen_empty_caps:
                    continue
                seen_empty_caps.add(cap_sizes[p])
            extra = 0.0
            for nb, w in graph.neighbors(v).items():
                j = vidx[nb]
                if j < i and assign[j] != p:
                    extra += w
            cap_left[p] -= 1
            assign[i] = p
            rec(i + 1, cost + extra)
            assign[i] = -1
            cap_left[p] += 1

    rec(0, 0.0)
    result = {
        vertices[i]: caps[best_assign[i]][0] for i in range(len(vertices))
    }
    return result, best_cost
