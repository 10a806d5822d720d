"""Reference Brandes' algorithm (Algorithm 1 of the paper), pure numpy.

The correctness oracle for every engine of the port: all of them must
match it to float tolerance.  O(nm); use on small/medium graphs only.
Unweighted only — the Dijkstra variant arrives with the weighted slice.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..graphs.graph import Graph

__all__ = ["brandes_reference", "single_source_dependencies"]


def single_source_dependencies(
    adj: list[np.ndarray], n: int, s: int, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One Brandes round from source ``s``.

    Returns (delta [n], sigma [n], depth [n]); depth is -1 off-component.
    """
    sigma = np.zeros(n, dtype=dtype)
    depth = np.full(n, -1, dtype=np.int64)
    sigma[s] = 1.0
    depth[s] = 0
    order: list[int] = []
    q: deque[int] = deque([s])
    while q:
        v = q.popleft()
        order.append(v)
        for w in adj[v]:
            if depth[w] < 0:
                depth[w] = depth[v] + 1
                q.append(w)
            if depth[w] == depth[v] + 1:
                sigma[w] += sigma[v]
    delta = np.zeros(n, dtype=dtype)
    for w in reversed(order):
        for v in adj[w]:
            if depth[v] == depth[w] - 1:
                delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
    return delta, sigma, depth


def brandes_reference(
    graph: Graph, sources: np.ndarray | None = None, dtype=np.float64
) -> np.ndarray:
    """Exact betweenness centrality scores (unnormalized, ordered-pair
    convention: every unordered pair contributes to both directions, as
    in the paper's Formula (1))."""
    if graph.w is not None:
        raise NotImplementedError(
            "the Dijkstra oracle for weighted graphs is not ported yet "
            "(ROADMAP Queue 1, weighted delta-stepping)"
        )
    n = graph.n
    bc = np.zeros(n, dtype=dtype)
    if sources is None:
        sources = np.arange(n)
    adj = graph.adjacency_lists()
    for s in sources:
        delta, _, _ = single_source_dependencies(adj, n, int(s), dtype=dtype)
        delta[int(s)] = 0.0
        bc += delta
    return bc
