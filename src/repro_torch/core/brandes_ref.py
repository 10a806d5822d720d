"""Reference Brandes' algorithm (Algorithm 1 of the paper), pure numpy.

The correctness oracle for every engine of the port: all of them must
match it to float tolerance.  O(nm); use on small/medium graphs only.

Weighted graphs (``graph.w`` set) use the Dijkstra variant: the BFS
queue becomes a binary heap, the predecessor test becomes
``dist[w] == dist[v] + w_vw`` and the dependency sweep walks vertices in
descending settled-distance order (Brandes 2001, §4).
"""
from __future__ import annotations

import functools
import heapq
from collections import deque

import numpy as np

from ..graphs.graph import Graph

__all__ = [
    "brandes_reference",
    "single_source_dependencies",
    "single_source_dependencies_weighted",
]


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


def single_source_dependencies_weighted(
    wadj: list[tuple[np.ndarray, np.ndarray]], n: int, s: int, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One weighted Brandes round from source ``s`` (Dijkstra forward).

    Returns (delta [n], sigma [n], dist [n]); dist is +inf off-component.
    """
    sigma = np.zeros(n, dtype=dtype)
    dist = np.full(n, np.inf, dtype=dtype)
    sigma[s] = 1.0
    dist[s] = 0.0
    settled = np.zeros(n, dtype=bool)
    order: list[int] = []
    heap: list[tuple[float, int]] = [(0.0, s)]
    while heap:
        dv, v = heapq.heappop(heap)
        if settled[v] or dv > dist[v]:
            continue
        settled[v] = True
        order.append(v)
        nbrs, ws = wadj[v]
        for w, wt in zip(nbrs, ws):
            cand = dist[v] + float(wt)
            if cand < dist[w]:
                dist[w] = cand
                sigma[w] = sigma[v]
                heapq.heappush(heap, (cand, int(w)))
            elif cand == dist[w] and not settled[w]:
                sigma[w] += sigma[v]
    delta = np.zeros(n, dtype=dtype)
    for w in reversed(order):
        nbrs, ws = wadj[w]
        for v, wt in zip(nbrs, ws):
            if dist[v] + float(wt) == dist[w] and sigma[w] > 0:
                delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
    return delta, sigma, dist


def brandes_reference(
    graph: Graph, sources: np.ndarray | None = None, dtype=np.float64
) -> np.ndarray:
    """Exact betweenness centrality scores (unnormalized, ordered-pair
    convention: every unordered pair contributes to both directions, as
    in the paper's Formula (1)).  Weighted graphs run the Dijkstra round."""
    n = graph.n
    bc = np.zeros(n, dtype=dtype)
    if sources is None:
        sources = np.arange(n)
    if graph.w is not None:
        one_round = functools.partial(
            single_source_dependencies_weighted, graph.weighted_adjacency_lists(), n, dtype=dtype
        )
    else:
        one_round = functools.partial(
            single_source_dependencies, graph.adjacency_lists(), n, dtype=dtype
        )
    for s in sources:
        delta, _, _ = one_round(int(s))
        delta[int(s)] = 0.0
        bc += delta
    return bc
