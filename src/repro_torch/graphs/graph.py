"""Undirected graph container (host-side numpy).

The graph is stored as a *symmetric directed arc list*: every undirected
edge {u, v} appears as both (u, v) and (v, u), sorted by (src, dst).
This is the layout every traversal engine of :mod:`repro_torch.core`
consumes — the dense engines build their [n, n] adjacency on the device
from it, the sparse engine gathers and scatters along it.

``w`` (optional float32 per arc, symmetric like the arc list) feeds the
bucketed weighted traversal (``weighted=`` on the BC entry points).
Weights are strictly positive and finite: the bucket loop relies on
``w > 0`` for its settled-distance invariant, and the dense weighted
layouts encode "no edge" as weight 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Graph"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable undirected graph.

    Attributes:
      n:    number of vertices (vertex ids are ``0 .. n-1``).
      src:  int32 [m2] source endpoint of each directed arc.
      dst:  int32 [m2] destination endpoint of each directed arc.
            ``m2 == 2 * num_undirected_edges``; the arc list is symmetric
            and sorted by (src, dst).
      w:    optional float32 [m2] arc weights aligned with src/dst;
            ``None`` means unweighted.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray | None = None

    @staticmethod
    def from_edges(
        n: int, edges: np.ndarray, weights: np.ndarray | None = None
    ) -> "Graph":
        """Build from an [e, 2] array of (possibly duplicated, possibly
        self-looped, possibly one-directional) undirected edge pairs.

        ``weights`` (optional [e] floats, one per input edge row) must be
        strictly positive and finite; duplicate undirected pairs keep the
        weight of the first occurrence.
        """
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32).reshape(-1)
            if weights.shape[0] != edges.shape[0]:
                raise ValueError(
                    f"weights has {weights.shape[0]} entries for "
                    f"{edges.shape[0]} edges"
                )
            if weights.size and (not np.all(np.isfinite(weights)) or weights.min() <= 0):
                raise ValueError("edge weights must be strictly positive and finite")
        if edges.size:
            if edges.min() < 0 or edges.max() >= n:
                raise ValueError("edge endpoint out of range")
        keep = edges[:, 0] != edges[:, 1]  # drop self loops
        edges = edges[keep]
        if weights is not None:
            weights = weights[keep]
        # canonicalize + dedupe undirected pairs
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        # one sort of the pair keys; a weighted graph also needs the sort's
        # permutation, stable, so that each pair keeps its first weight
        # (np.unique(return_index=True)'s choice).  Without weights the
        # keys are sorted in place: numpy's vectorised sort is several
        # times faster than a stable argsort, and some numpy versions'
        # np.unique hashes, ~100x slower on the 10^8 keys of a scale-23
        # R-MAT
        key = lo * n + hi
        if weights is None:
            key.sort()
        else:
            order = np.argsort(key, kind="stable")
            key = key[order]
        first = np.ones(key.size, dtype=bool)
        first[1:] = key[1:] != key[:-1]
        key = key[first]
        # symmetrize; the arcs are distinct, so sorting (src, dst) as one
        # key is the lexsort's order
        lo, hi = np.divmod(key, n)
        arcs = np.concatenate([key, hi * n + lo])
        w = None
        if weights is None:
            arcs.sort()
        else:
            by_arc = np.argsort(arcs)
            arcs = arcs[by_arc]
            wu = weights[order[first]]
            w = np.concatenate([wu, wu])[by_arc]
        src, dst = np.divmod(arcs, n)
        return Graph(n=n, src=src.astype(np.int32), dst=dst.astype(np.int32), w=w)

    @property
    def num_arcs(self) -> int:
        """Number of directed arcs (= 2x undirected edges)."""
        return int(self.src.shape[0])

    @property
    def num_edges(self) -> int:
        """Number of undirected edges."""
        return self.num_arcs // 2

    @property
    def weighted(self) -> bool:
        """True when the graph carries per-arc weights."""
        return self.w is not None

    def degrees(self) -> np.ndarray:
        """int64 [n] vertex degrees."""
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def dense_adjacency(self, dtype=np.float32) -> np.ndarray:
        """[n, n] symmetric 0/1 adjacency matrix on the host (small graphs
        only; the engines build theirs on the device)."""
        a = np.zeros((self.n, self.n), dtype=dtype)
        a[self.src, self.dst] = 1
        return a

    def dense_weights(self, dtype=np.float32) -> np.ndarray:
        """[n, n] symmetric weight matrix on the host, 0 for "no edge"
        (small weighted graphs only)."""
        if self.w is None:
            raise ValueError("dense_weights() requires a weighted graph")
        a = np.zeros((self.n, self.n), dtype=dtype)
        a[self.src, self.dst] = self.w
        return a

    def adjacency_lists(self) -> list[np.ndarray]:
        """Per-vertex sorted neighbor arrays (oracle / scheduler use)."""
        order = np.argsort(self.src, kind="stable")
        src, dst = self.src[order], self.dst[order]
        starts = np.searchsorted(src, np.arange(self.n))
        ends = np.searchsorted(src, np.arange(self.n), side="right")
        return [dst[s:e] for s, e in zip(starts, ends)]

    def weighted_adjacency_lists(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Per-vertex (neighbors, weights) pairs (Dijkstra oracle use)."""
        if self.w is None:
            raise ValueError("weighted_adjacency_lists() requires a weighted graph")
        order = np.argsort(self.src, kind="stable")
        src, dst, w = self.src[order], self.dst[order], self.w[order]
        starts = np.searchsorted(src, np.arange(self.n))
        ends = np.searchsorted(src, np.arange(self.n), side="right")
        return [(dst[s:e], w[s:e]) for s, e in zip(starts, ends)]

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(row_ptr int64 [n+1], col_idx int32 [m2]) CSR view: the arcs in
        a stable order by source (the neighbour sampler's table)."""
        order = np.argsort(self.src, kind="stable")
        col = self.dst[order]
        counts = np.bincount(self.src, minlength=self.n)
        row_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr, col.astype(np.int32)

    def connected_components(self) -> np.ndarray:
        """int64 [n] component label per vertex (host-side union-find)."""
        parent = np.arange(self.n, dtype=np.int64)

        def find(x: int) -> int:
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        for u, v in zip(self.src, self.dst):
            ru, rv = find(int(u)), find(int(v))
            if ru != rv:
                parent[max(ru, rv)] = min(ru, rv)
        return np.array([find(i) for i in range(self.n)], dtype=np.int64)

    def padded_arcs(self, multiple: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Arc list padded to a multiple with self-referencing sentinel
        arcs pointing at vertex slot ``n`` (callers allocate n+1 slots so
        the sentinel accumulates into a discarded row)."""
        m2 = self.num_arcs
        pad = (-m2) % multiple
        src = np.concatenate([self.src, np.full(pad, self.n, np.int32)])
        dst = np.concatenate([self.dst, np.full(pad, self.n, np.int32)])
        return src, dst, m2

    def padded_arc_weights(self, multiple: int) -> np.ndarray:
        """Weights aligned with :meth:`padded_arcs`; the sentinel arcs get
        weight 0 (their destination row is discarded)."""
        if self.w is None:
            raise ValueError("padded_arc_weights() requires a weighted graph")
        pad = (-self.num_arcs) % multiple
        return np.concatenate([self.w, np.zeros(pad, np.float32)]).astype(np.float32)
