"""Graph generators (host-side numpy).

Every generator draws from ``numpy.random.default_rng(seed)`` in the same
order as the JAX package's, so the same seed gives the same graph in both
packages.  ``rmat_graph`` is the paper's synthetic workload (R-MAT with
a=0.57, b=0.19, c=0.19, d=0.05; SCALE/EF parameterization, §4.1); the
structured generators have closed-form BC scores; ``road_like_graph`` and
``suburb_graph`` are the long-diameter regimes the heuristics target.

Weighted graphs: ``rmat_graph(..., weights=)`` and
``road_like_graph(..., weights=)`` draw per-edge weights after the edges,
from the same generator (so the topology of a seed does not depend on
``weights``), and :func:`weighted_copy` weights any graph after the fact.
The modes are :data:`WEIGHT_MODES`: ``"none"`` (``Graph.w is None``),
``"unit"`` (every weight 1.0: the reduction check against the unweighted
result) and ``"dyadic"`` (seeded draws from {0.25, 0.5, …, 4.0}, exactly
representable, so every f32 distance sum is exact and the bucket and
equality masks agree with the float64 Dijkstra oracle).
"""
from __future__ import annotations

import math

import numpy as np

from .graph import Graph

__all__ = [
    "WEIGHT_MODES",
    "sample_weights",
    "weighted_copy",
    "rmat_ids",
    "rmat_graph",
    "sized_rmat_graph",
    "sized_mesh_graph",
    "path_graph",
    "cycle_graph",
    "star_graph",
    "complete_graph",
    "grid_graph",
    "gnp_graph",
    "disjoint_union",
    "road_like_graph",
    "suburb_graph",
    "skewed_depth_graph",
]

WEIGHT_MODES = ("none", "unit", "dyadic")


def sample_weights(rng: np.random.Generator, count: int, weights: str) -> np.ndarray | None:
    """Draw ``count`` edge weights for a :data:`WEIGHT_MODES` mode."""
    if weights not in WEIGHT_MODES:
        raise ValueError(f"weights must be one of {WEIGHT_MODES}, got {weights!r}")
    if weights == "none":
        return None
    if weights == "unit":
        return np.ones(count, dtype=np.float32)
    # dyadic: k/4 for k in 1..16, exact f32 sums
    return (rng.integers(1, 17, size=count) * 0.25).astype(np.float32)


def weighted_copy(graph: Graph, weights: str = "dyadic", seed: int = 0) -> Graph:
    """``graph`` with sampled edge weights, deterministic in ``seed``; both
    arcs of an undirected edge share one weight."""
    keep = graph.src < graph.dst  # each undirected edge once
    edges = np.stack([graph.src[keep], graph.dst[keep]], axis=1)
    w = sample_weights(np.random.default_rng(seed), edges.shape[0], weights)
    return Graph.from_edges(graph.n, edges, weights=w)


def rmat_ids(rng: np.random.Generator, scale: int, m: int, a: float = 0.57, b: float = 0.19,
             c: float = 0.19) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) of ``m`` R-MAT edge draws over 2**scale ids, unsigned, not
    permuted: low ids carry the heavy degrees."""
    # quadrant q = [r >= a] + [r >= a+b] + [r >= a+b+c] of each draw (a | b
    # over c | d): the source bit is q >= 2, the destination bit q odd —
    # the JAX package's bits, drawn from the same stream, in a few
    # in-place passes (scale 23 draws 134 M edges)
    word = np.uint32 if scale <= 32 else np.uint64
    src = np.zeros(m, dtype=word)
    dst = np.zeros(m, dtype=word)
    r = np.empty(m)
    q = np.empty(m, dtype=np.uint8)
    hit = np.empty(m, dtype=np.bool_)
    bits = np.empty(m, dtype=word)
    for bit in range(scale):
        rng.random(out=r)
        np.greater_equal(r, a, out=hit)
        q[:] = hit
        for threshold in (a + b, a + b + c):
            np.greater_equal(r, threshold, out=hit)
            q += hit
        np.right_shift(q, 1, out=bits)
        bits <<= word(bit)
        src |= bits
        np.bitwise_and(q, 1, out=bits)
        bits <<= word(bit)
        dst |= bits
    return src, dst


def sized_rmat_graph(n: int, n_arcs: int, seed: int = 0) -> Graph:
    """An R-MAT graph of exactly ``n`` vertices and ``n_arcs`` arcs (even):
    R-MAT draws over 2**ceil(log2 n) ids, the pairs with both ends below n
    kept (skewed degrees), self loops and duplicates dropped, drawn again
    until there are n_arcs / 2 distinct pairs, then n_arcs / 2 of them
    chosen at random and the ids permuted, so that degree is not
    correlated with id.  The synthetic stand-in for a published graph of
    that size (the GNN shapes' ``n_nodes`` and ``n_edges``)."""
    if n_arcs % 2 or n_arcs < 0 or n_arcs > n * (n - 1):
        raise ValueError(f"n_arcs must be even and at most n·(n−1), got {n_arcs} for n = {n}")
    scale = max(1, (n - 1).bit_length())
    want = n_arcs // 2
    rng = np.random.default_rng(seed)
    keys = np.zeros(0, np.int64)
    draws = want + want // 2 + 64
    while keys.size < want:
        src, dst = rmat_ids(rng, scale, draws)
        keep = (src < n) & (dst < n) & (src != dst)
        lo = np.minimum(src[keep], dst[keep]).astype(np.int64)
        hi = np.maximum(src[keep], dst[keep]).astype(np.int64)
        del src, dst, keep
        keys = np.concatenate([keys, lo * n + hi])
        del lo, hi
        # distinct keys by an in-place sort (some numpy versions' np.unique
        # hashes, ~20x slower on these 10^7-10^8 keys)
        keys.sort()
        first = np.ones(keys.size, dtype=np.bool_)
        np.not_equal(keys[1:], keys[:-1], out=first[1:])
        keys = keys[first]
        del first
        draws = 2 * (want - keys.size) + 64
    keys = keys[rng.permutation(keys.size)[:want]]
    perm = rng.permutation(n)
    u, v = np.divmod(keys, n)
    del keys
    return Graph.from_edges(n, np.stack([perm[u], perm[v]], axis=1))


def sized_mesh_graph(n: int, n_arcs: int, seed: int = 0) -> Graph:
    """A mesh-like graph of exactly ``n`` vertices and ``n_arcs`` arcs
    (even): vertex i sits at (i mod w, i div w) of a lattice w = ceil(√n)
    wide and is joined to its lattice neighbours at the displacements of
    least length first (no wrap across a row), until there are at least
    n_arcs / 2 candidate edges; n_arcs / 2 of them are kept at random.
    Degrees stay within twice the displacements used (4 at Cora's 3.9
    arcs a vertex): the stand-in for the meshes GraphCast and
    MeshGraphNet pass messages on, where an R-MAT graph's hubs would
    make their unnormalised sums overflow f32."""
    if n_arcs % 2 or n_arcs < 0 or n_arcs > n * (n - 1):
        raise ValueError(f"n_arcs must be even and at most n·(n−1), got {n_arcs} for n = {n}")
    want = n_arcs // 2
    w = max(1, math.isqrt(max(n - 1, 0)) + 1)
    i = np.arange(n, dtype=np.int64)
    x = i % w
    us, vs, total = [], [], 0
    r2 = 0
    while total < want:  # every pair is some displacement: n_arcs <= n·(n−1) ends it
        r2 += 1
        for dy in range(math.isqrt(r2) + 1):
            dx = math.isqrt(r2 - dy * dy)
            if dx * dx + dy * dy != r2:
                continue
            for sx in sorted({dx, -dx}) if dy > 0 else ([dx] if dx > 0 else []):
                keep = (x + sx >= 0) & (x + sx < w) & (i + sx + dy * w < n)
                us.append(i[keep])
                vs.append(i[keep] + sx + dy * w)
                total += us[-1].size
    u, v = np.concatenate(us), np.concatenate(vs)
    pick = np.sort(np.random.default_rng(seed).permutation(u.size)[:want])
    return Graph.from_edges(n, np.stack([u[pick], v[pick]], axis=1))


def rmat_graph(
    scale: int,
    edge_factor: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weights: str = "none",
) -> Graph:
    """R-MAT generator (Chakrabarti et al.), paper parameters by default.

    n = 2**scale vertices, m = edge_factor * n undirected edge samples
    (duplicates / self-loops dropped, as in Graph500 practice).
    ``weights`` is a :data:`WEIGHT_MODES` mode; duplicate samples keep the
    first draw's weight.
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src, dst = rmat_ids(rng, scale, m, a, b, c)
    # permute vertex ids so degree is not correlated with id
    perm = rng.permutation(n)
    w = sample_weights(rng, m, weights)
    return Graph.from_edges(n, np.stack([perm[src], perm[dst]], axis=1), weights=w)


def path_graph(n: int) -> Graph:
    e = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return Graph.from_edges(n, e)


def cycle_graph(n: int) -> Graph:
    e = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return Graph.from_edges(n, e)


def star_graph(n_leaves: int) -> Graph:
    """Vertex 0 is the hub; 1..n_leaves are leaves."""
    e = np.stack([np.zeros(n_leaves, np.int64), np.arange(1, n_leaves + 1)], axis=1)
    return Graph.from_edges(n_leaves + 1, e)


def complete_graph(n: int) -> Graph:
    iu = np.triu_indices(n, k=1)
    return Graph.from_edges(n, np.stack(iu, axis=1))


def grid_graph(rows: int, cols: int) -> Graph:
    """2-D lattice — the canonical long-diameter road-like topology."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return Graph.from_edges(rows * cols, np.concatenate([horiz, vert]))


def gnp_graph(n: int, p: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((n, n)) < p, k=1)
    u, v = np.nonzero(mask)
    return Graph.from_edges(n, np.stack([u, v], axis=1))


def disjoint_union(*graphs: Graph) -> Graph:
    """Multi-component graphs (the 1-degree heuristic's hard case)."""
    offset = 0
    parts = []
    for g in graphs:
        parts.append(np.stack([g.src + offset, g.dst + offset], axis=1))
        offset += g.n
    edges = np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)
    return Graph.from_edges(offset, edges)


def skewed_depth_graph(pairs: int, block: int) -> Graph:
    """``2 · pairs`` components of ``block`` vertices in alternating
    vertex-id order: even blocks are paths (depth ≈ block), odd blocks
    complete graphs (depth 1) — the maximally depth-skewed round deal."""
    parts = []
    for i in range(2 * pairs):
        parts.append(path_graph(block) if i % 2 == 0 else complete_graph(block))
    return disjoint_union(*parts)


def road_like_graph(
    rows: int, cols: int, spur_fraction: float = 0.3, seed: int = 0, weights: str = "none"
) -> Graph:
    """Grid backbone + dangling spur paths: long diameter, rich in 1- and
    2-degree vertices — the regime of the paper's Table 5 / Fig. 12; with
    a weighted :data:`WEIGHT_MODES` mode, the weighted road-network regime
    (segment lengths over a long-diameter backbone)."""
    rng = np.random.default_rng(seed)
    base = grid_graph(rows, cols)
    n = base.n
    n_spurs = int(spur_fraction * n)
    anchors = rng.integers(0, n, size=n_spurs)
    lengths = rng.integers(1, 4, size=n_spurs)
    edges = [np.stack([base.src, base.dst], axis=1)]
    nxt = n
    for anchor, length in zip(anchors, lengths):
        prev = int(anchor)
        for _ in range(int(length)):
            edges.append(np.array([[prev, nxt]]))
            prev = nxt
            nxt += 1
    all_edges = np.concatenate(edges)
    w = sample_weights(rng, all_edges.shape[0], weights)
    return Graph.from_edges(nxt, all_edges, weights=w)


def suburb_graph(rows: int, cols: int, leaf_fraction: float = 0.5, seed: int = 0) -> Graph:
    """Grid with every edge subdivided (chain vertices of degree 2) and
    single leaves attached to a fraction of the chain vertices — the
    paper's §4.4 regime where h3 derives strictly more than h2."""
    rng = np.random.default_rng(seed)
    base = grid_graph(rows, cols)
    nxt = base.n
    edges = []
    mids = []
    for u, v in zip(base.src, base.dst):
        if u < v:  # each undirected edge once
            edges.append([int(u), nxt])
            edges.append([nxt, int(v)])
            mids.append(nxt)
            nxt += 1
    for m in mids:
        if rng.random() < leaf_fraction:
            edges.append([m, nxt])
            nxt += 1
    return Graph.from_edges(nxt, np.array(edges))
