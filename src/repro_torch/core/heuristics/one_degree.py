"""1-degree reduction (paper §3.4.1, multi-component safe), numpy.

Preprocessing removes every vertex of degree 1 and records on its
neighbor ``v`` the weight ``ω(v)`` = number of removed leaves.  The BC
the leaves induce on the rest of the graph is recovered exactly by

1. the dependency recursion gaining ``+ω(w)``:
       δ_s(v) = Σ_w (σ_sv/σ_sw) (1 + δ_s(w) + ω(w));
2. every round rooted at a residual source s counted with multiplicity
   ``(ω(s)+1)``;
3. the post-round **leaf correction**
       BC(v) += 2·S·(n_comp − 1 − S) + 2·P
   where ``n_comp`` (v's component size including removed vertices) is
   read off v's own traversal as ``Σ_{u: d_v[u] ≥ 0} (1 + ω(u))``, or is
   analytic (``1 + ω_v``) for residual-isolated vertices.

One pass by default, as in the paper; ``exhaustive=True`` repeats to a
fixed point and contracts whole pendant trees ("h1t"/"h3t").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...graphs.graph import Graph

__all__ = ["OneDegreeReduction", "one_degree_reduce", "leaf_correction"]


@dataclasses.dataclass(frozen=True)
class OneDegreeReduction:
    """Result of the preprocessing pass(es).

    Each removed vertex u carries weight ``w(u) = 1 + Σ w(children)``; per
    vertex x, ``S(x) = Σ w(removed children)`` (the generalized ω) and
    ``P(x) = Σ_{i<j} w_i·w_j`` (cross-branch pair count).

    Attributes:
      residual:    graph with removed vertices' arcs dropped.
      omega:       f64 [n] — S(x).
      pair_credit: f64 [n] — P(x).
      weight:      f64 [n] — w(x) (1 for residual vertices).
      parent:      i64 [n] — removal attachment (-1 = not removed).
      removed:     bool [n].
      num_removed: total removed vertices.
      iterations:  passes executed.
    """

    residual: Graph
    omega: np.ndarray
    pair_credit: np.ndarray
    weight: np.ndarray
    parent: np.ndarray
    removed: np.ndarray
    num_removed: int
    iterations: int

    def resolve_root(self, u: int) -> tuple[int, float]:
        """(residual root, analytic n_comp or -1) for a removed vertex.

        Walks the parent chain; a 2-cycle means the whole component
        contracted into a mutual K2 pair, whose size is w(u)+w(v)."""
        seen = {u}
        x = u
        while self.removed[x]:
            nxt = int(self.parent[x])
            if nxt in seen:  # mutual-leaf terminal pair
                return x, float(self.weight[x] + self.weight[nxt])
            seen.add(nxt)
            x = nxt
        return x, -1.0


def one_degree_reduce(graph: Graph, exhaustive: bool = False) -> OneDegreeReduction:
    """Vectorized 1-degree removal (Alg. 6 analogue); ``exhaustive=True``
    repeats to a fixed point (pendant-tree contraction)."""
    n = graph.n
    src = graph.src.copy()
    dst = graph.dst.copy()
    alive = np.ones(len(src), bool)
    removed = np.zeros(n, bool)
    S = np.zeros(n, np.float64)
    P = np.zeros(n, np.float64)
    w = np.ones(n, np.float64)
    parent = np.full(n, -1, np.int64)

    max_passes = n if exhaustive else 1
    it = 0
    for it in range(1, max_passes + 1):
        deg = np.bincount(src[alive], minlength=n)
        leaf = (deg == 1) & ~removed
        if not leaf.any():
            it -= 1
            break
        m = alive & leaf[src]  # exactly one arc per leaf
        us, vs = src[m], dst[m]
        w_final = 1.0 + S[us]  # finalize the leaf's own subtree weight
        w[us] = w_final
        sum_w = np.zeros(n, np.float64)
        np.add.at(sum_w, vs, w_final)
        sum_w2 = np.zeros(n, np.float64)
        np.add.at(sum_w2, vs, w_final**2)
        # ΔP = S_before·ΔS + Σ_{i<j} w_i w_j  (within this pass)
        P += S * sum_w + (sum_w**2 - sum_w2) / 2.0
        S += sum_w
        parent[us] = vs
        removed[us] = True
        alive &= ~(leaf[src] | leaf[dst])

    residual = Graph(
        n=n,
        src=src[alive],
        dst=dst[alive],
        w=None if graph.w is None else graph.w[alive],
    )
    return OneDegreeReduction(
        residual=residual,
        omega=S,
        pair_credit=P,
        weight=w,
        parent=parent,
        removed=removed,
        num_removed=int(removed.sum()),
        iterations=it,
    )


def leaf_correction(
    omega_v: np.ndarray, n_comp: np.ndarray, pair_credit: np.ndarray | None = None
) -> np.ndarray:
    """Closed-form BC credit ``2·S·(n_comp − 1 − S) + 2·P`` for a vertex
    whose removed branches weigh S = omega_v with cross-branch pair count
    P (unit-weight branches when ``pair_credit`` is None)."""
    s = omega_v.astype(np.float64)
    if pair_credit is None:
        pair_credit = s * (s - 1.0) / 2.0
    return 2.0 * s * (n_comp - 1.0 - s) + 2.0 * pair_credit
