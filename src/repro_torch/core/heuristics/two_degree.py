"""2-degree heuristic — Dynamic Merging of Frontiers (paper §3.4.2).

For a 2-degree vertex ``c`` with neighbors ``a`` and ``b`` (Lemma 3.1):

    lvl_c(v) = min(lvl_a(v), lvl_b(v)) + 1
    σ_c(v)   = σ_a(v) | σ_b(v) | σ_a(v) + σ_b(v)   (a closer | b closer | tie)

so c's forward BFS is skipped: its (σ, lvl) column is derived elementwise
(Alg. 7) from the columns of a and b computed in the same round, and only
the backward sweep runs for c.  :func:`claim_two_degree` is the host-side
(numpy) selection; :func:`derive_two_degree_columns` is the device-side
derivation (torch).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["claim_two_degree", "derive_two_degree_columns"]


def claim_two_degree(
    residual_degrees: np.ndarray,
    adjacency: list[np.ndarray],
    eligible: np.ndarray,
) -> list[tuple[int, int, int]]:
    """Greedy selection of derivable 2-degree vertices.

    A vertex ``c`` with residual degree exactly 2 and neighbors ``a ≠ b``
    is claimed iff neither neighbor has itself been claimed (claimed
    vertices are skipped as sources, so their columns would not exist to
    derive from).  Returns a list of (c, a, b) triples.
    """
    n = residual_degrees.shape[0]
    claimed = np.zeros(n, dtype=bool)  # will be derived, not traversed
    pinned = np.zeros(n, dtype=bool)  # must stay an explicit source
    triples: list[tuple[int, int, int]] = []
    for c in np.nonzero(residual_degrees == 2)[0]:
        if not eligible[c] or pinned[c]:
            continue
        nbrs = adjacency[c]
        if len(nbrs) != 2:
            continue
        a, b = int(nbrs[0]), int(nbrs[1])
        if a == b or claimed[a] or claimed[b]:
            continue
        if not (eligible[a] and eligible[b]):
            continue
        claimed[c] = True
        pinned[a] = pinned[b] = True
        triples.append((int(c), a, b))
    return triples


def derive_two_degree_columns(
    sigma_ab: torch.Tensor,
    depth_ab: torch.Tensor,
    derived: torch.Tensor,
    row_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 7 — derive (σ_c, lvl_c) columns from neighbor columns.

    Args:
      sigma_ab: f32 [n, s] forward σ of the round's explicit sources.
      depth_ab: i32 [n, s] forward depths.
      derived:  i32 [k, 3] rows (c, a_pos, b_pos); positions index the
                round's source axis.  Padding rows use c = -1.
      row_ids:  i32 [n] global vertex id of each row (default arange(n)).

    Returns (σ_c f32 [n, k], d_c i32 [n, k]); padded columns are inert
    (all zero σ, depth -1).
    """
    n = sigma_ab.shape[0]
    c_idx = derived[:, 0]
    a_pos = derived[:, 1].clamp(min=0).long()
    b_pos = derived[:, 2].clamp(min=0).long()

    sa = sigma_ab.index_select(1, a_pos)  # [n, k]
    sb = sigma_ab.index_select(1, b_pos)
    da = depth_ab.index_select(1, a_pos)
    db = depth_ab.index_select(1, b_pos)

    big = torch.iinfo(torch.int32).max // 2
    la = torch.where(da >= 0, da, big)
    lb = torch.where(db >= 0, db, big)
    lc = torch.minimum(la, lb) + 1
    dc = torch.where(lc < big, lc, -1).to(torch.int32)
    sc = torch.where(la < lb, sa, 0.0) + torch.where(lb < la, sb, 0.0)
    sc = sc + torch.where(la == lb, sa + sb, 0.0)
    sc = torch.where(dc >= 0, sc, 0.0)

    # the 2-degree vertex itself is the root of its own derived tree
    if row_ids is None:
        row_ids = torch.arange(n, dtype=torch.int32, device=sigma_ab.device)
    is_c = row_ids[:, None] == c_idx[None, :]
    dc = torch.where(is_c, 0, dc)
    sc = torch.where(is_c, 1.0, sc)

    # padding columns (c == -1) are fully inert
    valid = (c_idx >= 0)[None, :]
    dc = torch.where(valid, dc, -1)
    sc = torch.where(valid, sc, 0.0)
    return sc, dc
