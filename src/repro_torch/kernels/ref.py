"""Plain PyTorch versions of the level kernels K1–K6.

These are the semantics the CUDA kernels must match; the wrappers in
:mod:`repro_torch.kernels.ops` run them for tensors on the CPU, and the
chip smoke test holds the kernels against them on the card.
"""
from __future__ import annotations

import torch

__all__ = [
    "frontier_spmm_ref",
    "dependency_spmm_ref",
    "frontier_partial_ref",
    "dependency_partial_ref",
    "tiles_to_dense",
    "frontier_sparse_ref",
    "dependency_sparse_ref",
]


def _dependency_operand(sigma, depth, delta, omega, lvl: int) -> torch.Tensor:
    """g = (1 + δ + ω) / σ on d = lvl+1 (σ ≤ 0 replaced by 1), 0 elsewhere."""
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    return torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)


def frontier_spmm_ref(
    adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor, lvl: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused forward BFS level.

    Args:
      adjacency: [n, n] 0/1 (f32 or bf16).
      sigma:     f32 [n, s] path counts.
      depth:     i32 [n, s] discovery levels (-1 unreached).
      lvl:       the level being expanded.

    Returns (sigma_out f32 [n, s], depth_out i32 [n, s]).
    """
    frontier = sigma * (depth == lvl - 1)
    contrib = adjacency.to(torch.float32) @ frontier
    newly = (contrib > 0) & (depth < 0)
    depth_out = torch.where(newly, lvl, depth)
    sigma_out = sigma + torch.where(newly, contrib, 0.0)
    return sigma_out, depth_out


def dependency_spmm_ref(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
) -> torch.Tensor:
    """One fused backward dependency level.

    Args:
      adjacency: [n, n] 0/1 (f32 or bf16).
      sigma:     f32 [n, s].
      depth:     i32 [n, s].
      delta:     f32 [n, s] running dependencies.
      omega:     f32 [n] 1-degree weights.
      lvl:       the level being accumulated.

    Returns delta_out f32 [n, s].
    """
    g = _dependency_operand(sigma, depth, delta, omega, lvl)
    t = adjacency.to(torch.float32) @ g
    return delta + torch.where(depth == lvl, sigma * t, 0.0)


def frontier_partial_ref(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold forward partial on a rectangular adjacency block (K3).

    Args:
      adjacency: [m, k] 0/1 block (f32 or bf16).
      sigma:     f32 [k, s] gathered path counts (contraction side).
      depth:     i32 [k, s] gathered discovery levels.
      lvl:       the level being expanded.
      acc:       optional f32 [m, s] running sum of a ring step.

    Returns t f32 [m, s] = [acc +] A_block @ (σ ⊙ [d = lvl-1]); the state
    update happens after the fold (operators.DistributedFusedOperator).
    """
    t = adjacency.to(torch.float32) @ (sigma * (depth == lvl - 1))
    return t if acc is None else acc + t


def dependency_partial_ref(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold backward partial on a rectangular adjacency block (K4).

    Args as :func:`frontier_partial_ref`, plus delta f32 [k, s] and omega
    f32 [k].  Returns t f32 [m, s] = [acc +] A_block @ g with
    g = (1 + δ + ω) / σ on d = lvl+1 (σ ≤ 0 replaced by 1).
    """
    g = _dependency_operand(sigma, depth, delta, omega, lvl)
    t = adjacency.to(torch.float32) @ g
    return t if acc is None else acc + t


def tiles_to_dense(
    tiles: torch.Tensor, tile_rows: torch.Tensor, tile_cols: torch.Tensor, m: int, kdim: int
) -> torch.Tensor:
    """The dense f32 [m, kdim] block of a BCSR tile list (tiles [T, bm, bk],
    tile_rows / tile_cols [T]).  Filler and padding tiles are all zero, so
    the scatter-add is exact.  For checks on small blocks: neither K5/K6
    nor their plain versions build it."""
    _, bm, bk = tiles.shape
    grid = torch.zeros((m // bm, kdim // bk, bm, bk), dtype=torch.float32, device=tiles.device)
    grid.index_put_((tile_rows.long(), tile_cols.long()), tiles.to(torch.float32), accumulate=True)
    return grid.transpose(1, 2).reshape(m, kdim)


#: tiles per batched product in :func:`_tile_product` (bounds its scratch:
#: 4096 gathered [128, 192] f32 operand tiles are 0.4 GB)
_TILE_BATCH = 4096


def _tile_product(tiles, tile_rows, tile_cols, operand, m: int, acc):
    """[acc +] Σ_t A_tile[t] @ operand[tile_cols[t]·bk : +bk], added into
    output tile-row tile_rows[t]: the BCSR product tile by tile, as K5/K6
    compute it, in batches of stored tiles.  Never densifies the block,
    so it runs wherever the tiles fit (a 262 144-vertex block is 256 GiB
    dense)."""
    num_tiles, bm, bk = tiles.shape
    kdim, s = operand.shape
    out = torch.zeros((m // bm, bm, s), dtype=torch.float32, device=operand.device)
    op_tiles = operand.reshape(kdim // bk, bk, s)
    for t0 in range(0, num_tiles, _TILE_BATCH):
        sl = slice(t0, t0 + _TILE_BATCH)
        prod = torch.bmm(tiles[sl].to(torch.float32), op_tiles[tile_cols[sl].long()])
        out.index_add_(0, tile_rows[sl].long(), prod)
    out = out.reshape(m, s)
    return out if acc is None else acc + out


def frontier_sparse_ref(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """BCSR pre-fold forward partial (K5): t f32 [m, s] = [acc +]
    A_block @ (σ ⊙ [d = lvl-1]) over the stored tiles, with σ, d the
    gathered [kdim, s] operands — :func:`frontier_partial_ref` of the
    block the tiles hold (:func:`tiles_to_dense`)."""
    return _tile_product(tiles, tile_rows, tile_cols, sigma * (depth == lvl - 1), m, acc)


def dependency_sparse_ref(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """BCSR pre-fold backward partial (K6): t f32 [m, s] = [acc +]
    A_block @ g over the stored tiles — :func:`dependency_partial_ref` of
    the block the tiles hold."""
    g = _dependency_operand(sigma, depth, delta, omega, lvl)
    return _tile_product(tiles, tile_rows, tile_cols, g, m, acc)
