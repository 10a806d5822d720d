"""Plain PyTorch versions of the level kernels K1–K4.

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
]


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
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    g = torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)
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
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    g = torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)
    t = adjacency.to(torch.float32) @ g
    return t if acc is None else acc + t
