"""The engine layer: the two level loops, written once.

One BFS level is a *masked matrix product* over a frontier matrix
``F ∈ R^{n×s}`` holding ``s`` concurrent sources:

    forward level ℓ:   t = A @ (σ ⊙ [d = ℓ-1])
                       newly discovered:  d < 0 and t > 0  →  d := ℓ
                       path counts:       σ += t  on  d = ℓ

    backward level ℓ:  g = (1 + δ + ω) / σ  on  d = ℓ+1
                       δ += σ ⊙ (A @ g)     on  d = ℓ

:func:`forward_counting` and :func:`backward_accumulation` are written
against the :class:`repro_torch.core.operators.TraversalOperator`
protocol, so the same loops drive the dense, sparse and fused engines.
Where the JAX package runs a ``lax.while_loop`` with an on-device
liveness flag, the port runs a Python loop and reads the flag back once
per level (a host sync); the static ``num_levels`` path runs a fixed
trip count without reading anything back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .operators import as_operator

__all__ = ["ForwardState", "forward_counting", "backward_accumulation"]


class ForwardState(NamedTuple):
    sigma: torch.Tensor  # f32 [n, s] shortest-path counts
    depth: torch.Tensor  # i32 [n, s] discovery level (-1 = unreached)
    max_depth: int  # deepest level discovered
    # f32 0-d running max ABFT checksum residual over all levels
    # (checksum=True runs only; None otherwise)
    check_err: torch.Tensor | None = None


def forward_counting(
    operator, src_onehot: torch.Tensor, num_levels: int | None = None, *,
    checksum: bool = False,
) -> ForwardState:
    """Multi-source shortest-path counting (Alg. 2 analogue).

    Args:
      operator:   a TraversalOperator, or a bare ``A @ x`` callable over
                  the rows of ``src_onehot``.
      src_onehot: f32 [n_rows, s]; column j is the indicator of source j
                  (all-zero columns are inert padding).
      num_levels: None → run until a level discovers nothing (one liveness
                  readback per level); int → that many levels, no
                  readback (extra levels are no-ops).
      checksum:   run the ABFT-checked level steps and carry the running
                  max column-sum residual in ``ForwardState.check_err``
                  (the lane is transient inside each level).
    """
    op = as_operator(operator, n_rows=src_onehot.shape[0], device=src_onehot.device)
    sigma = src_onehot.to(torch.float32)
    depth = torch.where(src_onehot > 0, 0, -1).to(torch.int32)
    err = torch.zeros((), dtype=torch.float32, device=sigma.device)

    def level(lvl, sigma, depth, err):
        if not checksum:
            return op.forward_level(lvl, sigma, depth) + (err,)
        sigma, depth, local_alive, lerr = op.forward_level_checked(lvl, sigma, depth)
        return sigma, depth, local_alive, torch.maximum(err, lerr)

    if num_levels is None:
        cap = op.level_cap()
        lvl, alive = 1, True
        while alive and lvl <= cap:
            sigma, depth, local_alive, err = level(lvl, sigma, depth, err)
            alive = bool(op.reduce_any(local_alive))
            lvl += 1
        max_depth = lvl - 2  # last level that discovered anything
    else:
        for k in range(num_levels):
            sigma, depth, _, err = level(k + 1, sigma, depth, err)
        max_depth = int(op.reduce_max(depth.max())) if depth.numel() else 0
    return ForwardState(sigma=sigma, depth=depth, max_depth=max_depth,
                        check_err=err if checksum else None)


def backward_accumulation(
    operator,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    omega: torch.Tensor,
    max_depth: int,
    num_levels: int | None = None,
    *,
    checksum: bool = False,
):
    """Dependency accumulation (Alg. 4/5 analogue, checking successors).

    Returns δ f32 [n_rows, s].  ``operator`` is as for
    :func:`forward_counting`.  ``omega`` is f32 [n_rows] (1-degree
    weights; zeros disable the heuristic).  Levels run from
    ``max_depth - 1`` down to 1 (a Python int, read once per round);
    columns of different depths are handled by masking, which is what
    makes the 2-degree derived columns ride along for free.  With
    ``num_levels`` the sweep runs from ``num_levels - 1`` instead.

    With ``checksum=True`` every level runs the ABFT-checked step and the
    return value is the pair ``(δ, err)``, ``err`` the f32 0-d max
    relative column-sum residual across the sweep.
    """
    op = as_operator(operator, n_rows=sigma.shape[0], device=sigma.device)
    delta = torch.zeros_like(sigma)
    err = torch.zeros((), dtype=torch.float32, device=sigma.device)
    top = (num_levels if num_levels is not None else max_depth) - 1
    for lvl in range(top, 0, -1):
        if checksum:
            delta, lerr = op.backward_level_checked(lvl, sigma, depth, omega, delta)
            err = torch.maximum(err, lerr)
        else:
            delta = op.backward_level(lvl, sigma, depth, omega, delta)
    return (delta, err) if checksum else delta
