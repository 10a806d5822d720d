"""The operator layer of the traversal stack (paper §3.1).

One traversal algorithm — level-synchronous shortest-path counting plus
dependency accumulation — runs in every engine; what varies is *how a
level is applied*.  :class:`TraversalOperator` is that seam: the engine
layer (:mod:`repro_torch.core.engine`) owns the level loops, the driver
layer (:mod:`repro_torch.core.driver`) the per-round algebra and the
round loop, and operators everything below a level:

  apply(x)              A @ x over the rows this operator holds
  forward_level(...)    one forward BFS level (default: masked product
                        via ``apply``; the fused operator launches K1)
  backward_level(...)   one dependency level (the fused operator: K2)
  reduce_any/max/sum    agreement on liveness, max depth and additive
                        per-column facts (identity on one device)
  row_ids / level_cap   which vertices the rows are; worst-case levels
  root_omega            ω at the round's root vertices

Implementations: :class:`DenseOperator` (``torch.matmul`` on a dense
0/1 adjacency), :class:`SparseOperator` (``index_select`` +
``index_add_`` over the padded arc list) and :class:`FusedDenseOperator`
(the hand-written level kernels, kernels/ops.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels import ops

__all__ = [
    "TraversalOperator",
    "DenseOperator",
    "SparseOperator",
    "FusedDenseOperator",
    "as_operator",
]


def _forward_level(op: "TraversalOperator", lvl: int, sigma, depth):
    """One forward BFS level (paper Alg. 2 analogue):

        t = A @ (σ ⊙ [d = lvl-1]);  newly = (t > 0) ∧ (d < 0)
        d := lvl on newly;          σ += t on newly
    """
    frontier = sigma * (depth == lvl - 1)
    contrib = op.apply(frontier)
    newly = (contrib > 0) & (depth < 0)
    depth = torch.where(newly, lvl, depth)
    sigma = sigma + torch.where(newly, contrib, 0.0)
    return sigma, depth, newly.any()


def _backward_level(op: "TraversalOperator", lvl: int, sigma, depth, omega, delta):
    """One dependency level (paper Alg. 4/5 analogue, checking successors):

        g = (1 + δ + ω) / σ on d = lvl+1;  δ += σ ⊙ (A @ g) on d = lvl
    """
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    g = torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)
    t = op.apply(g)
    return delta + torch.where(depth == lvl, sigma * t, 0.0)


class TraversalOperator:
    """Protocol base: single-device semantics, no collectives."""

    n_rows: int

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for the local rows."""
        raise NotImplementedError

    def forward_level(self, lvl: int, sigma, depth):
        """(σ, d) -> (σ', d', alive) for one forward level; ``alive`` is a
        0-d bool tensor (did any column discover a vertex)."""
        return _forward_level(self, lvl, sigma, depth)

    def backward_level(self, lvl: int, sigma, depth, omega, delta):
        """Running δ -> δ' for one dependency level (ω is f32 [n_rows])."""
        return _backward_level(self, lvl, sigma, depth, omega, delta)

    def reduce_any(self, alive: torch.Tensor) -> torch.Tensor:
        return alive

    def reduce_max(self, value: torch.Tensor) -> torch.Tensor:
        return value

    def reduce_sum(self, value: torch.Tensor) -> torch.Tensor:
        return value

    def row_ids(self) -> torch.Tensor:
        """Global vertex id of each local row (i32 [n_rows])."""
        return torch.arange(self.n_rows, dtype=torch.int32, device=self.device)

    def level_cap(self) -> int:
        """Upper bound on the number of BFS levels (global n)."""
        return self.n_rows

    def root_omega(self, roots: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
        """ω at the round's root vertices (f32 [num_roots]; 0 at padding)."""
        safe = roots.clamp(0, omega.shape[0] - 1).long()
        return torch.where(roots >= 0, omega[safe], 0.0)


class _CallableOperator(TraversalOperator):
    """Adapter: a bare ``A @ x`` closure as a TraversalOperator."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], n_rows: int, device):
        self._fn = fn
        self.n_rows = n_rows
        self.device = torch.device(device)

    def apply(self, x):
        return self._fn(x)


def as_operator(op, n_rows: int | None = None, device=None) -> TraversalOperator:
    """Accept a TraversalOperator or a bare ``A @ x`` callable (which then
    needs ``n_rows`` and ``device``)."""
    if isinstance(op, TraversalOperator):
        return op
    if callable(op):
        if n_rows is None or device is None:
            raise ValueError("a callable operator needs n_rows and device")
        return _CallableOperator(op, n_rows, device)
    raise TypeError(f"not an operator: {op!r}")


class DenseOperator(TraversalOperator):
    """``A @ x`` with a dense [n, n] 0/1 adjacency via ``torch.matmul``."""

    def __init__(self, adjacency: torch.Tensor):
        self.adjacency = adjacency
        self.n_rows = adjacency.shape[0]
        self.device = adjacency.device

    def apply(self, x):
        return self.adjacency.to(torch.float32) @ x


class SparseOperator(TraversalOperator):
    """``A @ x`` via arc-list gather + scatter-add.

    ``src``/``dst`` are the padded symmetric arc arrays (int64); padding
    arcs use the sentinel vertex ``n`` on both endpoints, which reads from
    and writes to a discarded extra row.  ``out[v] = Σ_{(u,v) arcs} x[u]``.
    """

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        self.src = src
        self.dst = dst
        self.n_rows = n
        self.device = src.device

    def apply(self, x):
        n = self.n_rows
        x_pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
        msgs = x_pad.index_select(0, self.src)
        out = x.new_zeros((n + 1,) + tuple(x.shape[1:])).index_add_(0, self.dst, msgs)
        return out[:n]


class FusedDenseOperator(TraversalOperator):
    """The fused level kernels on a dense adjacency (single device) — the
    counterpart of the JAX package's ``PallasDenseOperator``.

    Overrides the level steps, not ``apply``, because K1/K2 fuse the
    frontier mask / g computation and the state update into the product.
    The adjacency may be bf16 (0/1 values are exact); every sum is f32.
    On the CPU the wrappers run the plain versions.
    """

    def __init__(self, adjacency: torch.Tensor):
        self.adjacency = adjacency
        self.n_rows = adjacency.shape[0]
        self.device = adjacency.device

    def forward_level(self, lvl, sigma, depth):
        sigma2, depth2 = ops.frontier_spmm(self.adjacency, sigma, depth, lvl)
        return sigma2, depth2, (depth2 != depth).any()

    def backward_level(self, lvl, sigma, depth, omega, delta):
        return ops.dependency_spmm(self.adjacency, sigma, depth, delta, omega, lvl)
