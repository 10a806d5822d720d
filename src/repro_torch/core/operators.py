"""The operator layer of the traversal stack (paper §3.1).

One traversal algorithm — level-synchronous shortest-path counting plus
dependency accumulation — runs in every engine; what varies is *how a
level is applied*.  :class:`TraversalOperator` is that seam: the engine
layer (:mod:`repro_torch.core.engine`) owns the level loops, the driver
layer (:mod:`repro_torch.core.driver`) the per-round algebra and the
round loop, and operators everything below a level:

  apply(x)              A @ x over the rows this operator holds
  apply_backward(g)     A @ g in the dependency sweep (payload-split hook)
  forward_level(...)    one forward BFS level (default: masked product
                        via ``apply``; the fused operators launch K1/K3/K5)
  backward_level(...)   one dependency level (the fused operators: K2/K4/K6)
  reduce_any/max/sum    agreement on liveness, max depth and additive
                        per-column facts (identity on one device,
                        ``all_reduce`` over the grid group on a 2-D grid)
  row_ids / level_cap   which vertices the rows are; worst-case levels
  root_omega            ω at the round's root vertices

Implementations: :class:`DenseOperator` (``torch.matmul`` on a dense
0/1 adjacency), :class:`SparseOperator` (``index_select`` +
``index_add_`` over the padded arc list) and :class:`FusedDenseOperator`
(the hand-written level kernels K1/K2, kernels/ops.py) on one device;
:class:`DistributedOperator` (the paper's 2-D decomposition, §3.2: expand
→ arc-list local compute → fold over ``torch.distributed`` groups) and
:class:`DistributedFusedOperator` (the same collectives around the
partial kernels K3/K4 on the device's dense block),
:class:`DistributedFusedSparseOperator` (around K5/K6 on the block's
stored BCSR tiles) and :class:`DistributedFusedHybridOperator` (either
of the two, per cell) on a grid.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..distributed.groups import GridGroups, all_gather, reduce_scatter
from ..kernels import ops
from ..kernels.blocked_spmm import tile_row_ptr

__all__ = [
    "TraversalOperator",
    "DenseOperator",
    "SparseOperator",
    "FusedDenseOperator",
    "DistributedOperator",
    "DistributedFusedOperator",
    "DistributedFusedSparseOperator",
    "DistributedFusedHybridOperator",
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
    t = op.apply_backward(g)
    return delta + torch.where(depth == lvl, sigma * t, 0.0)


class TraversalOperator:
    """Protocol base: single-device semantics, no collectives."""

    n_rows: int

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for the local rows."""
        raise NotImplementedError

    def apply_backward(self, g: torch.Tensor) -> torch.Tensor:
        """A @ g in the dependency sweep (hook for payload-split modes)."""
        return self.apply(g)

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

    def reduce_max_grid(self, value: torch.Tensor) -> torch.Tensor:
        """Max over this traversal's own devices only: the replica's own
        depth, even where the loop bound is synced across replicas."""
        return self.reduce_max(value)

    def reduce_max_sync(self, value: torch.Tensor) -> torch.Tensor:
        """Extend a grid max over the replicas that share loop bounds
        (``reduce_max == reduce_max_sync ∘ reduce_max_grid``); identity
        wherever replicas need no lockstep, as on every ported schedule."""
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


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class DistributedOperator(TraversalOperator):
    """2-D-decomposed operator (paper §3.2) of one rank of a
    :class:`~repro_torch.distributed.groups.GridGroups` grid — the
    counterpart of the JAX package's ``DistributedOperator``, barrier
    schedule only.

    Per application:
      expand (Alg. 2 line 15):  ``all_gather`` over the rank's column group
          delivers the frontier slice of grid column j, ``[R·chunk, s]``.
      local compute:            gather ``x_col[src_local]`` and
          ``index_add_`` into ``dst_local`` (a ``C·chunk + 1`` accumulator
          whose last row takes the padding arcs).
      fold (Alg. 2 line 19):    ``reduce_scatter`` over the row group sums
          the C partials and delivers each rank its owned chunk.

    Only the frontier-σ / g tensor travels; the depth test of the far
    endpoint is folded into it.  ``split_backward`` splits the backward
    exchange into two half-width collectives (the paper's unfused σ/d
    exchange, the Fig. 9 benchmark mode).  The ring schedules
    (``overlap != "none"``) and replica lockstep (``sync_axes``) are not
    ported yet and raise.
    """

    def __init__(
        self,
        src_local: torch.Tensor | None,  # int64 [max_arcs] — into the gathered column
        dst_local: torch.Tensor | None,  # int64 [max_arcs] — into the C*chunk partial
        *,
        chunk: int,
        groups: GridGroups,
        split_backward: bool = False,
        overlap: str = "none",
        sync_axes: tuple[str, ...] = (),
    ):
        if overlap != "none":
            raise _not_ported(f"overlap={overlap!r} (the ring schedules)", 7)
        if sync_axes:
            raise _not_ported("sync_axes (replica lockstep under a ring schedule)", 7)
        self.src_local = src_local
        self.dst_local = dst_local
        self.chunk = chunk
        self.groups = groups
        self.R, self.C = groups.R, groups.C
        self.split_backward = split_backward
        self.n_rows = chunk
        self.device = None if src_local is None else src_local.device

    # ---------------------------------------------- collective skeleton
    def _expand(self, x_owned: torch.Tensor) -> torch.Tensor:
        return all_gather(x_owned, self.groups.column)

    def _fold(self, partial: torch.Tensor) -> torch.Tensor:
        return reduce_scatter(partial, self.groups.row)

    def _local(self, x_col: torch.Tensor) -> torch.Tensor:
        rows = self.C * self.chunk
        msgs = x_col.index_select(0, self.src_local)
        out = x_col.new_zeros((rows + 1,) + tuple(x_col.shape[1:]))
        return out.index_add_(0, self.dst_local, msgs)[:rows]

    def apply(self, x_owned):
        return self._fold(self._local(self._expand(x_owned)))

    def apply_backward(self, g):
        if not self.split_backward:
            return self.apply(g)
        half = g.shape[1] // 2  # paper-style split payload (benchmark mode)
        return torch.cat([self.apply(g[:, :half]), self.apply(g[:, half:])], dim=1)

    # ------------------------------------------- collective agreements
    def _all_reduce(self, value: torch.Tensor, op) -> torch.Tensor:
        out = value.reshape(1).clone()
        dist.all_reduce(out, op=op, group=self.groups.grid)
        return out[0]

    def reduce_any(self, alive):
        return self._all_reduce(alive.to(torch.int32), dist.ReduceOp.SUM) > 0

    def reduce_max(self, value):
        return self._all_reduce(value, dist.ReduceOp.MAX)

    def reduce_sum(self, value):
        out = value.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups.grid)
        return out

    # ------------------------------------------------------- geometry
    def row_ids(self):
        base = (self.groups.j * self.R + self.groups.i) * self.chunk  # first owned vertex
        return base + torch.arange(self.chunk, dtype=torch.int32, device=self.device)

    def level_cap(self):
        return self.chunk * self.R * self.C  # n_pad

    def root_omega(self, roots, omega):
        owned = self.row_ids()
        local = torch.where(roots[None, :] == owned[:, None], omega[:, None], 0.0).sum(dim=0)
        return self.reduce_sum(local)


class DistributedFusedOperator(DistributedOperator):
    """The 2-D decomposition with the partial kernels K3/K4 as block-local
    compute — the counterpart of the JAX package's
    ``DistributedPallasOperator`` (barrier schedule).

    ``block`` is the rank's dense adjacency block A[rows_i, cols_j],
    ``[C·chunk, R·chunk]`` (f32, or bf16: 0/1 values are exact).  The
    kernels fuse the frontier mask / g recompute into the block product;
    the state update needs the t summed over the grid row, so it runs in
    torch after the fold.  The exchanges therefore carry (σ, d) forward
    and (σ, d, δ, ω) backward — the paper's §3.2 exchange set — instead of
    the arc-list operator's one pre-masked tensor.  The block product is
    the ``_partial_forward`` / ``_partial_backward`` hook, which the BCSR
    and hybrid subclasses replace; the collectives and the epilogue are
    written once, here.
    """

    def __init__(
        self,
        block: torch.Tensor,
        *,
        chunk: int,
        groups: GridGroups,
        overlap: str = "none",
        sync_axes: tuple[str, ...] = (),
    ):
        super().__init__(None, None, chunk=chunk, groups=groups, overlap=overlap,
                         sync_axes=sync_axes)
        self.block = block
        self.device = block.device

    # ------------------------------------------------------ block hooks
    def _partial_forward(self, sigma_col, depth_col, lvl):
        return ops.frontier_spmm_partial(self.block, sigma_col, depth_col, lvl)

    def _partial_backward(self, sigma_col, depth_col, delta_col, omega_col, lvl):
        return ops.dependency_spmm_partial(
            self.block, sigma_col, depth_col, delta_col, omega_col, lvl
        )

    # ------------------------------------------------------ level steps
    def forward_level(self, lvl, sigma, depth):
        partial = self._partial_forward(
            self._expand(sigma), self._expand(depth), lvl
        )  # [C*chunk, s]
        t = self._fold(partial)  # [chunk, s]
        newly = (t > 0) & (depth < 0)
        depth = torch.where(newly, lvl, depth)
        sigma = sigma + torch.where(newly, t, 0.0)
        return sigma, depth, newly.any()

    def backward_level(self, lvl, sigma, depth, omega, delta):
        partial = self._partial_backward(
            self._expand(sigma), self._expand(depth), self._expand(delta),
            self._expand(omega), lvl,
        )
        t = self._fold(partial)
        return delta + torch.where(depth == lvl, sigma * t, 0.0)


class DistributedFusedSparseOperator(DistributedFusedOperator):
    """The 2-D decomposition with the BCSR partial kernels K5/K6 as
    block-local compute — the counterpart of the JAX package's
    ``DistributedPallasSparseOperator`` (barrier schedule).

    The rank's block is its stored tile list (``tiles`` f32 [T, bm, bk],
    ``tile_rows`` / ``tile_cols`` i32 [T], row-sorted; built on the device
    by :meth:`~repro_torch.graphs.partition.TwoDPartition.cell_blocked_sparse`),
    so the rank holds and streams O(T·bm·bk) adjacency bytes instead of
    the dense block's (C·chunk)·(R·chunk).  ``row_ptr`` (the CSR row
    pointer the kernels walk) is built once here when not given.
    """

    def __init__(
        self,
        tiles: torch.Tensor,
        tile_rows: torch.Tensor,
        tile_cols: torch.Tensor,
        row_ptr: torch.Tensor | None = None,
        *,
        chunk: int,
        groups: GridGroups,
        overlap: str = "none",
        sync_axes: tuple[str, ...] = (),
    ):
        DistributedOperator.__init__(self, None, None, chunk=chunk, groups=groups,
                                     overlap=overlap, sync_axes=sync_axes)
        self.device = tiles.device
        self.tiles, self.tile_rows, self.tile_cols = tiles, tile_rows, tile_cols
        self.m = self.C * chunk
        self.row_ptr = (
            tile_row_ptr(tile_rows, self.m // tiles.shape[1]) if row_ptr is None else row_ptr
        )

    def _partial_forward(self, sigma_col, depth_col, lvl):
        return ops.frontier_spmm_sparse(
            self.tiles, self.tile_rows, self.tile_cols, sigma_col, depth_col, lvl,
            m=self.m, row_ptr=self.row_ptr,
        )

    def _partial_backward(self, sigma_col, depth_col, delta_col, omega_col, lvl):
        return ops.dependency_spmm_sparse(
            self.tiles, self.tile_rows, self.tile_cols, sigma_col, depth_col, delta_col,
            omega_col, lvl, m=self.m, row_ptr=self.row_ptr,
        )


class DistributedFusedHybridOperator(DistributedFusedSparseOperator):
    """The 2-D decomposition with a per-cell dense/BCSR kernel choice — the
    counterpart of the JAX package's ``DistributedPallasHybridOperator``
    (barrier schedule).

    One rank per device, so each rank knows its own cell's choice on the
    host: a dense-chosen cell (``dense_cell``) holds only its dense block
    (``operands = (block,)``) and runs K3/K4, a sparse-chosen cell only its
    tile list (``operands = (tiles, tile_rows, tile_cols[, row_ptr])``) and
    runs K5/K6.  The branch is taken in Python, inside the block-local
    hooks only, so every rank of a mixed grid runs the same collectives.
    (The JAX package ships both operand sets to every device and branches
    with ``lax.cond``, because ``shard_map`` needs uniform shapes.)
    """

    def __init__(
        self,
        dense_cell: bool,
        *operands: torch.Tensor,
        chunk: int,
        groups: GridGroups,
        overlap: str = "none",
        sync_axes: tuple[str, ...] = (),
    ):
        self.dense_cell = bool(dense_cell)
        kw = dict(chunk=chunk, groups=groups, overlap=overlap, sync_axes=sync_axes)
        if self.dense_cell:
            DistributedFusedOperator.__init__(self, *operands, **kw)
        else:
            super().__init__(*operands, **kw)

    def _partial_forward(self, sigma_col, depth_col, lvl):
        cls = DistributedFusedOperator if self.dense_cell else DistributedFusedSparseOperator
        return cls._partial_forward(self, sigma_col, depth_col, lvl)

    def _partial_backward(self, sigma_col, depth_col, delta_col, omega_col, lvl):
        cls = DistributedFusedOperator if self.dense_cell else DistributedFusedSparseOperator
        return cls._partial_backward(self, sigma_col, depth_col, delta_col, omega_col, lvl)
