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
  *_level_checked(...)  the same level with the transient ABFT checksum
                        lane, plus the level's residual (integrity=
                        "checksum"; the fused operator runs K3/K4)
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

The weighted (bucketed delta-stepping) traversal has its own protocol,
:class:`WeightedTraversalOperator` — ``relax`` / ``sigma_step`` /
``delta_step`` plus ``reduce_min`` — which the bucket loops of the engine
drive: :class:`WeightedDenseOperator` (broadcast min-plus and
equality-masked ``einsum`` on an [n, n] weight matrix) and
:class:`WeightedSparseOperator` (gathers, ``scatter_reduce_(amin)`` and
sorted segment sums over the padded arc list) on one device,
:class:`DistributedWeightedOperator` (arc list) and
:class:`DistributedWeightedDenseOperator` (dense weight block) on a grid.
As in the JAX package, these are tensor ops, not kernels.
"""
from __future__ import annotations

from typing import Callable

import math

import torch
import torch.distributed as dist

from ..distributed.groups import GridGroups, all_gather, reduce_scatter
from ..kernels import ops
from ..kernels.blocked_spmm import NonzeroIndex

__all__ = [
    "TraversalOperator",
    "DenseOperator",
    "SparseOperator",
    "FusedDenseOperator",
    "DistributedOperator",
    "DistributedFusedOperator",
    "DistributedFusedSparseOperator",
    "DistributedFusedHybridOperator",
    "WeightedTraversalOperator",
    "WeightedDenseOperator",
    "WeightedSparseOperator",
    "DistributedWeightedOperator",
    "DistributedWeightedDenseOperator",
    "auto_delta",
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


def _forward_level_checked(op: "TraversalOperator", lvl: int, sigma, depth):
    """:func:`_forward_level` with a transient ABFT ones-checksum lane:
    appended to the masked frontier just before the product, stripped
    right after (σ/d stay [n, s]).  Returns the usual triple plus the
    product's relative column-sum residual (f32 0-d tensor)."""
    frontier = sigma * (depth == lvl - 1)
    t = op.apply(ops.checksum_append(frontier))
    err = ops.checksum_residual(t)
    contrib = t[:, :-1]
    newly = (contrib > 0) & (depth < 0)
    depth = torch.where(newly, lvl, depth)
    sigma = sigma + torch.where(newly, contrib, 0.0)
    return sigma, depth, newly.any(), err


def _backward_level_checked(op: "TraversalOperator", lvl: int, sigma, depth, omega, delta):
    """:func:`_backward_level` with the transient checksum lane on the
    ``A @ g`` product; returns (δ', residual)."""
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    g = torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)
    t = op.apply_backward(ops.checksum_append(g))
    err = ops.checksum_residual(t)
    return delta + torch.where(depth == lvl, sigma * t[:, :-1], 0.0), err


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

    def forward_level_checked(self, lvl: int, sigma, depth):
        """:meth:`forward_level` + the level's ABFT checksum residual:
        ``(σ', d', alive, err)``; state shapes as unchecked."""
        return _forward_level_checked(self, lvl, sigma, depth)

    def backward_level_checked(self, lvl: int, sigma, depth, omega, delta):
        """:meth:`backward_level` + the level's residual: ``(δ', err)``."""
        return _backward_level_checked(self, lvl, sigma, depth, omega, delta)

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

    # K1/K2 never expose the raw product t, so the checked steps run the
    # partial kernels K3/K4 on the square adjacency instead, with the
    # checksum lane as one extra operand column whose (σ, d, δ) make the
    # kernel's own recompute land on the column sum: forward
    # σ_c = Σ_j σ_j·[d_j = lvl−1], d_c = lvl−1; backward σ_c = 1,
    # d_c = lvl+1, δ_c = Σ_j g_j − 1 − ω (so g_c = 1 + δ_c + ω = Σ_j g_j).
    def forward_level_checked(self, lvl, sigma, depth):
        fsum = (sigma * (depth == lvl - 1)).sum(dim=1, keepdim=True)
        sg = torch.cat([sigma, fsum], dim=1)
        dp = torch.cat([depth, torch.full_like(depth[:, :1], lvl - 1)], dim=1)
        t = ops.frontier_spmm_partial(self.adjacency, sg, dp, lvl)
        err = ops.checksum_residual(t)
        contrib = t[:, :-1]
        newly = (contrib > 0) & (depth < 0)
        depth2 = torch.where(newly, lvl, depth)
        sigma2 = sigma + torch.where(newly, contrib, 0.0)
        return sigma2, depth2, newly.any(), err

    def backward_level_checked(self, lvl, sigma, depth, omega, delta):
        safe_sigma = torch.where(sigma > 0, sigma, 1.0)
        g = torch.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe_sigma, 0.0)
        sg = torch.cat([sigma, torch.ones_like(sigma[:, :1])], dim=1)
        dp = torch.cat([depth, torch.full_like(depth[:, :1], lvl + 1)], dim=1)
        dl = torch.cat([delta, g.sum(dim=1, keepdim=True) - 1.0 - omega[:, None]], dim=1)
        t = ops.dependency_spmm_partial(self.adjacency, sg, dp, dl, omega, lvl)
        err = ops.checksum_residual(t)
        return delta + torch.where(depth == lvl, sigma * t[:, :-1], 0.0), err


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

    def forward_level_checked(self, lvl, sigma, depth):
        raise _not_ported("the ABFT checksum lane on a 2-D grid (integrity='checksum')", 8)

    def backward_level_checked(self, lvl, sigma, depth, omega, delta):
        raise _not_ported("the ABFT checksum lane on a 2-D grid (integrity='checksum')", 8)

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
    so the rank holds O(T·bm·bk) adjacency bytes instead of the dense
    block's (C·chunk)·(R·chunk).  K5/K6 read the tiles' nonzero ``index``
    (:func:`~repro_torch.kernels.blocked_spmm.nonzero_index`, built once
    per layout by :func:`~repro_torch.core.distributed.distributed_graph_arrays`;
    None on the CPU, where the plain versions read the tiles) instead of
    the tiles, so a level streams O(nnz) of them.
    """

    def __init__(
        self,
        tiles: torch.Tensor,
        tile_rows: torch.Tensor,
        tile_cols: torch.Tensor,
        index: NonzeroIndex | None,
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
        self.index = index

    def _partial_forward(self, sigma_col, depth_col, lvl):
        return ops.frontier_spmm_sparse(
            self.tiles, self.tile_rows, self.tile_cols, sigma_col, depth_col, lvl,
            m=self.m, index=self.index,
        )

    def _partial_backward(self, sigma_col, depth_col, delta_col, omega_col, lvl):
        return ops.dependency_spmm_sparse(
            self.tiles, self.tile_rows, self.tile_cols, sigma_col, depth_col, delta_col,
            omega_col, lvl, m=self.m, index=self.index,
        )


class DistributedFusedHybridOperator(DistributedFusedSparseOperator):
    """The 2-D decomposition with a per-cell dense/BCSR kernel choice — the
    counterpart of the JAX package's ``DistributedPallasHybridOperator``
    (barrier schedule).

    One rank per device, so each rank knows its own cell's choice on the
    host: a dense-chosen cell (``dense_cell``) holds only its dense block
    (``operands = (block,)``) and runs K3/K4, a sparse-chosen cell only its
    tile list and its nonzero index (``operands = (tiles, tile_rows,
    tile_cols, index)``) and runs K5/K6.  The branch is taken in Python,
    inside the block-local hooks only, so every rank of a mixed grid runs
    the same collectives.
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


# --------------------------------------------------------------------------
# Weighted traversal (delta-stepping buckets, Fan et al. arXiv:1701.05975)
# --------------------------------------------------------------------------
#
# No kernel here, as in the JAX package: the bucket steps are equality-
# masked min-plus / sum contractions in tensor ops.  Weights stay f32 on
# every engine (the fused_bf16 ones included): distances feed exact
# equality masks.

_BIG_DIST = 1e30  # segment-min guard: anything above is "unreached"


def auto_delta(graph) -> float:
    """Bucket width from edge-weight statistics (host side): the mean
    weight over the mean degree, the classic Θ(w̄ / degree) guidance,
    clamped below by the minimum weight so that a bucket always makes
    progress.  Deterministic in the graph."""
    w = getattr(graph, "w", None)
    if w is None or w.size == 0:
        raise ValueError("auto_delta needs a weighted graph with at least one edge")
    avg_degree = max(1.0, float(graph.num_arcs) / float(max(1, graph.n)))
    return float(max(float(w.min()), float(w.mean()) / avg_degree))


def _check_delta(delta) -> float:
    delta = float(delta)
    if not (delta > 0.0) or not math.isfinite(delta):
        raise ValueError(f"bucket width delta must be positive and finite, got {delta}")
    return delta


def _bucket_split(w: torch.Tensor, delta: float, heavy: bool) -> torch.Tensor:
    """Per-arc weight with the arcs not selected pushed to +inf: *light*
    arcs (0 < w <= Δ) relax to a fixpoint inside a bucket, *heavy* ones
    (w > Δ) once after it settles.  Weight 0 (padding, "no edge") is in
    neither."""
    sel = (w > delta) if heavy else (w > 0) & (w <= delta)
    return torch.where(sel, w, torch.inf)


def _weight_split(w: torch.Tensor, delta: float):
    """``(light, heavy, full)`` weights of every operator: the two halves
    of :func:`_bucket_split` and every edge's weight (+inf where w = 0,
    no edge) for the equality masks."""
    return (_bucket_split(w, delta, heavy=False), _bucket_split(w, delta, heavy=True),
            torch.where(w > 0, w, torch.inf))


def _pad_row(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x`` with one extra row of ``fill``: the sentinel row the padding
    arcs read from and write to."""
    return torch.cat([x, x.new_full((1,) + tuple(x.shape[1:]), fill)], dim=0)


def _segment_min(val: torch.Tensor, index: torch.Tensor, rows: int) -> torch.Tensor:
    """Row-wise min of ``val`` [arcs, s] into ``rows`` segments (+inf where
    no arc lands; the sentinel row ``rows`` dropped), then the
    ``> _BIG_DIST → inf`` guard."""
    out = val.new_full((rows + 1, val.shape[1]), torch.inf)
    out.scatter_reduce_(0, index[:, None].expand_as(val), val, "amin", include_self=True)
    out = out[:rows]
    return torch.where(out > _BIG_DIST, torch.inf, out)


def _by_destination(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, rows: int):
    """The arcs reordered by destination (stable), and the arc count of
    each of the ``rows + 1`` destination rows (the last the sentinel's)."""
    order = torch.argsort(dst, stable=True)
    dst = dst[order]
    return src[order], dst, w[order], torch.bincount(dst, minlength=rows + 1)


def _segment_sum(val: torch.Tensor, lengths: torch.Tensor, rows: int) -> torch.Tensor:
    """Row-wise sum of ``val`` [arcs, s], arcs sorted by destination with
    ``lengths`` arcs a row, the sentinel row dropped.  Each row is summed
    in arc order by one thread, so the same inputs give the same bits: the
    σ and δ fixpoints stop when a trip changes nothing, and ``index_add_``'s
    atomics on the card would change the last bits of a fractional or
    above-2^24 sum from trip to trip, so that they never stopped."""
    return torch.segment_reduce(val, "sum", lengths=lengths, axis=0)[:rows]


class WeightedTraversalOperator(TraversalOperator):
    """Single-device weighted operator: the bucket-loop protocol that
    :func:`repro_torch.core.engine.forward_buckets` /
    :func:`~repro_torch.core.engine.backward_buckets` drive —

      relax(dist, frontier, heavy)  min over the selected arcs (u, v) with
          u in the frontier of ``dist[u] + w``; +inf where none relaxes v;
      sigma_step(sigma_in, dist)    σ'_v = Σ_{u : d_v = d_u + w} σ_in[u]
          (predecessor counting through the distance-equality mask);
      delta_step(g, dist)           Σ_{v : d_v = d_u + w} g[v] per u (the
          dependency sum over successors);

    — and ``reduce_min`` for the bucket skip (the identity on one device).
    """

    weighted = True

    def __init__(self, delta: float):
        self.delta = _check_delta(delta)

    def reduce_min(self, value: torch.Tensor) -> torch.Tensor:
        return value

    def relax(self, dist, frontier, heavy: bool):  # pragma: no cover - interface
        raise NotImplementedError

    def sigma_step(self, sigma_in, dist):  # pragma: no cover - interface
        raise NotImplementedError

    def delta_step(self, g, dist):  # pragma: no cover - interface
        raise NotImplementedError


class WeightedDenseOperator(WeightedTraversalOperator):
    """[n, n] f32 weight matrix (0 = no edge): min-plus relaxation and
    equality-masked ``einsum``, all over [n, n, s] broadcasts — small n
    only (n = 65 536 would need terabytes)."""

    def __init__(self, weights: torch.Tensor, delta: float):
        super().__init__(delta)
        self.weights = weights.to(torch.float32)
        self.n_rows = weights.shape[0]
        self.device = weights.device
        self.mask = self.weights > 0
        self.w_light, self.w_heavy, self.w_full = _weight_split(self.weights, self.delta)

    def relax(self, dist, frontier, heavy):
        wsel = self.w_heavy if heavy else self.w_light
        d = torch.where(frontier, dist, torch.inf)
        # cand[v, s] = min_u d[u, s] + w[u, v]
        return (d[:, None, :] + wsel[:, :, None]).amin(dim=0)

    def _eq(self, dist):
        # eq[u, v, s]: arc (u, v) lies on a shortest path into v
        cand = dist[:, None, :] + self.w_full[:, :, None]
        return self.mask[:, :, None] & torch.isfinite(cand) & (dist[None, :, :] == cand)

    def sigma_step(self, sigma_in, dist):
        return torch.einsum("uvs,us->vs", self._eq(dist).to(torch.float32), sigma_in)

    def delta_step(self, g, dist):
        return torch.einsum("uvs,vs->us", self._eq(dist).to(torch.float32), g)


class WeightedSparseOperator(WeightedTraversalOperator):
    """Padded arc list (int64 ``src`` / ``dst``, f32 ``w``): gathers,
    ``scatter_reduce_(amin)`` for the relaxation, sorted segment sums
    (:func:`_segment_sum`) for the σ and δ steps, over the arcs reordered
    by destination once here.  Sentinel arcs point at vertex slot ``n``
    with weight 0; every accumulation has n+1 rows and drops the sentinel
    row, as :class:`SparseOperator` does."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, n: int,
                 delta: float):
        super().__init__(delta)
        self.src, self.dst, self.w, self.lengths = _by_destination(
            src, dst, w.to(torch.float32), n)
        self.n_rows = n
        self.device = src.device
        self.w_light, self.w_heavy, self.w_full = _weight_split(self.w, self.delta)

    def relax(self, dist, frontier, heavy):
        wsel = self.w_heavy if heavy else self.w_light
        d_pad = _pad_row(torch.where(frontier, dist, torch.inf), torch.inf)
        return _segment_min(d_pad[self.src] + wsel[:, None], self.dst, self.n_rows)

    def sigma_step(self, sigma_in, dist):
        d_pad = _pad_row(dist, torch.inf)
        cand = d_pad[self.src] + self.w_full[:, None]
        eq = torch.isfinite(cand) & (d_pad[self.dst] == cand)
        contrib = torch.where(eq, _pad_row(sigma_in, 0.0)[self.src], 0.0)
        return _segment_sum(contrib, self.lengths, self.n_rows)

    def delta_step(self, g, dist):
        # the successor test from the dst side: the symmetric arc list
        # serves both directions, so g accumulates over arcs (y, x) with
        # d_y = d_x + w into x
        d_pad = _pad_row(dist, torch.inf)
        cand = d_pad[self.dst] + self.w_full[:, None]
        eq = torch.isfinite(cand) & (d_pad[self.src] == cand)
        contrib = torch.where(eq, _pad_row(g, 0.0)[self.src], 0.0)
        return _segment_sum(contrib, self.lengths, self.n_rows)


class DistributedWeightedOperator(DistributedOperator):
    """The 2-D decomposition of the weighted traversal, arc-list local
    compute (barrier schedule).

    Per relax: expand the frontier's masked distances over the column
    group (``all_gather``), a per-arc min-plus into the [C·chunk] partial
    (``scatter_reduce_(amin)`` over the arcs reordered by destination),
    then the *min-fold*: ``all_reduce(MIN)``
    over the row group and the rank's owned chunk sliced out — the
    min-plus analogue of the ``reduce_scatter`` fold.  σ / δ steps are
    equality-masked sorted segment sums folded with ``reduce_scatter``; their
    equality test needs the output-side distances, replicated with an
    ``all_gather`` over the row group (block j = rank (i, j)'s chunk, the
    order ``dst_local`` indexes).  ``reduce_min`` / ``reduce_any`` run on
    the grid group, so every rank reads the same trip decisions.
    """

    weighted = True

    def __init__(self, src_local, dst_local, w_local, *, delta: float, chunk: int,
                 groups: GridGroups):
        src_local, dst_local, w_local, self.lengths = _by_destination(
            src_local, dst_local, w_local.to(torch.float32), groups.C * chunk)
        super().__init__(src_local, dst_local, chunk=chunk, groups=groups)
        self.delta = _check_delta(delta)
        self._weights(w_local)

    def _weights(self, w: torch.Tensor) -> None:
        self.w_local = w.to(torch.float32)
        self.w_light, self.w_heavy, self.w_full = _weight_split(self.w_local, self.delta)

    # ------------------------------------------------ collective pieces
    def _expand_out(self, x_owned: torch.Tensor) -> torch.Tensor:
        """[chunk, s] → [C·chunk, s], block j holding rank (i, j)'s chunk."""
        return all_gather(x_owned, self.groups.row)

    def _min_fold(self, partial: torch.Tensor) -> torch.Tensor:
        folded = partial.contiguous()
        dist.all_reduce(folded, op=dist.ReduceOp.MIN, group=self.groups.row)
        j = self.groups.j
        return folded[j * self.chunk:(j + 1) * self.chunk]

    def reduce_min(self, value):
        return self._all_reduce(value, dist.ReduceOp.MIN)

    # ------------------------------------------------------ bucket hooks
    def relax(self, dist_, frontier, heavy):
        wsel = self.w_heavy if heavy else self.w_light
        d_col = self._expand(torch.where(frontier, dist_, torch.inf))  # [R·chunk, s]
        partial = _segment_min(d_col[self.src_local] + wsel[:, None], self.dst_local,
                               self.C * self.chunk)
        return self._min_fold(partial)

    def sigma_step(self, sigma_in, dist_):
        s_col, d_col = self._expand(sigma_in), self._expand(dist_)
        d_out = _pad_row(self._expand_out(dist_), torch.inf)
        cand = d_col[self.src_local] + self.w_full[:, None]
        eq = torch.isfinite(cand) & (d_out[self.dst_local] == cand)
        contrib = torch.where(eq, s_col[self.src_local], 0.0)
        return self._fold(_segment_sum(contrib, self.lengths, self.C * self.chunk))

    def delta_step(self, g, dist_):
        g_col, d_col = self._expand(g), self._expand(dist_)
        d_out = _pad_row(self._expand_out(dist_), torch.inf)
        cand = d_out[self.dst_local] + self.w_full[:, None]
        eq = torch.isfinite(cand) & (d_col[self.src_local] == cand)
        contrib = torch.where(eq, g_col[self.src_local], 0.0)
        return self._fold(_segment_sum(contrib, self.lengths, self.C * self.chunk))


class DistributedWeightedDenseOperator(DistributedWeightedOperator):
    """The weighted 2-D decomposition on the rank's dense f32 weight block
    W[rows_i, cols_j], [C·chunk, R·chunk] (0 = no edge): the collectives
    of :class:`DistributedWeightedOperator` around [m, k, s] broadcasts.
    The ``fused``, ``fused_bf16``, ``fused_sparse`` and ``fused_hybrid``
    engines all run their weighted rounds through it (BCSR cells turned
    into the dense block first), as the JAX package's Pallas engines run
    theirs through its XLA counterpart; small blocks only."""

    def __init__(self, weight_block: torch.Tensor, *, delta: float, chunk: int,
                 groups: GridGroups):
        DistributedOperator.__init__(self, None, None, chunk=chunk, groups=groups)
        self.device = weight_block.device
        self.delta = _check_delta(delta)
        self._weights(weight_block)
        self.mask = self.w_local > 0

    def relax(self, dist_, frontier, heavy):
        wsel = self.w_heavy if heavy else self.w_light
        d_col = self._expand(torch.where(frontier, dist_, torch.inf))  # [k, s]
        return self._min_fold((wsel[:, :, None] + d_col[None, :, :]).amin(dim=1))

    def sigma_step(self, sigma_in, dist_):
        s_col, d_col = self._expand(sigma_in), self._expand(dist_)
        d_out = self._expand_out(dist_)  # [m, s]
        cand = d_col[None, :, :] + self.w_full[:, :, None]  # [m, k, s]
        eq = self.mask[:, :, None] & torch.isfinite(cand) & (d_out[:, None, :] == cand)
        return self._fold(torch.where(eq, s_col[None, :, :], 0.0).sum(dim=1))

    def delta_step(self, g, dist_):
        g_col, d_col = self._expand(g), self._expand(dist_)
        d_out = self._expand_out(dist_)
        cand = d_out[:, None, :] + self.w_full[:, :, None]
        eq = self.mask[:, :, None] & torch.isfinite(cand) & (d_col[None, :, :] == cand)
        return self._fold(torch.where(eq, g_col[None, :, :], 0.0).sum(dim=1))
