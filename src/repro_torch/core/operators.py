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
                        ``all_reduce`` over the grid group on a 2-D grid;
                        liveness and depth over every rank when replicas
                        run in lockstep, ``sync_axes``)
  row_ids / level_cap   which vertices the rows are; worst-case levels
  root_omega            ω at the round's root vertices

Implementations: :class:`DenseOperator` (``torch.matmul`` on a dense
0/1 adjacency), :class:`SparseOperator` (``index_select`` and sorted
row sums in float64 over the padded arc list) and :class:`FusedDenseOperator`
(the hand-written level kernels K1/K2, kernels/ops.py) on one device;
:class:`DistributedOperator` (the paper's 2-D decomposition, §3.2: expand
→ arc-list local compute → fold over ``torch.distributed`` groups) and
:class:`DistributedFusedOperator` (the same collectives around the
partial kernels K3/K4 on the device's dense block),
:class:`DistributedFusedSparseOperator` (around K5/K6 on the block's
stored BCSR tiles) and :class:`DistributedFusedHybridOperator` (either
of the two, per cell) on a grid.  Each runs the barrier schedule or one
of the ring schedules of :data:`OVERLAP_POLICIES` (paper §3.2 Fig. 2).

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

from ..distributed.groups import GridGroups, all_gather, all_reduce, reduce_scatter, ring_hop
from ..kernels import ops
from ..kernels.arc_product import ArcPlan, arc_plan
from ..roofline import counter

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
    "OVERLAP_POLICIES",
    "normalize_overlap",
]

# Collective schedules of the distributed operators (paper §3.2 Fig. 2
# pipelining).  "none" is the barrier schedule: an all_gather expand, the
# block compute, a reduce_scatter fold, every rank idle through both
# collectives.  "expand" turns the expand into R-1 point-to-point ring
# hops over the column group, interleaved with per-chunk block compute
# (the next chunk is in flight while the one in hand multiplies).
# "expand+fold" also turns the fold into a C-1-hop reduce ring over the
# row group, so no collective of the group's whole width remains on a
# level.  Single-device operators have no collectives and accept only
# "none".
OVERLAP_POLICIES = ("none", "expand", "expand+fold")

#: the replica-lockstep axis a ring schedule adds to the loop-bound
#: agreement (the JAX package's ``sync_axes`` names its ``pod`` axis)
SYNC_AXES = ("replica",)


def normalize_overlap(policy: str | None) -> str:
    """Validate an overlap policy string (None means "none")."""
    policy = "none" if policy is None else policy
    if policy not in OVERLAP_POLICIES:
        raise ValueError(
            f"unknown overlap policy {policy!r}; expected one of {OVERLAP_POLICIES}"
        )
    return policy


#: the arc product's accumulator: f32 messages summed in float64, rounded
#: once to the operand's dtype (:func:`_arc_product`)
_ARC_ACC = torch.float64
#: arcs a row's first-level partial sum spans at most (:func:`_arc_pieces`)
_ARC_PIECE = 256
#: bytes of widened messages one pass of :func:`_arc_sum` may hold;
#: a wider product sums its columns in four passes
_ARC_PASS_BYTES = 1 << 30


def _arc_pieces(lengths: torch.Tensor, size: int | None = None):
    """Split each destination row's run of arcs (``lengths``, arcs sorted
    by destination) into consecutive pieces of at most ``size`` arcs
    (default :data:`_ARC_PIECE`): ``(pieces, counts)``, the arc count of
    each piece and the piece count of each row (at least one, so a row of
    no arcs has one empty piece); ``(None, lengths)`` where no row is
    longer than a piece.  The arc product sums the pieces, then each
    row's pieces, so that no thread sums a hub's ~10^5 arcs in one chain
    (at R-MAT scale 23 on an H100 that chain took ~30 ms a pass)."""
    size = _ARC_PIECE if size is None else size
    if lengths.numel() == 0 or int(lengths.max()) <= size:
        return None, lengths
    counts = ((lengths + size - 1) // size).clamp_min(1)
    row = torch.repeat_interleave(torch.arange(lengths.numel(), device=lengths.device), counts)
    k = torch.arange(row.numel(), device=lengths.device) - (counts.cumsum(0) - counts)[row]
    return (lengths[row] - k * size).clamp(0, size), counts


def _arc_operands(src: torch.Tensor, lengths: torch.Tensor, rows: int) -> tuple:
    """:func:`_arc_product`'s operands over arcs sorted by destination
    (``src`` and ``lengths`` of :func:`_by_destination`): ``(src, pieces,
    counts, plan)``.  On the card ``plan`` is the kernel's work list
    (:func:`~repro_torch.kernels.arc_product.arc_plan`) and ``src`` its
    int32 index, the only copy kept.  On the CPU, whose torch version
    needs no work list, ``plan`` is None."""
    pieces, counts = _arc_pieces(lengths)
    if src.device.type != "cuda":
        return src, pieces, counts, None
    plan = arc_plan(src, pieces, counts, rows)
    return plan.src, pieces, counts, plan


def _arc_sum(x2: torch.Tensor, src: torch.Tensor, pieces: torch.Tensor | None,
             counts: torch.Tensor, rows: int) -> torch.Tensor:
    """The arc product's torch version (the CPU's, and the card tests'
    reference): gather the messages ``x2[src]`` [arcs, s] at once, widen
    them to :data:`_ARC_ACC` and sum each piece's, then each row's pieces,
    by :func:`_segment_sum`, rounded once into [rows, s].  Where the
    widened messages would pass :data:`_ARC_PASS_BYTES`, the columns are
    widened and summed in four passes, each holding half the gather's
    bytes."""
    width = x2.shape[1]
    msgs = x2.index_select(0, src)
    out = x2.new_empty((rows, width))
    wide = msgs.numel() * torch.finfo(_ARC_ACC).bits // 8 > _ARC_PASS_BYTES
    step = max(1, -(-width // 4)) if wide else max(1, width)
    for c in range(0, width, step):
        part = msgs[:, c:c + step].to(_ARC_ACC)
        if pieces is not None:
            part = torch.segment_reduce(part, "sum", lengths=pieces, axis=0)
        out[:, c:c + step] = _segment_sum(part, counts, rows)
    return out


def _arc_product(x: torch.Tensor, src: torch.Tensor, pieces: torch.Tensor | None,
                 counts: torch.Tensor, rows: int, plan: ArcPlan | None = None) -> torch.Tensor:
    """``A @ x`` over an arc list sorted by destination (``src`` of
    :func:`_by_destination`, ``pieces`` / ``counts`` of
    :func:`_arc_pieces` over its ``lengths``, whose last, sentinel row is
    dropped, and ``plan`` their work list, :func:`_arc_operands`):
    [rows, ...] in ``x``'s dtype, row v the sum of ``x[src]`` over the
    arcs into v.  The sums run in :data:`_ARC_ACC`, in a fixed order (each
    piece's arcs in arc order, then each row's pieces, no atomics), rounded
    once: the same inputs give the same bits, and an f32 sum over a hub's
    arcs, which drifts by about u·√degree (on an H100 at R-MAT scale 23,
    degrees ~10^5, an atomic f32 ``index_add_`` left a round's BC 1.85e-5
    off the float64 oracle, past the 1e-5 the BC is held to), leaves one
    rounding.

    On the card the hand kernel sums them
    (:func:`repro_torch.kernels.ops.arc_product`, one launch a call,
    ``plan`` required): it reads each arc's operand row once into f64
    registers, with no [arcs, s] messages.  On the CPU the torch version
    :func:`_arc_sum` does, which gathers the messages first.  Either way
    the gather and the sums report their FLOP and bytes to an active
    :class:`~repro_torch.roofline.counter.WorkCounter` as the torch
    version's, at ``x``'s width and with an int64 index: the work of the
    function, whatever width accumulates it and whatever holds the
    messages or the index."""
    x2 = x.reshape(x.shape[0], -1)
    width = x2.shape[1]
    if x2.device.type == "cuda":
        out = ops.arc_product(x2, plan, rows)
    else:
        out = _arc_sum(x2, src, pieces, counts, rows)
    if counter.ACTIVE is not None:
        arcs = src.numel()
        msg_bytes = arcs * width * x2.element_size()
        index = torch.empty(arcs, dtype=torch.int64, device="meta")  # the torch version's
        counter.ACTIVE.add("arc_gather", 0.0, counter.gather_bytes(x, index))
        counter.ACTIVE.add("arc_sum", counter.sparse_flops(arcs, width),
                           counter.segment_sum_bytes(msg_bytes, counts, out))
    return out.reshape((rows,) + tuple(x.shape[1:]))


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
    """``A @ x`` via an arc-list gather and row sums
    (:func:`_arc_product`), ``out[v] = Σ_{(u,v) arcs} x[u]``.

    ``src``/``dst`` are the padded symmetric arc arrays (int64); padding
    arcs use the sentinel vertex ``n`` on both endpoints, which reads a
    zero row and sums into a discarded one.  The arcs are reordered by
    destination once, here.
    """

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        src, _, _, lengths = _by_destination(src, dst, None, n)
        self.src, self.pieces, self.counts, self.plan = _arc_operands(src, lengths, n)
        self.n_rows = n
        self.device = src.device

    def apply(self, x):
        x_pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)
        return _arc_product(x_pad, self.src, self.pieces, self.counts, self.n_rows, self.plan)


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


class DistributedOperator(TraversalOperator):
    """2-D-decomposed operator (paper §3.2) of one rank of a
    :class:`~repro_torch.distributed.groups.GridGroups` grid — the
    counterpart of the JAX package's ``DistributedOperator``.

    Per application, barrier schedule (``overlap="none"``):
      expand (Alg. 2 line 15):  ``all_gather`` over the rank's column group
          delivers the frontier slice of grid column j, ``[R·chunk, s]``.
      local compute:            gather ``x_col[src_local]`` and sum it
          by ``dst_local`` (:func:`_arc_product`, over the arcs reordered
          by destination at first use; the padding arcs sum into a
          discarded ``C·chunk + 1``-th row).
      fold (Alg. 2 line 19):    ``reduce_scatter`` over the row group sums
          the C partials and delivers each rank its owned chunk.

    Only the frontier-σ / g tensor travels; the depth test of the far
    endpoint is folded into it.  ``split_backward`` splits the backward
    exchange into two half-width collectives (the paper's unfused σ/d
    exchange, the Fig. 9 benchmark mode; barrier schedule only).

    ``overlap`` picks the schedule (:data:`OVERLAP_POLICIES`).  Under a
    ring the expand is R-1 point-to-point hops of the owned chunk over the
    column group (:meth:`_ring_partial`), each step adding only the arcs
    sourced in the chunk in hand — the ring arc slots ``ring_src_local`` /
    ``ring_dst_local`` (int64 [R, max_ring_arcs],
    :meth:`~repro_torch.graphs.partition.TwoDPartition.cell_ring_arcs`) —
    and under ``"expand+fold"`` the fold is a C-1-hop reduce ring over the
    row group (:meth:`_fold_ring`).

    ``sync_axes`` (:data:`SYNC_AXES`) puts the replicas of a sub-clustered
    grid in lockstep: liveness and max depth (``reduce_any`` /
    ``reduce_max``) agree over every rank, so each replica runs the
    maximum level count over the replicas (the extra levels are masked
    no-ops), while ``reduce_max_grid`` stays on the replica's own grid
    and still reads its own depth.  The JAX package needs it because a
    ``ppermute`` spans the whole mesh; torch's point-to-point hops of
    different replicas never meet, but the port keeps the reference's
    behaviour.
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
        ring_src_local: torch.Tensor | None = None,  # int64 [R, max_ring_arcs], chunk-relative
        ring_dst_local: torch.Tensor | None = None,  # int64 [R, max_ring_arcs]
        sync_axes: tuple[str, ...] = (),
    ):
        self.overlap = normalize_overlap(overlap)
        if self.overlap != "none" and split_backward:
            raise ValueError(
                "split_backward is a barrier-schedule benchmark mode; it cannot be "
                "combined with a ring overlap policy"
            )
        self.sync_axes = tuple(sync_axes)
        if any(a not in SYNC_AXES for a in self.sync_axes):
            raise ValueError(f"sync_axes must be drawn from {SYNC_AXES}, got {sync_axes}")
        self.src_local = src_local
        self.dst_local = dst_local
        self.ring_src_local = ring_src_local
        self.ring_dst_local = ring_dst_local
        self.chunk = chunk
        self.groups = groups
        self.R, self.C = groups.R, groups.C
        self.split_backward = split_backward
        self.n_rows = chunk
        arcs = src_local if src_local is not None else ring_src_local
        self.device = None if arcs is None else arcs.device
        self._by_dst: dict = {}

    # ---------------------------------------------- collective skeleton
    def _expand(self, x_owned: torch.Tensor) -> torch.Tensor:
        return all_gather(x_owned, self.groups.column)

    def _fold(self, partial: torch.Tensor) -> torch.Tensor:
        return reduce_scatter(partial, self.groups.row)

    def _product(self, x: torch.Tensor, slot: int | None = None) -> torch.Tensor:
        """:func:`_arc_product` over the barrier arcs (``slot`` None) or
        ring slot ``slot``, whose operands (:func:`_arc_operands`) are
        reordered by destination at first use."""
        rows = self.C * self.chunk
        if slot not in self._by_dst:
            src, dst = ((self.src_local, self.dst_local) if slot is None
                        else (self.ring_src_local[slot], self.ring_dst_local[slot]))
            src, _, _, lengths = _by_destination(src, dst, None, rows)
            self._by_dst[slot] = _arc_operands(src, lengths, rows)
        src, pieces, counts, plan = self._by_dst[slot]
        return _arc_product(x, src, pieces, counts, rows, plan)

    def _local(self, x_col: torch.Tensor) -> torch.Tensor:
        return self._product(x_col)

    # ------------------------------------------------- ring schedules
    def _column_hop(self, tensors) -> tuple[list, list]:
        """Post one expand hop: rank (i, j) sends to (i + 1, j)."""
        g = self.groups
        return ring_hop(tensors, g.col_next, g.col_prev, g.column)

    def _ring_steps(self, operands, step_fn, acc: torch.Tensor):
        """The ring-pipelined expand over the column group.

        ``operands`` are owned [chunk, ...] tensors that travel together;
        ``step_fn(r, hand, acc)`` folds the product of the chunk in hand —
        grid row ``r``'s, ``r = (i − t) mod R`` at step t — into the running
        accumulator, which starts as the zeros ``acc``, and returns it.  The
        hop of step t + 1 is posted before step t's compute, into fresh
        buffers, so the transfer overlaps the compute."""
        hand = list(operands)
        for t in range(self.R):
            nxt = self._column_hop(hand) if t + 1 < self.R else None
            acc = step_fn((self.groups.i - t) % self.R, hand, acc)
            if nxt is not None:
                hand, works = nxt
                for w in works:
                    w.wait()
        return acc

    def _ring_partial(self, x_owned: torch.Tensor) -> torch.Tensor:
        """The arc-list ring expand: at each step only the chunk in hand's
        arcs (ring slot r) are summed and added into the ``C·chunk``
        accumulator."""
        if self.ring_src_local is None or self.ring_dst_local is None:
            raise ValueError("overlap != 'none' needs the ring arc slots "
                             "(TwoDPartition.cell_ring_arcs)")
        rows = self.C * self.chunk

        def step(r, hand, acc):
            return acc.add_(self._product(hand[0], r))

        acc = x_owned.new_zeros((rows,) + tuple(x_owned.shape[1:]))
        return self._ring_steps((x_owned,), step, acc)

    def _fold_ring(self, partial: torch.Tensor) -> torch.Tensor:
        """The reduce-ring fold: C-1 hops over the row group.  Block m of
        ``partial`` (rows [m·chunk, (m+1)·chunk)) belongs to rank (i, m).
        Rank j starts with its block (j − 1) mod C and, after each hop from
        rank j − 1, adds its block (j − 1 − t) mod C; after C-1 hops it
        holds its own block summed over the row: the ``reduce_scatter``
        result."""
        C, chunk, g = self.C, self.chunk, self.groups
        if C == 1:
            return partial

        def block(m):
            m %= C
            return partial[m * chunk:(m + 1) * chunk]

        acc = block(g.j - 1)
        for t in range(1, C):
            (acc,), works = ring_hop([acc], g.row_next, g.row_prev, g.row)
            for w in works:
                w.wait()
            acc = acc + block(g.j - 1 - t)
        return acc

    def _fold_partial(self, partial: torch.Tensor) -> torch.Tensor:
        """Fold the [C·chunk, s] partial by the overlap policy."""
        if self.overlap == "expand+fold":
            return self._fold_ring(partial)
        return self._fold(partial)

    def apply(self, x_owned):
        if self.overlap == "none":
            return self._fold(self._local(self._expand(x_owned)))
        return self._fold_partial(self._ring_partial(x_owned))

    def apply_backward(self, g):
        if not self.split_backward:
            return self.apply(g)
        half = g.shape[1] // 2  # paper-style split payload (benchmark mode)
        return torch.cat([self.apply(g[:, :half]), self.apply(g[:, half:])], dim=1)

    # ------------------------------------------- collective agreements
    @staticmethod
    def _all_reduce(value: torch.Tensor, op, group) -> torch.Tensor:
        return all_reduce(value.reshape(1).clone(), op, group)[0]

    @property
    def _loop_group(self):
        """Where the loop bounds agree: every rank under replica lockstep,
        else the replica's own grid."""
        return self.groups.loop if self.sync_axes else self.groups.grid

    def reduce_any(self, alive):
        return self._all_reduce(alive.to(torch.int32), dist.ReduceOp.SUM, self._loop_group) > 0

    def reduce_max(self, value):
        return self._all_reduce(value, dist.ReduceOp.MAX, self._loop_group)

    def reduce_max_grid(self, value):
        # grid-local (never spans sync_axes): the replica's own depth
        return self._all_reduce(value, dist.ReduceOp.MAX, self.groups.grid)

    def reduce_max_sync(self, value):
        # the replica extension of a grid max (no collective without sync_axes)
        if not self.sync_axes:
            return value
        return self._all_reduce(value, dist.ReduceOp.MAX, self.groups.replica)

    def reduce_sum(self, value):
        return all_reduce(value.clone(), dist.ReduceOp.SUM, self.groups.grid)

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
    ``DistributedPallasOperator``.

    ``block`` is the rank's dense adjacency block A[rows_i, cols_j],
    ``[C·chunk, R·chunk]`` (f32, or bf16: 0/1 values are exact); under a
    ring schedule it is the same block as R contiguous column slabs
    ``[R, C·chunk, chunk]``
    (:meth:`~repro_torch.graphs.partition.TwoDPartition.cell_dense_slabs`),
    slab r the operand of the step whose chunk in hand is grid row r's.
    The kernels fuse the frontier mask / g recompute into the block
    product; the state update needs the t summed over the grid row, so it
    runs in torch after the fold.  The exchanges therefore carry (σ, d)
    forward and (σ, d, δ, ω) backward — the paper's §3.2 exchange set —
    instead of the arc-list operator's one pre-masked tensor.

    The block seam: ``_full_block()`` / ``_ring_block(r)`` give the
    barrier schedule's and ring step r's A-operand, ``_partial_forward`` /
    ``_partial_backward`` hand it to the kernel, with the running sum of
    the ring steps as the kernels' ``acc`` operand.  The BCSR and hybrid
    subclasses replace only the seam; the schedules, the checked steps and
    the epilogue are written once, here.
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

    # ------------------------------------------------------ block seam
    def _full_block(self):
        """The barrier schedule's A-operand: the whole block."""
        return self.block

    def _ring_block(self, r: int):
        """Ring step r's A-operand: the columns of grid row r's chunk."""
        return self.block[r]

    def _partial_forward(self, block, sigma, depth, lvl, acc=None):
        return ops.frontier_spmm_partial(block, sigma, depth, lvl, acc)

    def _partial_backward(self, block, sigma, depth, delta, omega, lvl, acc=None):
        return ops.dependency_spmm_partial(block, sigma, depth, delta, omega, lvl, acc)

    # ----------------------------------------------------- the products
    def _ring_acc(self, sigma: torch.Tensor) -> torch.Tensor:
        """The ring's zero [C·chunk, s] f32 running sum: every step, the
        first too, runs the kernels' ``acc`` mode, as the JAX package's
        ring does."""
        return torch.zeros((self.C * self.chunk, sigma.shape[1]), dtype=torch.float32,
                           device=sigma.device)

    def _forward_partial(self, lvl, sigma, depth):
        """The [C·chunk, s] pre-fold forward partial under the schedule."""
        if self.overlap == "none":
            return self._partial_forward(self._full_block(), self._expand(sigma),
                                         self._expand(depth), lvl)
        return self._ring_steps((sigma, depth), lambda r, hand, acc: self._partial_forward(
            self._ring_block(r), hand[0], hand[1], lvl, acc), self._ring_acc(sigma))

    def _backward_partial(self, lvl, sigma, depth, delta, omega):
        """The [C·chunk, s] pre-fold backward partial under the schedule."""
        if self.overlap == "none":
            return self._partial_backward(
                self._full_block(), self._expand(sigma), self._expand(depth),
                self._expand(delta), self._expand(omega), lvl)
        return self._ring_steps(
            (sigma, depth, delta, omega), lambda r, hand, acc: self._partial_backward(
                self._ring_block(r), hand[0], hand[1], hand[2], hand[3], lvl, acc),
            self._ring_acc(sigma))

    # ------------------------------------------------------ level steps
    def forward_level(self, lvl, sigma, depth):
        t = self._fold_partial(self._forward_partial(lvl, sigma, depth))  # [chunk, s]
        newly = (t > 0) & (depth < 0)
        depth = torch.where(newly, lvl, depth)
        sigma = sigma + torch.where(newly, t, 0.0)
        return sigma, depth, newly.any()

    def backward_level(self, lvl, sigma, depth, omega, delta):
        t = self._fold_partial(self._backward_partial(lvl, sigma, depth, delta, omega))
        return delta + torch.where(depth == lvl, sigma * t, 0.0)

    # The checked steps: the single-device fused operator's extended
    # operands (the lane column's σ, d, δ make the kernels' own recompute
    # land on the column sum), through the same expand or ring and fold —
    # the lane survives the all_gather, every hop and the reduce_scatter
    # because each is linear per column, so one residual on the folded t
    # audits the whole pipeline.  The BCSR and hybrid subclasses inherit
    # them through the block seam.
    def forward_level_checked(self, lvl, sigma, depth):
        fsum = (sigma * (depth == lvl - 1)).sum(dim=1, keepdim=True)
        sg = torch.cat([sigma, fsum], dim=1)
        dp = torch.cat([depth, torch.full_like(depth[:, :1], lvl - 1)], dim=1)
        t = self._fold_partial(self._forward_partial(lvl, sg, dp))
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
        t = self._fold_partial(self._backward_partial(lvl, sg, dp, dl, omega))
        err = ops.checksum_residual(t)
        return delta + torch.where(depth == lvl, sigma * t[:, :-1], 0.0), err


class DistributedFusedSparseOperator(DistributedFusedOperator):
    """The 2-D decomposition with the BCSR partial kernels K5/K6 as
    block-local compute — the counterpart of the JAX package's
    ``DistributedPallasSparseOperator``.

    Barrier schedule: the rank's block is its stored tile list (``tiles``
    f32 [T, bm, bk], ``tile_rows`` / ``tile_cols`` i32 [T], row-sorted;
    built on the device by
    :meth:`~repro_torch.graphs.partition.TwoDPartition.cell_blocked_sparse`),
    so the rank holds O(T·bm·bk) adjacency bytes instead of the dense
    block's (C·chunk)·(R·chunk).  K5/K6 read the tiles' nonzero ``index``
    (:func:`~repro_torch.kernels.blocked_spmm.nonzero_index`, built once
    per layout by :func:`~repro_torch.core.distributed.distributed_graph_arrays`;
    None on the CPU, where the plain versions read the tiles) instead of
    the tiles, so a level streams O(nnz) of them.

    Ring schedules: each of the four operands is a length-R sequence, slot
    r's tile list (tile-cols re-based to the chunk,
    :meth:`~repro_torch.graphs.partition.TwoDPartition.cell_ring_blocked_sparse`)
    and its own nonzero index (m = C·chunk, k = chunk), the operand of
    the step whose chunk in hand is grid row r's.
    """

    def __init__(
        self,
        tiles,
        tile_rows,
        tile_cols,
        index,
        *,
        chunk: int,
        groups: GridGroups,
        overlap: str = "none",
        sync_axes: tuple[str, ...] = (),
    ):
        DistributedOperator.__init__(self, None, None, chunk=chunk, groups=groups,
                                     overlap=overlap, sync_axes=sync_axes)
        if self.overlap == "none":
            self.full = (tiles, tile_rows, tile_cols, index)
            self.device = tiles.device
        else:
            self.slots = list(zip(tiles, tile_rows, tile_cols, index))
            if len(self.slots) != self.R:
                raise ValueError(f"a ring needs {self.R} tile slots, got {len(self.slots)}")
            self.device = self.slots[0][0].device
        self.m = self.C * chunk

    def _full_block(self):
        return self.full

    def _ring_block(self, r: int):
        return self.slots[r]

    def _partial_forward(self, block, sigma, depth, lvl, acc=None):
        tiles, rows, cols, index = block
        return ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, lvl, m=self.m,
                                        acc=acc, index=index)

    def _partial_backward(self, block, sigma, depth, delta, omega, lvl, acc=None):
        tiles, rows, cols, index = block
        return ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, lvl,
                                          m=self.m, acc=acc, index=index)


class DistributedFusedHybridOperator(DistributedFusedSparseOperator):
    """The 2-D decomposition with a per-cell dense/BCSR kernel choice — the
    counterpart of the JAX package's ``DistributedPallasHybridOperator``.

    One rank per device, so each rank knows its own cell's choice on the
    host: a dense-chosen cell (``dense_cell``) holds only its dense block
    (``operands = (block,)``, slabs under a ring) and runs K3/K4, a
    sparse-chosen cell only its tile list and its nonzero index
    (``operands = (tiles, tile_rows, tile_cols, index)``, R slots of each
    under a ring) and runs K5/K6.  The branch is taken in Python, inside
    the block seam only, so every rank of a mixed grid runs the same
    collectives and hops under every schedule.
    (The JAX package ships both operand sets to every device and branches
    with ``lax.cond``, because ``shard_map`` needs uniform shapes.)
    """

    def __init__(
        self,
        dense_cell: bool,
        *operands,
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

    def _cls(self):
        return DistributedFusedOperator if self.dense_cell else DistributedFusedSparseOperator

    def _full_block(self):
        return self._cls()._full_block(self)

    def _ring_block(self, r):
        return self._cls()._ring_block(self, r)

    def _partial_forward(self, block, sigma, depth, lvl, acc=None):
        return self._cls()._partial_forward(self, block, sigma, depth, lvl, acc)

    def _partial_backward(self, block, sigma, depth, delta, omega, lvl, acc=None):
        return self._cls()._partial_backward(self, block, sigma, depth, delta, omega, lvl, acc)


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


def _by_destination(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor | None, rows: int):
    """The arcs (and weights, if any) reordered by destination (stable),
    and the arc count of each of the ``rows + 1`` destination rows (the
    last the sentinel's)."""
    order = torch.argsort(dst, stable=True)
    dst = dst[order]
    return (src[order], dst, None if w is None else w[order],
            torch.bincount(dst, minlength=rows + 1))


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
    the grid group, so every rank reads the same trip decisions — on every
    rank with ``sync_axes``, the only part of a ring policy a weighted run
    takes (its collectives stay on the barrier schedule, as in the JAX
    package).
    """

    weighted = True

    def __init__(self, src_local, dst_local, w_local, *, delta: float, chunk: int,
                 groups: GridGroups, sync_axes: tuple[str, ...] = ()):
        src_local, dst_local, w_local, self.lengths = _by_destination(
            src_local, dst_local, w_local.to(torch.float32), groups.C * chunk)
        super().__init__(src_local, dst_local, chunk=chunk, groups=groups, sync_axes=sync_axes)
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
        folded = all_reduce(partial.contiguous(), dist.ReduceOp.MIN, self.groups.row)
        j = self.groups.j
        return folded[j * self.chunk:(j + 1) * self.chunk]

    def reduce_min(self, value):
        return self._all_reduce(value, dist.ReduceOp.MIN, self._loop_group)

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
                 groups: GridGroups, sync_axes: tuple[str, ...] = ()):
        DistributedOperator.__init__(self, None, None, chunk=chunk, groups=groups,
                                     sync_axes=sync_axes)
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
