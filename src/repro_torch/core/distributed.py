"""Distributed MGBC: 2-D decomposition + sub-clustering (paper §3.2-3.3).

Communication structure per traversal level, per sub-cluster (an R×C
grid of ranks; see graphs/partition.py for the chunk layout and
distributed/groups.py for the process groups):

  expand (paper Alg. 2 line 15):
      ``all_gather`` of the owned frontier chunks over the rank's column
      group  →  F[cols_j] on every rank of grid column j.
  local compute:
      * ``engine_kind="sparse"`` — gather F[src_local] and sum it by
        dst_local (float64 row sums over the arcs sorted by destination);
      * ``engine_kind="fused"`` / ``"fused_bf16"`` — the rank's dense
        adjacency block through the partial kernels K3/K4
        (kernels/csrc/partial_spmm.cu), f32 or bf16 block;
      * ``engine_kind="fused_sparse"`` — the block's stored (bm × bk)
        BCSR tiles through K5/K6 (kernels/csrc/sparse_spmm.cu, which sum
        over the tiles' nonzero index), for graphs whose dense blocks do
        not fit;
      * ``engine_kind="fused_hybrid"`` — per cell, whichever of the two
        the bytes model (:func:`hybrid_cell_choice`) picks.
  fold (Alg. 2 line 19):
      ``reduce_scatter`` of the partials over the rank's row group — sums
      the C contributions and delivers each rank exactly its owned chunk.

That is the barrier schedule (``overlap="none"``).  The ring schedules
(paper §3.2 Fig. 2) replace it with point-to-point hops:
``overlap="expand"`` passes the owned chunks round the column group in
R-1 hops, each step multiplying the chunk in hand against its slot of the
cell (the ring layouts of graphs/partition.py: arc slots, dense column
slabs or BCSR tile slots, with the kernels' ``acc`` running sum);
``"expand+fold"`` also folds with a C-1-hop reduce ring over the row
group; ``"auto"`` picks one from the roofline level times
(:func:`resolve_overlap`).  Under a ring the replicas of a sub-clustered
grid agree on their loop bounds over every rank (``sync_axes``).
``integrity="audit"`` / ``"checksum"`` make every round self-checking
(the ABFT lane of the checked level steps rides every exchange, hop and
fold).  The traversal itself — level loops, round algebra, host loop — is
not implemented here: the round function builds
a :class:`~repro_torch.core.operators.DistributedOperator` (or its fused
subclass) and runs the same
:func:`~repro_torch.core.driver.traversal_round` /
:class:`~repro_torch.core.driver.BCDriver` as the single-device path.
Every rank runs the same deterministic host schedule and the same driver
loop; each block's results come back to every rank, so the driver's host
state (ledger, n_s, accumulator) is identical everywhere.  Two host
decisions are made agreed rather than assumed: a checkpoint is loaded by
every rank, written by rank 0 alone and fenced by a barrier
(:class:`_GridCheckpoint`), and a stop rule's verdict is rank 0's,
broadcast (:class:`_GridStopRule`) — ranks that disagreed would issue
different collectives and hang.  For the same reason every duration the
driver decides on (a straggler policy's block walls, the watchdog's
elapsed time) is the max over the ranks (:func:`_max_over_ranks`).

The measured-cost autotuner (``autotune=``, :mod:`repro_torch.autotune`)
plans on every rank alike: rank 0 alone reads and writes the cache file
and sends its entries to the others (:func:`_grid_cost_cache`), and every
measured wall is the all-ranks max.  A chaos plan (``chaos=``,
:mod:`repro_torch.distributed.chaos`) wraps the block function on every
rank — every rank makes the same dispatch calls, so its faults fire
alike — and the files on rank 0, which writes them; rank 0's counters are
sent to all.

Sub-clustering (paper §3.3): ``fr`` replicas of the R×C grid each take
one round of every dispatch block; BC is additive, so the driver sums the
replica lanes.  With ``fr > 1`` a ``straggler`` policy moves rounds
between the replicas' queues (the driver's multi-ledger loop), priced
before any round has run by :func:`prior_round_seconds`.

Weighted BC (``weighted=True``, bucketed delta-stepping) runs the same
driver with a weighted 2-D operator, always on the barrier layouts and
collectives (a ring policy only adds the replica lockstep; ``"auto"``
resolves to ``"none"``): the arc list with its per-arc
weights for ``sparse``
(:class:`~repro_torch.core.operators.DistributedWeightedOperator`), the
rank's dense f32 weight block for every fused engine
(:class:`~repro_torch.core.operators.DistributedWeightedDenseOperator`;
a BCSR cell's weighted tiles are turned into that block with
:func:`~repro_torch.kernels.ref.tiles_to_dense`, as the JAX package does
in its program body).  None of K1–K6 runs on a weighted round.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..autotune import CostCache, as_cache, normalize_autotune, plan_autotune, sample_batch
from ..distributed.chaos import ChaosCheckpoint, ChaosCostCache, ChaosFS, ChaosRoundFn, FaultPlan
from ..distributed.groups import GridGroups, all_gather, device_for_rank
from ..graphs.graph import Graph
from ..graphs.partition import TwoDPartition, partition_2d
from ..kernels.blocked_spmm import NonzeroIndex, nonzero_index
from ..kernels.ref import tiles_to_dense
from ..roofline.model import (
    H100,
    HardwareSpec,
    adjacency_stream_bytes,
    auto_overlap_policy,
    cell_kernel_choice,
    device_hbm_footprint,
    exchange_operands,
    sampled_run_seconds,
    sparse_tile_bytes,
)
from ..serving.sampling import AdaptiveStopRule, eligible_roots, plan_sampling
from .bc import apply_sampling_rescale, check_weighted
from .driver import (
    DEFAULT_MAX_RETRIES,
    DEFAULT_RETRY_BACKOFF_S,
    BCDriver,
    normalize_integrity,
    normalize_straggler,
    traversal_round,
)
from .operators import (
    SYNC_AXES,
    DistributedFusedHybridOperator,
    DistributedFusedOperator,
    DistributedFusedSparseOperator,
    DistributedOperator,
    DistributedWeightedDenseOperator,
    DistributedWeightedOperator,
    normalize_overlap,
)
from .scheduler import build_schedule

__all__ = [
    "DIST_ENGINE_KINDS",
    "REFERENCE_DIST_ENGINE",
    "hybrid_cell_choice",
    "estimate_device_footprint",
    "check_device_memory",
    "level_time_estimates",
    "resolve_overlap",
    "distributed_graph_arrays",
    "make_distributed_operator",
    "make_distributed_round_fn",
    "distributed_betweenness_centrality",
    "one_degree_reduce_distributed",
    "weighted_prior_levels",
    "prior_round_seconds",
    "PRIOR_LEVELS",
    "WATCHDOG_SAFETY",
    "WATCHDOG_MIN_DEADLINE_S",
]

logger = logging.getLogger(__name__)

#: ``dispatch_deadline_s="auto"`` resolves to
#: ``max(WATCHDOG_MIN_DEADLINE_S, WATCHDOG_SAFETY × prior_round_seconds)``:
#: generous on purpose, since the prior models steady-state levels while
#: the first dispatch also builds the kernels and NCCL's communicators,
#: and a false trip evicts a healthy replica (the JAX package's constants)
WATCHDOG_SAFETY = 50.0
WATCHDOG_MIN_DEADLINE_S = 60.0

#: block-local compute engines of the distributed path: arc-list
#: gather/scatter-add, the partial kernels K3/K4 on a dense f32 / bf16
#: block, K5/K6 on the block's BCSR tiles, or the per-cell hybrid of the
#: last two
DIST_ENGINE_KINDS = ("sparse", "fused", "fused_bf16", "fused_sparse", "fused_hybrid")

#: port engine -> the JAX package's distributed engine computing the same thing
REFERENCE_DIST_ENGINE = {
    "sparse": "sparse",
    "fused": "pallas",
    "fused_bf16": "pallas_bf16",
    "fused_sparse": "pallas_sparse",
    "fused_hybrid": "pallas_hybrid",
}
_TILED = ("fused_sparse", "fused_hybrid")

#: the nominal traversal depth that stands in for a round's level count
#: before any round has run (the JAX package's straggler and sampling
#: prior: it seeds every replica's EWMA alike, so only its order of
#: magnitude matters)
PRIOR_LEVELS = 16


def weighted_prior_levels(w: np.ndarray, delta: float) -> int:
    """Expected bucket count standing in for :data:`PRIOR_LEVELS` in a
    weighted run: at the nominal hop depth a traversal spans about
    ``PRIOR_LEVELS · w̄`` of distance, ``⌈PRIOR_LEVELS · w̄ / Δ⌉`` buckets,
    never fewer than :data:`PRIOR_LEVELS` (a wide Δ merges buckets, but
    each still costs at least a level's collectives)."""
    w = np.asarray(w, np.float64)
    w_mean = float(w.mean()) if w.size else 1.0
    return max(PRIOR_LEVELS, int(np.ceil(PRIOR_LEVELS * w_mean / float(delta))))


def _check_engine(engine_kind: str) -> None:
    if engine_kind not in DIST_ENGINE_KINDS:
        raise ValueError(
            f"unknown distributed engine {engine_kind!r}; expected one of {DIST_ENGINE_KINDS}"
        )


def hybrid_cell_choice(
    partition: TwoDPartition,
    bm: int | None = None,
    bk: int | None = None,
    *,
    threshold: float = 1.0,
    tile_counts: dict | None = None,
    measured: tuple[float, float] | None = None,
) -> tuple[np.ndarray, dict]:
    """The ``fused_hybrid`` engine's per-cell dense-vs-BCSR choice:
    :func:`repro_torch.roofline.model.cell_kernel_choice` over the per-cell
    stored-tile counts of the partition's cached counting pass (pass
    ``tile_counts`` to reuse one dict).  The choice is logged, so runs are
    auditable, and ``threshold`` (``--hybrid-threshold``) overrides the
    break-even.  ``measured`` is the autotuner's (dense_level_s,
    sparse_level_s) calibration: with it the break-even compares measured
    seconds instead of the bytes model.  Returns ``(dense_cells bool
    [R, C], tile_counts)``."""
    counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
    dense_cells = cell_kernel_choice(
        counts["stored_full_cell"], R=partition.R, C=partition.C, chunk=partition.chunk,
        bm=counts["bm"], bk=counts["bk"], threshold=threshold, measured=measured,
    )
    logger.info(
        "hybrid cell choice (threshold %.3g, tile %dx%d, %s): %d dense / %d sparse cells %s",
        threshold, counts["bm"], counts["bk"],
        "measured costs" if measured is not None else "roofline bytes", int(dense_cells.sum()),
        int(dense_cells.size - dense_cells.sum()), dense_cells.astype(int).tolist(),
    )
    return dense_cells, counts


def estimate_device_footprint(
    partition: TwoDPartition,
    engine_kind: str,
    batch_size: int,
    *,
    bm: int | None = None,
    bk: int | None = None,
    overlap: str = "none",
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
) -> dict:
    """Per-device adjacency + state bytes of one engine, before anything is
    allocated: :func:`repro_torch.roofline.model.device_hbm_footprint` with
    the partition's quantities, for the largest rank, under the layout the
    ``overlap`` policy builds (the JAX package's pricing).

    ``fused_sparse`` prices the stored tiles of the fullest cell (nonzero
    tiles + row fillers, from the counting pass; no tile data is built),
    under a ring the R slots padded to the fullest slot (``stored_tiles_ring``).
    ``sparse`` under a ring prices the 2·R·max_ring_arcs arc slots
    (:meth:`TwoDPartition.ring_arcs_max`); the dense column slabs hold the
    block's bytes.
    ``fused_hybrid`` prices what the port allocates: each rank's chosen
    representation only — the dense block of a dense-chosen cell, the
    tiles of a sparse-chosen one (``dense_cells``, default: the
    break-even choice of :func:`hybrid_cell_choice`; a sparse cell's ring
    slots priced as R times its fullest slot) — and the largest rank
    decides.  This is less
    than the JAX package's hybrid footprint, which prices the union of
    both operand sets that ``shard_map`` ships to every device.
    ``bm``/``bk`` are the tile the engine will be built with.
    """
    R, C, chunk = partition.R, partition.C, partition.chunk
    ring = normalize_overlap(overlap) != "none"
    grid = dict(R=R, C=C, chunk=chunk, batch_size=batch_size)
    if engine_kind == "sparse":
        max_arcs = R * partition.ring_arcs_max() if ring else int(partition.src_local.shape[-1])
        return device_hbm_footprint(engine_kind, max_arcs=max_arcs, **grid)
    if engine_kind not in _TILED:
        return device_hbm_footprint(engine_kind, **grid)
    counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
    tile = dict(bm=counts["bm"], bk=counts["bk"])
    if engine_kind == "fused_sparse":
        return device_hbm_footprint(
            engine_kind, nnz_tiles=counts["stored_tiles_ring" if ring else "stored_tiles_full"],
            **tile, **grid
        )
    if dense_cells is None:
        dense_cells, _ = hybrid_cell_choice(partition, tile_counts=counts)
    stored = (R * counts["stored_ring_slot_cell"] if ring else counts["stored_full_cell"])
    feet = [
        device_hbm_footprint(
            engine_kind, nnz_tiles=int(stored[i, j]),
            dense_cell=bool(dense_cells[i, j]), **tile, **grid,
        )
        for i in range(R) for j in range(C)
    ]
    return max(feet, key=lambda f: f["total_bytes"])


def check_device_memory(
    partition: TwoDPartition,
    engine_kind: str,
    batch_size: int,
    hbm_limit_bytes: float | None,
    *,
    bm: int | None = None,
    bk: int | None = None,
    overlap: str = "none",
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
) -> dict:
    """Fail-fast memory guard: raise ``MemoryError`` before anything is
    allocated when the footprint (:func:`estimate_device_footprint`, of the
    ``overlap`` policy's layout) exceeds ``hbm_limit_bytes`` — the card's
    capacity, an input here — with a suggestion (``fused_sparse`` where
    it fits, a larger grid).  Returns the footprint record, which is
    always computed and logged."""
    foot = estimate_device_footprint(
        partition, engine_kind, batch_size, bm=bm, bk=bk, overlap=overlap,
        tile_counts=tile_counts, dense_cells=dense_cells,
    )
    logger.info(
        "per-device memory footprint (%s): adjacency %.3f GiB + state %.3f GiB = %.3f GiB%s",
        engine_kind, foot["adjacency_bytes"] / 2**30, foot["state_bytes"] / 2**30,
        foot["total_bytes"] / 2**30,
        "" if hbm_limit_bytes is None else f" (budget {hbm_limit_bytes / 2**30:.2f} GiB)",
    )
    if hbm_limit_bytes is not None and foot["total_bytes"] > hbm_limit_bytes:
        suggestions = []
        if engine_kind in ("fused", "fused_bf16", "fused_hybrid"):
            sparse_foot = estimate_device_footprint(
                partition, "fused_sparse", batch_size, bm=bm, bk=bk, overlap=overlap,
                tile_counts=tile_counts
            )
            if sparse_foot["total_bytes"] <= hbm_limit_bytes:
                suggestions.append(
                    "engine_kind='fused_sparse' (blocked-sparse adjacency: "
                    f"{sparse_foot['total_bytes'] / 2**30:.2f} GiB/device)"
                )
        suggestions.append("a larger grid (per-device footprint scales ~1/p)")
        raise MemoryError(
            f"engine_kind={engine_kind!r} needs {foot['total_bytes'] / 2**30:.2f} GiB/device "
            f"(adjacency {foot['adjacency_bytes'] / 2**30:.2f} GiB + state "
            f"{foot['state_bytes'] / 2**30:.2f} GiB) but the memory budget is "
            f"{hbm_limit_bytes / 2**30:.2f} GiB; try " + " or ".join(suggestions)
        )
    return foot


def level_time_estimates(
    partition: TwoDPartition,
    engine_kind: str,
    batch_size: int,
    *,
    bm: int | None = None,
    bk: int | None = None,
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
    hw: HardwareSpec = H100,
) -> tuple[float, float, float]:
    """Roofline prices of one traversal level on ``hw``: (compute, expand,
    fold) seconds — the JAX package's model with the port's engine names.
    Block compute is the larger of its FLOPs over ``hw.peak_flops`` and
    its adjacency bytes over ``hw.hbm_bandwidth``; the hybrid is priced per
    cell (each streams its chosen representation, ``dense_cells``,
    default the break-even choice) and the level waits for the slowest.
    The expand moves (R−1)·chunk·s·4 bytes per forward operand and the
    fold (C−1)/C of the [C·chunk, s] f32 partial, over
    ``hw.link_bandwidth``."""
    R, C, chunk, s = partition.R, partition.C, partition.chunk, batch_size
    compute_s = None
    if engine_kind in ("fused", "fused_bf16"):
        flops = 2.0 * (C * chunk) * (R * chunk) * s
        a_bytes = adjacency_stream_bytes(engine_kind, R=R, C=C, chunk=chunk)
    elif engine_kind == "fused_sparse":
        counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
        bm, bk, nnz = counts["bm"], counts["bk"], counts["nnz_max"]
        flops = 2.0 * nnz * bm * bk * s
        a_bytes = adjacency_stream_bytes(engine_kind, R=R, C=C, chunk=chunk, nnz_tiles=nnz,
                                         bm=bm, bk=bk)
    elif engine_kind == "fused_hybrid":
        counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
        if dense_cells is None:
            dense_cells, _ = hybrid_cell_choice(partition, tile_counts=counts)
        bm, bk = counts["bm"], counts["bk"]
        dense_flops = 2.0 * (C * chunk) * (R * chunk) * s
        dense_bytes = adjacency_stream_bytes("fused", R=R, C=C, chunk=chunk)
        stored = np.asarray(counts["stored_full_cell"], np.float64)
        cell_flops = np.where(dense_cells, dense_flops, 2.0 * stored * bm * bk * s)
        cell_bytes = np.where(dense_cells, dense_bytes, stored * sparse_tile_bytes(bm, bk))
        cell_s = np.maximum(cell_flops / hw.peak_flops, cell_bytes / hw.hbm_bandwidth)
        compute_s = float(cell_s.max())  # the level waits for the slowest cell
    else:  # the arc list: one gather + add per arc per source column
        max_arcs = int(partition.src_local.shape[-1])
        flops = 2.0 * max_arcs * s
        a_bytes = adjacency_stream_bytes(engine_kind, R=R, C=C, chunk=chunk,
                                         max_arcs=max_arcs)
    if compute_s is None:
        compute_s = max(flops / hw.peak_flops, a_bytes / hw.hbm_bandwidth)
    n_operands = exchange_operands(engine_kind)[0]  # the forward exchange set
    expand_s = (R - 1) * chunk * s * 4 * n_operands / hw.link_bandwidth
    fold_s = (C - 1) / C * (C * chunk) * s * 4 / hw.link_bandwidth
    return compute_s, expand_s, fold_s


def resolve_overlap(
    overlap: str | None,
    partition: TwoDPartition,
    engine_kind: str,
    batch_size: int,
    *,
    bm: int | None = None,
    bk: int | None = None,
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
    hw: HardwareSpec = H100,
    measured: dict | None = None,
) -> str:
    """``overlap="auto"`` resolved to the schedule
    :func:`~repro_torch.roofline.model.auto_overlap_policy` prices fastest
    from :func:`level_time_estimates` (the tile and the hybrid choice the
    engine is built with); the pick and the estimates are logged.
    ``measured`` (policy -> the autotuner's measured per-level seconds)
    takes precedence: when any policy has a measurement, the pick compares
    the measured policies only.  An explicit policy is only validated."""
    if overlap != "auto":
        return normalize_overlap(overlap)
    compute_s, expand_s, fold_s = level_time_estimates(
        partition, engine_kind, batch_size, bm=bm, bk=bk, tile_counts=tile_counts,
        dense_cells=dense_cells, hw=hw,
    )
    policy, estimates = auto_overlap_policy(compute_s, expand_s, fold_s, partition.R,
                                            partition.C, hw=hw, measured=measured)
    logger.info("overlap='auto' -> %r for engine %s (%s per-level estimates: %s)",
                policy, engine_kind, "measured" if measured else f"roofline, {hw.name},",
                {k: f"{v * 1e6:.2f}us" for k, v in estimates.items()})
    return policy


def prior_round_seconds(
    partition: TwoDPartition,
    engine_kind: str,
    batch_size: int,
    overlap: str,
    *,
    bm: int | None = None,
    bk: int | None = None,
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
    hw: HardwareSpec = H100,
    measured_level_s: float | None = None,
    prior_levels: int | None = None,
) -> float:
    """Per-round wall estimate before any round has run — the straggler
    EWMA's prior, the ``"auto"`` watchdog deadline's base and the sampled
    run's expected wall: :data:`PRIOR_LEVELS` nominal levels (or
    ``prior_levels``, a weighted run's expected bucket count,
    :func:`weighted_prior_levels`) times one level's seconds.  A level is
    the autotuner's ``measured_level_s`` of the resolved configuration
    where there is one, else priced on ``hw`` under the resolved
    collective schedule ``overlap`` (:func:`level_time_estimates` through
    :func:`~repro_torch.roofline.model.auto_overlap_policy`'s estimate
    table).  The JAX package's model."""
    levels = PRIOR_LEVELS if prior_levels is None else int(prior_levels)
    if measured_level_s is not None:
        return float(measured_level_s) * levels
    compute_s, expand_s, fold_s = level_time_estimates(
        partition, engine_kind, batch_size, bm=bm, bk=bk, tile_counts=tile_counts,
        dense_cells=dense_cells, hw=hw,
    )
    _, estimates = auto_overlap_policy(compute_s, expand_s, fold_s, partition.R, partition.C,
                                       hw=hw)
    return estimates[normalize_overlap(overlap)] * levels


def distributed_graph_arrays(
    partition: TwoDPartition,
    engine_kind: str,
    i: int,
    j: int,
    device,
    *,
    overlap: str = "none",
    tile: tuple[int, int] | None = None,
    dense_cells: np.ndarray | None = None,
    weights: np.ndarray | None = None,
) -> tuple:
    """Grid cell (i, j)'s graph operands on ``device``: the flat arc arrays
    ``(src_local, dst_local)`` (int64 [max_arcs]) for ``"sparse"``; the
    dense block ``(A[rows_i, cols_j],)`` ([C·chunk, R·chunk], bf16 for
    ``"fused_bf16"``, built on the device) for the dense fused engines;
    the cell's BCSR list and the nonzero index K5/K6 read
    ``(tiles, tile_rows, tile_cols, index)``
    (:meth:`TwoDPartition.cell_blocked_sparse` at ``tile``, default the
    largest divisor of chunk ≤ 128, multiples of 8 preferred;
    :func:`~repro_torch.kernels.blocked_spmm.nonzero_index` of it, built
    here once per layout on a CUDA device, None on the CPU) for
    ``"fused_sparse"``; for ``"fused_hybrid"`` whichever of the last two
    ``dense_cells[i, j]`` (the :func:`hybrid_cell_choice`) picks — a rank
    never holds both.

    Under a ring ``overlap`` the same operands in their ring form: the arc
    slots ``(ring_src, ring_dst)`` (int64 [R, max_ring_arcs],
    :meth:`TwoDPartition.cell_ring_arcs`); the dense block as R contiguous
    column slabs ``(slabs,)`` ([R, C·chunk, chunk],
    :meth:`TwoDPartition.cell_dense_slabs`); the BCSR cell as its R slots,
    ``(tiles, tile_rows, tile_cols, index)`` each a tuple of R (the slots of
    :meth:`TwoDPartition.cell_ring_blocked_sparse`, and one nonzero index
    per slot at m = C·chunk, built once here on the card).

    ``weights`` (f32 [num_arcs], graph arc order) gives the weighted
    operands instead, always in the barrier form: ``sparse`` grows a third f32 [max_arcs] arc-weight
    array; the dense engines hold an f32 weight block, also under
    ``fused_bf16`` (the equality masks need exact distances); a BCSR cell
    holds its weighted tiles and no nonzero index (no K5/K6 runs)."""
    _check_engine(engine_kind)
    ring = weights is None and normalize_overlap(overlap) != "none"
    if engine_kind == "sparse" and ring:
        return partition.cell_ring_arcs(i, j, device)
    if engine_kind == "sparse":
        arcs = tuple(
            torch.from_numpy(a[i, j]).to(device=device, dtype=torch.int64)
            for a in (partition.src_local, partition.dst_local)
        )
        if weights is None:
            return arcs
        cell_w = partition.arc_weights(weights)[i, j]
        return arcs + (torch.from_numpy(cell_w).to(device),)
    if engine_kind == "fused_hybrid":
        if dense_cells is None:
            raise ValueError("fused_hybrid needs dense_cells (hybrid_cell_choice)")
        engine_kind = "fused" if dense_cells[i, j] else "fused_sparse"
    m = partition.C * partition.chunk
    if engine_kind == "fused_sparse" and ring:
        slots = partition.cell_ring_blocked_sparse(i, j, *(tile or (None, None)),
                                                   device=device)
        indexes = tuple(nonzero_index(*slot, m) if slot[0].device.type == "cuda" else None
                        for slot in slots)
        return tuple(zip(*slots)) + (indexes,)
    if engine_kind == "fused_sparse":
        tiles, rows, cols = partition.cell_blocked_sparse(
            i, j, *(tile or (None, None)), device=device, weights=weights
        )
        on_card = tiles.device.type == "cuda" and weights is None
        return tiles, rows, cols, nonzero_index(tiles, rows, cols, m) if on_card else None
    dtype = torch.bfloat16 if engine_kind == "fused_bf16" and weights is None else torch.float32
    if ring:
        return (partition.cell_dense_slabs(i, j, dtype, device),)
    return (partition.cell_dense_block(i, j, dtype, device, weights=weights),)


def make_distributed_operator(
    engine_kind: str,
    graph_args: tuple[torch.Tensor, ...],
    *,
    chunk: int,
    groups: GridGroups,
    dense_cell: bool = False,
    split_backward: bool = False,
    delta: float | None = None,
    overlap: str = "none",
    sync_axes: tuple[str, ...] = (),
) -> DistributedOperator:
    """The rank's 2-D operator of an engine over its
    :func:`distributed_graph_arrays` (built with the same ``overlap``);
    ``dense_cell`` is the rank's ``fused_hybrid`` choice, ``sync_axes``
    the replica lockstep.  A ``delta`` builds the weighted operator over
    weighted operands, on the barrier schedule whatever the ``overlap``:
    the arc list for ``sparse``, else the dense weight block (a BCSR
    cell's tiles turned into it here)."""
    kw = dict(chunk=chunk, groups=groups, sync_axes=sync_axes)
    if delta is not None:
        if engine_kind == "sparse":
            return DistributedWeightedOperator(*graph_args, delta=delta, **kw)
        if len(graph_args) == 1:  # a dense block
            return DistributedWeightedDenseOperator(graph_args[0], delta=delta, **kw)
        tiles, rows, cols, _ = graph_args
        block = tiles_to_dense(tiles, rows, cols, groups.C * chunk, groups.R * chunk)
        return DistributedWeightedDenseOperator(block, delta=delta, **kw)
    kw["overlap"] = overlap
    if engine_kind == "sparse" and normalize_overlap(overlap) != "none":
        ring_src, ring_dst = graph_args
        return DistributedOperator(None, None, ring_src_local=ring_src, ring_dst_local=ring_dst,
                                   split_backward=split_backward, **kw)
    if engine_kind == "sparse":
        return DistributedOperator(*graph_args, split_backward=split_backward, **kw)
    if engine_kind == "fused_sparse":
        return DistributedFusedSparseOperator(*graph_args, **kw)
    if engine_kind == "fused_hybrid":
        return DistributedFusedHybridOperator(dense_cell, *graph_args, **kw)
    return DistributedFusedOperator(*graph_args, **kw)


def make_distributed_round_fn(
    partition: TwoDPartition,
    groups: GridGroups,
    *,
    num_levels: int | None = None,
    fuse_backward_payload: bool = True,
    engine_kind: str = "sparse",
    dense_cells: np.ndarray | None = None,
    delta: float | None = None,
    overlap: str = "none",
    integrity: str = "off",
):
    """Build this rank's sub-cluster-parallel, 2-D-distributed round function

        round_fn(graph_args, omega f32 [n_pad], sources i32 [fr, s],
                 derived i32 [fr, k, 3])
          -> (bc f32 [fr, n_pad], ns f32 [fr, s+k], roots i32 [fr, s+k],
              levels i32 [fr])

    ``graph_args`` is :func:`distributed_graph_arrays` of the rank's cell
    (for ``"fused_hybrid"`` built with the same ``dense_cells``, which
    this needs too); ``omega`` the 1-degree weights in vertex order (the
    rank reads its owned chunk).  Replica f runs round f of the block;
    every output is gathered to every rank (the BC in vertex order, the
    rest across the replica group), and ``levels`` are each replica's own
    traversal depth.

    ``fuse_backward_payload=False`` splits the backward exchange into two
    half-width collectives (the paper's unfused σ/d exchange, Fig. 9;
    sparse engine, barrier schedule only).

    ``overlap`` (:data:`~repro_torch.core.operators.OVERLAP_POLICIES`,
    resolved: not ``"auto"``) picks the schedule; ``graph_args`` must be
    built with the same policy.  Under a ring with ``groups.fr > 1`` the
    replicas agree on their loop bounds over every rank (``sync_axes``).

    ``integrity`` (:data:`~repro_torch.core.driver.INTEGRITY_MODES`) makes
    the round self-checking: a fifth output, f32 [fr, 2] — per replica the
    max ABFT checksum residual of its level steps (``"checksum"``; 0 under
    ``"audit"``) and its claimed bc sum.  ``"checksum"`` needs the fused
    backward payload: the lane must travel with every exchanged operand.

    A bucket width ``delta`` runs the weighted (bucketed) round over
    :func:`distributed_graph_arrays` built with ``weights=``, on the
    barrier collectives whatever the ``overlap`` (which then only sets the
    lockstep); the split payload and ``integrity="checksum"`` are refused
    then (the operator checks ``delta``, the round ``num_levels``).
    """
    if (groups.R, groups.C) != (partition.R, partition.C):
        raise ValueError(
            f"process grid {(groups.R, groups.C)} != partition grid "
            f"{(partition.R, partition.C)}"
        )
    _check_engine(engine_kind)
    if engine_kind != "sparse" and not fuse_backward_payload:
        raise ValueError("split backward payload is a sparse-engine benchmark mode")
    if engine_kind == "fused_hybrid" and dense_cells is None:
        raise ValueError("fused_hybrid needs dense_cells (hybrid_cell_choice)")
    if delta is not None and not fuse_backward_payload:
        raise ValueError("split backward payload is an unweighted sparse-engine "
                         "benchmark mode")
    overlap = normalize_overlap(overlap)
    integrity = normalize_integrity(integrity)
    if integrity == "checksum" and not fuse_backward_payload:
        raise ValueError("integrity='checksum' needs the fused backward payload: the "
                         "checksum lane must travel with every exchanged operand")
    if overlap != "none" and not fuse_backward_payload:
        raise ValueError("split backward payload is a barrier-schedule benchmark mode; it "
                         "cannot be combined with a ring overlap policy")
    if delta is not None and integrity == "checksum":
        raise ValueError("integrity='checksum' is a level-synchronous ABFT lane; weighted "
                         "rounds support integrity='audit'")
    # the replicas agree on loop bounds under a ring (the JAX package's
    # ppermute spans the whole mesh; see DistributedOperator)
    sync_axes = SYNC_AXES if groups.fr > 1 and overlap != "none" else ()
    chunk = partition.chunk
    base = partition.owned_vertex_base(groups.i, groups.j)
    dense_cell = engine_kind == "fused_hybrid" and bool(dense_cells[groups.i, groups.j])

    def round_fn(graph_args, omega, sources, derived):
        op = make_distributed_operator(
            engine_kind, graph_args, chunk=chunk, groups=groups, dense_cell=dense_cell,
            split_backward=not fuse_backward_payload,
            delta=None if delta is None else float(delta),
            overlap=overlap if delta is None else "none", sync_axes=sync_axes,
        )
        bc, ns, roots, levels, *integ = traversal_round(
            op, sources[groups.f], derived[groups.f], omega[base : base + chunk],
            num_levels=num_levels, integrity=integrity,
        )
        level_t = torch.tensor([levels], dtype=torch.int32, device=bc.device)
        return (
            groups.gather_vertices(bc),
            groups.gather_replicas(ns),
            groups.gather_replicas(roots),
            groups.gather_replicas(level_t)[:, 0],
        ) + tuple(groups.gather_replicas(x) for x in integ)

    return round_fn


def one_degree_reduce_distributed(
    graph: Graph, device: str | torch.device | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Distributed 1-degree preprocessing (paper Alg. 6, §3.4.1).

    The arc list is sharded over every rank of the default process group;
    degrees are a local scatter-add plus one ``all_reduce``, then the arcs
    incident to a leaf are marked and ω accumulated the same way — the
    shards are independent except for two n-sized all-reduces.

    Returns (omega int64 [n], arc_removed bool [m2]) on every rank —
    identical to :func:`repro_torch.core.heuristics.one_degree.one_degree_reduce`.
    """
    dev = device_for_rank(device)
    p, rank = dist.get_world_size(), dist.get_rank()
    n = graph.n
    src_p, dst_p, m2 = graph.padded_arcs(multiple=p)  # padding arcs hit vertex n
    per = src_p.shape[0] // p
    src = torch.from_numpy(src_p[rank * per : (rank + 1) * per]).to(dev, torch.int64)
    dst = torch.from_numpy(dst_p[rank * per : (rank + 1) * per]).to(dev, torch.int64)
    deg = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, src, torch.ones_like(src)
    )
    dist.all_reduce(deg)
    leaf = deg == 1  # the padding vertex n never touches a real arc
    removed = leaf[src] | leaf[dst]
    omega = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, dst, leaf[src].to(torch.int64)
    )
    dist.all_reduce(omega)
    removed_all = all_gather(removed.to(torch.int32), None)
    return omega[:n].cpu().numpy(), removed_all[:m2].cpu().numpy().astype(bool)


def _host_barrier(dev: torch.device) -> None:
    """Every rank of the default group reaches this point before any
    leaves it, host included (the readback waits for the collective)."""
    token = torch.zeros(1, device=dev)
    dist.all_reduce(token)
    token.item()


class _GridCheckpoint:
    """A :class:`BCCheckpoint` shared by the ranks of a grid: every rank
    loads it (the same file, so the same resume point), rank 0 alone
    saves, and every rank waits at a barrier after each save, so no rank
    reads a half-rotated generation.  Everything else is the wrapped
    checkpoint's."""

    def __init__(self, checkpoint, dev: torch.device):
        self._inner = checkpoint
        self._dev = dev

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, *args, **kwargs) -> None:
        if dist.get_rank() == 0:
            self._inner.save(*args, **kwargs)
        _host_barrier(self._dev)


def _max_over_ranks(dev: torch.device):
    """``seconds -> the max over every rank of the default group``: the
    driver's ``agree_seconds`` on a grid."""

    def agree(seconds: float) -> float:
        t = torch.tensor([float(seconds)], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    return agree


def _from_rank0(obj):
    """Rank 0's ``obj`` on every rank of the default group (pickled)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _grid_cost_cache(autotune_cache, chaos_fs: ChaosFS | None) -> CostCache:
    """The autotuner's cache on a grid.  Rank 0 alone reads and writes the
    file (``autotune_cache``: a path, a :class:`CostCache` or None; under a
    chaos plan a path becomes a :func:`ChaosCostCache`); every other rank
    plans on an in-memory copy of rank 0's entries, sent before the plan
    starts.  A rank that read the file while rank 0 rewrote it could see a
    torn file, miss where rank 0 hits, time a candidate rank 0 does not,
    and hang the grid."""
    if dist.get_rank() == 0:
        if chaos_fs is not None and isinstance(autotune_cache, (str, os.PathLike)):
            cache = ChaosCostCache(autotune_cache, chaos_fs)
        else:
            cache = as_cache(autotune_cache)
        _from_rank0(cache.entries)
        return cache
    cache = CostCache(None)
    cache.entries = _from_rank0(None)
    return cache


class _GridStopRule:
    """A stop rule whose verdict is rank 0's, broadcast to every rank: the
    driver loops of all ranks must halt at the same block."""

    def __init__(self, rule, dev: torch.device):
        self.rule = rule
        self._dev = dev

    @property
    def stats(self):
        return getattr(self.rule, "stats", None)

    def __call__(self, bc, blocks_done: int) -> bool:
        verdict = torch.tensor([int(bool(self.rule(bc, blocks_done)))], device=self._dev)
        dist.broadcast(verdict, src=0)
        return bool(verdict.item())


def distributed_betweenness_centrality(
    graph: Graph,
    groups: GridGroups,
    *,
    batch_size: int = 16,
    heuristics: str = "h0",
    num_levels: int | None = None,
    engine_kind: str = "sparse",
    overlap: str = "none",
    tile: tuple[int, int] | None = None,
    hybrid_threshold: float = 1.0,
    hbm_limit_bytes: float | None = None,
    ledger=None,
    checkpoint=None,
    straggler: str = "none",
    straggler_factor: float = 2.0,
    autotune: str = "off",
    autotune_cache=None,
    chaos=None,
    max_retries: int = DEFAULT_MAX_RETRIES,
    retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
    numeric_guard: bool | None = None,
    integrity: str = "off",
    dispatch_deadline_s=None,
    clock=None,
    sleeper=None,
    sampling: str = "off",
    sample_frac: float | None = None,
    sample_k: int | None = None,
    sample_seed: int = 0,
    stop_rule=None,
    full_result: bool = False,
    weighted: bool = False,
    delta: float | None = None,
    device: str | torch.device | None = None,
):
    """Run the full distributed BC computation on the grid of ``groups``.

    Every rank of the default process group calls this with the same
    arguments.  Rounds are dealt ``fr`` at a time (one per sub-cluster)
    by the shared :class:`~repro_torch.core.driver.BCDriver`.
    ``engine_kind`` selects the block-local compute
    (:data:`DIST_ENGINE_KINDS`); ``tile`` (bm, bk) shapes the BCSR tiles
    of ``fused_sparse`` / ``fused_hybrid`` (default: the largest divisor of
    chunk ≤ 128, multiples of 8 preferred), ``hybrid_threshold`` is the
    hybrid's dense/BCSR break-even (:func:`hybrid_cell_choice`), and
    ``hbm_limit_bytes`` arms the memory guard (:func:`check_device_memory`)
    before anything is allocated; the footprint is always computed and
    returned in ``BCResult.layout_stats``.  ``heuristics``, ``num_levels``,
    ``ledger``, ``checkpoint`` (every rank passes a checkpoint on the same
    path: all load it, rank 0 writes it) and ``sampling`` ("fixed" or
    "adaptive"; ``sample_frac`` / ``sample_k`` / ``sample_seed``, rescaled
    by N/k; ``stop_rule`` may end it early, on rank 0's verdict) behave as
    in the single-device entry point.  ``device=None`` runs on the card
    ``cuda:LOCAL_RANK`` under NCCL; ``device="cpu"`` on the host under
    gloo.

    ``overlap`` picks the collective schedule: ``"none"`` (barrier),
    ``"expand"``, ``"expand+fold"`` (the ring schedules, on the ring
    layouts, priced by the memory guard as such) or ``"auto"``
    (:func:`resolve_overlap`, logged).  ``integrity`` ("audit" or
    "checksum", :data:`~repro_torch.core.driver.INTEGRITY_MODES`) audits
    every block on the driver's quarantine ladder; under ``"steal"`` a
    duplicated tail round's two replicas also vote.

    ``straggler`` (:data:`~repro_torch.core.driver.STRAGGLER_POLICIES`)
    runs the driver's multi-ledger loop over the ``fr`` replicas
    (``ValueError`` on a grid with ``fr == 1``): one ledger per replica,
    EWMAs seeded from :func:`prior_round_seconds`, rounds re-dealt
    (``"redeal"``, when a replica's EWMA passes ``straggler_factor ×`` the
    fastest's) or stolen (``"steal"``), and a lost replica re-meshed
    around (``mesh_shape=(fr, R, C)``).  ``max_retries`` /
    ``retry_backoff_s`` / ``numeric_guard`` are the driver's self-healing
    knobs; ``dispatch_deadline_s`` arms its watchdog — seconds, or
    ``"auto"`` for ``max(WATCHDOG_MIN_DEADLINE_S, WATCHDOG_SAFETY ×
    prior)``, logged; ``clock`` / ``sleeper`` are its time sources
    (default real time).  Every rank decides on the same numbers: block
    walls and the watchdog's elapsed time are maxed over the ranks.
    Under sampling the expected wall (rounds × the prior) is logged.

    ``weighted`` / ``delta`` run the bucketed weighted traversal, with the
    single-device entry point's checks (``graph.w`` needed, heuristics in
    ``WEIGHTED_HEURISTICS``, no ``num_levels``, Δ from ``auto_delta`` when
    None); the BCSR and hybrid cells are turned into dense weight blocks.
    A weighted run keeps the barrier layouts and collectives (a ring
    policy only puts the replicas in lockstep, ``"auto"`` resolves to
    ``"none"``), refuses ``integrity="checksum"`` (``ValueError``: the lane
    is level-synchronous) and audits its rounds against a bucket bound,
    ⌈n·w_max/Δ⌉ + 2, instead of n + 1 levels.

    ``autotune`` (:data:`~repro_torch.autotune.AUTOTUNE_MODES`) puts
    measurements in place of the roofline's guesses behind the tile pick,
    the hybrid cell choice, ``overlap="auto"`` and the straggler prior
    (``"cache"``: read the cache only; ``"measure"``: time a candidate on a
    miss and record it, :func:`~repro_torch.autotune.plan_autotune`), and
    packs rounds by eccentricity (``root_order="eccentricity"``), whose
    per-round depths seed the replica deal.  ``autotune_cache`` is the
    persistent cache: a path, a :class:`~repro_torch.autotune.CostCache`
    or None (in memory).  Rank 0 alone reads and writes it; the other
    ranks plan on its entries, and every measured wall is the max over
    the ranks, so every rank makes the same plan.  The plan's report is
    logged (``autotune[<mode>]: ...``) and kept in
    ``BCResult.layout_stats["autotune"]`` (its wall in
    ``"autotune_s"``).  Weighted runs refuse it (``ValueError``: it times
    the level-synchronous kernels).

    ``chaos`` (a ``--chaos`` spec or a
    :class:`~repro_torch.distributed.chaos.FaultPlan`) wraps the block
    function in :class:`~repro_torch.distributed.chaos.ChaosRoundFn` and,
    on rank 0, which writes the files, the checkpoint and a cache path in
    their file-seam wrappers; the unwrapped block function is the
    driver's ``fallback_round_fn``.  The injection counters (rank 0's)
    land in ``recovery_stats["chaos"]`` on every rank.

    Returns ``(bc f64 [n], schedule)``, or the
    :class:`~repro_torch.core.driver.BCResult` with ``full_result``.
    """
    autotune = normalize_autotune(autotune)
    if weighted and autotune != "off":
        raise ValueError("autotune measures the level-synchronous kernels; run weighted with "
                         "autotune='off'")
    chaos_plan = FaultPlan.parse(chaos)
    _check_engine(engine_kind)
    if overlap != "auto":
        overlap = normalize_overlap(overlap)
    integrity = normalize_integrity(integrity)
    straggler = normalize_straggler(straggler)
    if straggler != "none" and groups.fr == 1:
        raise ValueError(
            "straggler scheduling re-deals rounds between sub-cluster replicas; "
            "run a grid with fr > 1 replicas (--mesh FRxRxC)"
        )
    dev = device_for_rank(device)
    backend = dist.get_backend()
    want = "gloo" if dev.type == "cpu" else "nccl"
    if want not in backend:
        raise ValueError(f"a {dev.type} run needs a {want} process group, got {backend!r}")
    plan = plan_sampling(eligible_roots(graph), sampling, sample_frac, sample_k, sample_seed)
    if plan.mode != "off" and heuristics != "h0":
        raise ValueError(
            "sampling requires heuristics='h0': the 1-/2-degree analytic "
            "corrections are not per-root additive, so a sampled run "
            "could not be rescaled into an unbiased estimator"
        )
    if stop_rule is not None and plan.mode == "off":
        raise ValueError(
            "a stop_rule truncates the schedule, which is only meaningful "
            "as a rescaled estimate; pass sampling='fixed' or 'adaptive'"
        )
    if plan.mode == "adaptive" and stop_rule is None:
        stop_rule = AdaptiveStopRule()
    delta = check_weighted(graph, weighted, delta, heuristics, num_levels)
    chaos_fs = ChaosFS(chaos_plan) if chaos_plan else None
    if chaos_fs is not None and checkpoint is not None and dist.get_rank() == 0:
        checkpoint = ChaosCheckpoint(checkpoint, chaos_fs)  # the file's writer
    schedule, prep, residual, omega_np = build_schedule(
        graph, batch_size=batch_size, heuristics=heuristics, roots=plan.roots,
        root_order="eccentricity" if autotune != "off" else "id",
    )
    part = partition_2d(residual, groups.R, groups.C)
    agree = _max_over_ranks(dev)
    tune, tune_s = None, None
    if autotune != "off" and schedule.rounds:
        t0 = time.perf_counter()
        sources0, derived0 = sample_batch(schedule, groups.fr)
        tune = plan_autotune(
            part, groups, engine_kind=engine_kind, overlap=overlap, batch_size=batch_size,
            tile=tile, mode=autotune, cache=_grid_cost_cache(autotune_cache, chaos_fs),
            graph=residual, fr=groups.fr, device=dev, sources=sources0, derived=derived0,
            hybrid_threshold=hybrid_threshold, agree_seconds=agree,
        )
        tune_s = time.perf_counter() - t0
        if tile is None and tune.tile is not None:
            tile = tune.tile
        logger.info("autotune[%s]: %s", autotune, tune.report())
    bm, bk = tile if tile is not None else (None, None)
    # one host arc→tile counting pass (cached on the partition) serves the
    # hybrid choice, the memory guard and the layout build, in that order
    tile_counts = part.blocked_sparse_counts(bm, bk) if engine_kind in _TILED else None
    dense_cells = None
    if engine_kind == "fused_hybrid":
        dense_cells, _ = hybrid_cell_choice(
            part, threshold=hybrid_threshold, tile_counts=tile_counts,
            measured=None if tune is None else tune.cell_costs,
        )
    if delta is not None:
        # weighted collectives run the barrier schedule; a ring policy only
        # puts the replicas in lockstep, so "auto" has nothing to price
        if overlap == "auto":
            logger.info("overlap='auto' -> 'none' (weighted rounds are barrier-schedule)")
            overlap = "none"
    else:
        overlap = resolve_overlap(overlap, part, engine_kind, batch_size, bm=bm, bk=bk,
                                  tile_counts=tile_counts, dense_cells=dense_cells,
                                  measured=None if tune is None else tune.overlap_level_s)
    layout_overlap = "none" if delta is not None else overlap
    foot = check_device_memory(
        part, engine_kind, batch_size, hbm_limit_bytes, bm=bm, bk=bk, overlap=layout_overlap,
        tile_counts=tile_counts, dense_cells=dense_cells,
    )
    round_fn = make_distributed_round_fn(
        part, groups, num_levels=num_levels, engine_kind=engine_kind, dense_cells=dense_cells,
        delta=delta, overlap=overlap, integrity=integrity,
    )
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = omega_np
    omega = torch.from_numpy(omega_pad).to(dev)
    graph_args = distributed_graph_arrays(
        part, engine_kind, groups.i, groups.j, dev, overlap=layout_overlap, tile=tile,
        dense_cells=dense_cells, weights=None if delta is None else residual.w,
    )
    index = graph_args[3] if len(graph_args) == 4 else None  # a tiled cell's: one, or one a slot
    indexes = (index,) if isinstance(index, NonzeroIndex) else tuple(index or ())
    index_stats = None
    if indexes and all(ix is not None for ix in indexes):  # built on the card
        index_stats = {"nnz": sum(ix.col.numel() for ix in indexes),
                       "bytes": sum(ix.nbytes() for ix in indexes),
                       "build_s": sum(ix.build_s for ix in indexes)}
    level_bound = None
    if delta is not None:
        # the audit's "levels" are bucket indices: at most ⌈(n-1)·w_max/Δ⌉
        w_max = float(residual.w.max()) if residual.w.size else 1.0
        level_bound = int(np.ceil(graph.n * w_max / delta)) + 2
    prior_round_s = None
    if straggler != "none" or dispatch_deadline_s == "auto" or plan.mode != "off":
        prior_round_s = prior_round_seconds(
            part, engine_kind, batch_size, layout_overlap, bm=bm, bk=bk,
            tile_counts=tile_counts, dense_cells=dense_cells,
            measured_level_s=None if tune is None else tune.level_s_for(layout_overlap),
            prior_levels=None if delta is None else weighted_prior_levels(residual.w, delta),
        )
    if plan.mode != "off":
        logger.info(
            "sampling[%s]: %d of %d eligible roots in %d rounds (seed %d); expected wall "
            "≈ %.3gs at the %.3gs/round prior", plan.mode, plan.k, plan.num_eligible,
            len(schedule.rounds), plan.seed,
            sampled_run_seconds(len(schedule.rounds), groups.fr, prior_round_s), prior_round_s,
        )
    if dispatch_deadline_s == "auto":
        dispatch_deadline_s = max(WATCHDOG_MIN_DEADLINE_S, WATCHDOG_SAFETY * prior_round_s)
        logger.info("dispatch watchdog: auto deadline %.1fs", dispatch_deadline_s)

    def block_fn(sources, derived):
        return round_fn(graph_args, omega, sources, derived)

    dispatch_fn, fallback_fn = block_fn, None
    if chaos_plan:
        dispatch_fn = ChaosRoundFn(block_fn, chaos_plan, sleeper=sleeper)
        fallback_fn = block_fn  # the unwrapped, known-good path
    driver = BCDriver(
        dispatch_fn,
        schedule,
        n=graph.n,
        device=dev,
        prep=prep,
        ledger=ledger,
        checkpoint=None if checkpoint is None else _GridCheckpoint(checkpoint, dev),
        stop_rule=None if stop_rule is None else _GridStopRule(stop_rule, dev),
        rounds_per_dispatch=groups.fr,
        straggler=straggler,
        straggler_factor=straggler_factor,
        prior_round_s=prior_round_s,
        round_costs=schedule.round_depths,
        max_retries=max_retries,
        retry_backoff_s=retry_backoff_s,
        numeric_guard=numeric_guard,
        fallback_round_fn=fallback_fn,
        integrity=integrity,
        dispatch_deadline_s=dispatch_deadline_s,
        clock=clock,
        sleeper=sleeper,
        agree_seconds=agree,
        level_bound=level_bound,
        # the elasticity planner's taxonomy: replicas are 'pod' groups,
        # the grid is data × model
        mesh_shape=(groups.fr, groups.R, groups.C),
        mesh_axes=("pod", "data", "model"),
    )
    result = apply_sampling_rescale(driver.run(), plan)
    result.layout_stats = _layout_stats(foot, tile_counts, dense_cells, index_stats)
    result.layout_stats["overlap"] = overlap
    if tune is not None:
        result.layout_stats.update(autotune=tune.report(), autotune_s=tune_s)
    if chaos_plan:
        # rank 0 wrote (and corrupted) the files; the dispatch counts agree
        result.recovery_stats["chaos"] = _from_rank0({
            "plan": repr(chaos_plan),
            "dispatch_calls": dispatch_fn.calls,
            "checkpoint_saves": chaos_fs.checkpoint_saves,
            "cache_puts": chaos_fs.cache_puts,
            "files_corrupted": list(chaos_fs.files_corrupted),
        })
    return result if full_result else (result.bc, schedule)


def _layout_stats(foot: dict, tile_counts: dict | None, dense_cells: np.ndarray | None,
                  index_stats: dict | None) -> dict:
    """The run's footprint record and, for the tiled engines, the tile
    shape and the stored-tile counts of the ranks that hold tiles, and
    this rank's nonzero index (entries, bytes, build seconds; summed over
    the slots under a ring) if it holds tiles."""
    stats = {"footprint": foot}
    if index_stats is not None:
        stats["index"] = index_stats
    if tile_counts is not None:
        stored = tile_counts["stored_full_cell"]
        if dense_cells is not None:
            stored = np.where(dense_cells, 0, stored)
            stats["dense_cells"] = dense_cells.astype(int).tolist()
        stats.update(tile=(tile_counts["bm"], tile_counts["bk"]),
                     stored_tiles_max=int(stored.max()), stored_tiles_total=int(stored.sum()),
                     nnz_tiles_total=tile_counts["nnz_total"])
    return stats
