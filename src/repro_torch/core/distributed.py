"""Distributed MGBC: 2-D decomposition + sub-clustering (paper §3.2-3.3).

Communication structure per traversal level, per sub-cluster (an R×C
grid of ranks; see graphs/partition.py for the chunk layout and
distributed/groups.py for the process groups):

  expand (paper Alg. 2 line 15):
      ``all_gather`` of the owned frontier chunks over the rank's column
      group  →  F[cols_j] on every rank of grid column j.
  local compute:
      * ``engine_kind="sparse"`` — gather F[src_local] + ``index_add_``
        into dst_local;
      * ``engine_kind="fused"`` / ``"fused_bf16"`` — the rank's dense
        adjacency block through the partial kernels K3/K4
        (kernels/csrc/partial_spmm.cu), f32 or bf16 block;
      * ``engine_kind="fused_sparse"`` — the block's stored (bm × bk)
        BCSR tiles through K5/K6 (kernels/csrc/sparse_spmm.cu), for
        graphs whose dense blocks do not fit;
      * ``engine_kind="fused_hybrid"`` — per cell, whichever of the two
        the bytes model (:func:`hybrid_cell_choice`) picks.
  fold (Alg. 2 line 19):
      ``reduce_scatter`` of the partials over the rank's row group — sums
      the C contributions and delivers each rank exactly its owned chunk.

This is the barrier schedule (``overlap="none"``); the ring schedules
are ROADMAP Queue 1 item 7.  The traversal itself — level loops, round
algebra, host loop — is not implemented here: the round function builds
a :class:`~repro_torch.core.operators.DistributedOperator` (or its fused
subclass) and runs the same
:func:`~repro_torch.core.driver.traversal_round` /
:class:`~repro_torch.core.driver.BCDriver` as the single-device path.
Every rank runs the same deterministic host schedule and the same driver
loop; each block's results come back to every rank, so the driver's host
state (ledger, n_s, stop rule) is identical everywhere.

Sub-clustering (paper §3.3): ``fr`` replicas of the R×C grid each take
one round of every dispatch block; BC is additive, so the driver sums the
replica lanes.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.groups import GridGroups, all_gather, device_for_rank
from ..graphs.graph import Graph
from ..graphs.partition import TwoDPartition, partition_2d
from ..roofline.model import cell_kernel_choice, device_hbm_footprint
from ..serving.sampling import eligible_roots, plan_sampling
from .bc import apply_sampling_rescale
from .driver import BCDriver, traversal_round
from .operators import (
    DistributedFusedHybridOperator,
    DistributedFusedOperator,
    DistributedFusedSparseOperator,
    DistributedOperator,
)
from .scheduler import build_schedule

__all__ = [
    "DIST_ENGINE_KINDS",
    "REFERENCE_DIST_ENGINE",
    "hybrid_cell_choice",
    "estimate_device_footprint",
    "check_device_memory",
    "distributed_graph_arrays",
    "make_distributed_operator",
    "make_distributed_round_fn",
    "distributed_betweenness_centrality",
    "one_degree_reduce_distributed",
]

logger = logging.getLogger(__name__)

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
) -> tuple[np.ndarray, dict]:
    """The ``fused_hybrid`` engine's per-cell dense-vs-BCSR choice:
    :func:`repro_torch.roofline.model.cell_kernel_choice` over the per-cell
    stored-tile counts of the partition's cached counting pass (pass
    ``tile_counts`` to reuse one dict).  The choice is logged, so runs are
    auditable, and ``threshold`` (``--hybrid-threshold``) overrides the
    break-even.  (The JAX package's ``measured=`` calibration waits for
    the autotuner, ROADMAP item 9.)  Returns ``(dense_cells bool [R, C],
    tile_counts)``."""
    counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
    dense_cells = cell_kernel_choice(
        counts["stored_full_cell"], R=partition.R, C=partition.C, chunk=partition.chunk,
        bm=counts["bm"], bk=counts["bk"], threshold=threshold,
    )
    logger.info(
        "hybrid cell choice (threshold %.3g, tile %dx%d, roofline bytes): %d dense / "
        "%d sparse cells %s",
        threshold, counts["bm"], counts["bk"], int(dense_cells.sum()),
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
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
) -> dict:
    """Per-device adjacency + state bytes of one engine, before anything is
    allocated: :func:`repro_torch.roofline.model.device_hbm_footprint` with
    the partition's quantities, for the largest rank.

    ``fused_sparse`` prices the stored tiles of the fullest cell (nonzero
    tiles + row fillers, from the counting pass; no tile data is built).
    ``fused_hybrid`` prices what the port allocates: each rank's chosen
    representation only — the dense block of a dense-chosen cell, the
    tiles of a sparse-chosen one (``dense_cells``, default: the
    break-even choice of :func:`hybrid_cell_choice`) — and the largest
    rank decides.  This is less
    than the JAX package's hybrid footprint, which prices the union of
    both operand sets that ``shard_map`` ships to every device.
    ``bm``/``bk`` are the tile the engine will be built with.
    """
    R, C, chunk = partition.R, partition.C, partition.chunk
    grid = dict(R=R, C=C, chunk=chunk, batch_size=batch_size)
    if engine_kind == "sparse":
        return device_hbm_footprint(
            engine_kind, max_arcs=int(partition.src_local.shape[-1]), **grid
        )
    if engine_kind not in _TILED:
        return device_hbm_footprint(engine_kind, **grid)
    counts = tile_counts or partition.blocked_sparse_counts(bm, bk)
    tile = dict(bm=counts["bm"], bk=counts["bk"])
    if engine_kind == "fused_sparse":
        return device_hbm_footprint(
            engine_kind, nnz_tiles=counts["stored_tiles_full"], **tile, **grid
        )
    if dense_cells is None:
        dense_cells, _ = hybrid_cell_choice(partition, tile_counts=counts)
    feet = [
        device_hbm_footprint(
            engine_kind, nnz_tiles=int(counts["stored_full_cell"][i, j]),
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
    tile_counts: dict | None = None,
    dense_cells: np.ndarray | None = None,
) -> dict:
    """Fail-fast memory guard: raise ``MemoryError`` before anything is
    allocated when the footprint (:func:`estimate_device_footprint`)
    exceeds ``hbm_limit_bytes`` — the card's capacity, an input here —
    with a suggestion (``fused_sparse`` where it fits, a larger grid).
    Returns the footprint record, which is always computed and logged."""
    foot = estimate_device_footprint(
        partition, engine_kind, batch_size, bm=bm, bk=bk, tile_counts=tile_counts,
        dense_cells=dense_cells,
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
                partition, "fused_sparse", batch_size, bm=bm, bk=bk, tile_counts=tile_counts
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


def distributed_graph_arrays(
    partition: TwoDPartition,
    engine_kind: str,
    i: int,
    j: int,
    device,
    *,
    tile: tuple[int, int] | None = None,
    dense_cells: np.ndarray | None = None,
) -> tuple[torch.Tensor, ...]:
    """Grid cell (i, j)'s graph operands on ``device``: the flat arc arrays
    ``(src_local, dst_local)`` (int64 [max_arcs]) for ``"sparse"``; the
    dense block ``(A[rows_i, cols_j],)`` ([C·chunk, R·chunk], bf16 for
    ``"fused_bf16"``, built on the device) for the dense fused engines;
    the cell's BCSR list ``(tiles, tile_rows, tile_cols, row_ptr)``
    (:meth:`TwoDPartition.cell_blocked_sparse` at ``tile``, default the
    largest divisor of chunk ≤ 128, multiples of 8 preferred) for
    ``"fused_sparse"``; for ``"fused_hybrid"`` whichever of the last two
    ``dense_cells[i, j]`` (the :func:`hybrid_cell_choice`) picks — a rank
    never holds both."""
    _check_engine(engine_kind)
    if engine_kind == "sparse":
        return tuple(
            torch.from_numpy(a[i, j]).to(device=device, dtype=torch.int64)
            for a in (partition.src_local, partition.dst_local)
        )
    if engine_kind == "fused_hybrid":
        if dense_cells is None:
            raise ValueError("fused_hybrid needs dense_cells (hybrid_cell_choice)")
        engine_kind = "fused" if dense_cells[i, j] else "fused_sparse"
    if engine_kind == "fused_sparse":
        return partition.cell_blocked_sparse(i, j, *(tile or (None, None)), device=device)
    dtype = torch.bfloat16 if engine_kind == "fused_bf16" else torch.float32
    return (partition.cell_dense_block(i, j, dtype, device),)


def make_distributed_operator(
    engine_kind: str,
    graph_args: tuple[torch.Tensor, ...],
    *,
    chunk: int,
    groups: GridGroups,
    dense_cell: bool = False,
    split_backward: bool = False,
) -> DistributedOperator:
    """The rank's 2-D operator of an engine over its
    :func:`distributed_graph_arrays`; ``dense_cell`` is the rank's
    ``fused_hybrid`` choice."""
    kw = dict(chunk=chunk, groups=groups)
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
    sparse engine only).  Barrier schedule, unweighted rounds.
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
    chunk = partition.chunk
    base = partition.owned_vertex_base(groups.i, groups.j)
    dense_cell = engine_kind == "fused_hybrid" and bool(dense_cells[groups.i, groups.j])

    def round_fn(graph_args, omega, sources, derived):
        op = make_distributed_operator(
            engine_kind, graph_args, chunk=chunk, groups=groups, dense_cell=dense_cell,
            split_backward=not fuse_backward_payload,
        )
        bc, ns, roots, levels = traversal_round(
            op, sources[groups.f], derived[groups.f], omega[base : base + chunk],
            num_levels=num_levels,
        )
        level_t = torch.tensor([levels], dtype=torch.int32, device=bc.device)
        return (
            groups.gather_vertices(bc),
            groups.gather_replicas(ns),
            groups.gather_replicas(roots),
            groups.gather_replicas(level_t)[:, 0],
        )

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
    autotune: str = "off",
    chaos=None,
    integrity: str = "off",
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
    ``ledger`` and fixed-k ``sampling`` (``sample_frac`` / ``sample_k`` /
    ``sample_seed``, rescaled by N/k; ``stop_rule`` may end it early)
    behave as in the single-device entry point.  ``device=None`` runs on
    the card ``cuda:LOCAL_RANK`` under NCCL; ``device="cpu"`` on the host
    under gloo.

    The remaining knobs keep the JAX signature and raise
    ``NotImplementedError`` until their ROADMAP item ports them:
    ``overlap`` (item 7), ``straggler``, ``chaos`` and ``integrity``
    (item 8), ``autotune`` (item 9), ``checkpoint`` (item 4a),
    ``weighted`` / ``delta`` (item 11), adaptive sampling (item 10).

    Returns ``(bc f64 [n], schedule)``, or the
    :class:`~repro_torch.core.driver.BCResult` with ``full_result``.
    """
    for name, value, default, item in (
        ("overlap", overlap, "none", "7"),
        ("straggler", straggler, "none", "8"),
        ("chaos", chaos, None, "8"),
        ("integrity", integrity, "off", "8"),
        ("autotune", autotune, "off", "9"),
        ("checkpoint", checkpoint, None, "4a"),
        ("weighted", weighted, False, "11"),
        ("delta", delta, None, "11"),
    ):
        if value != default:
            raise NotImplementedError(
                f"distributed_betweenness_centrality({name}=...) is not ported yet "
                f"(ROADMAP Queue 1 item {item})"
            )
    _check_engine(engine_kind)
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
            "as a rescaled estimate; pass sampling='fixed'"
        )
    schedule, prep, residual, omega_np = build_schedule(
        graph, batch_size=batch_size, heuristics=heuristics, roots=plan.roots
    )
    part = partition_2d(residual, groups.R, groups.C)
    bm, bk = tile if tile is not None else (None, None)
    # one host arc→tile counting pass (cached on the partition) serves the
    # hybrid choice, the memory guard and the layout build, in that order
    tile_counts = part.blocked_sparse_counts(bm, bk) if engine_kind in _TILED else None
    dense_cells = None
    if engine_kind == "fused_hybrid":
        dense_cells, _ = hybrid_cell_choice(
            part, threshold=hybrid_threshold, tile_counts=tile_counts
        )
    foot = check_device_memory(
        part, engine_kind, batch_size, hbm_limit_bytes, bm=bm, bk=bk,
        tile_counts=tile_counts, dense_cells=dense_cells,
    )
    round_fn = make_distributed_round_fn(
        part, groups, num_levels=num_levels, engine_kind=engine_kind, dense_cells=dense_cells
    )
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = omega_np
    omega = torch.from_numpy(omega_pad).to(dev)
    graph_args = distributed_graph_arrays(
        part, engine_kind, groups.i, groups.j, dev, tile=tile, dense_cells=dense_cells
    )
    driver = BCDriver(
        lambda sources, derived: round_fn(graph_args, omega, sources, derived),
        schedule,
        n=graph.n,
        device=dev,
        prep=prep,
        ledger=ledger,
        stop_rule=stop_rule,
        rounds_per_dispatch=groups.fr,
    )
    result = apply_sampling_rescale(driver.run(), plan)
    result.layout_stats = _layout_stats(foot, tile_counts, dense_cells)
    return result if full_result else (result.bc, schedule)


def _layout_stats(foot: dict, tile_counts: dict | None, dense_cells: np.ndarray | None) -> dict:
    """The run's footprint record and, for the tiled engines, the tile
    shape and the stored-tile counts of the ranks that hold tiles."""
    stats = {"footprint": foot}
    if tile_counts is not None:
        stored = tile_counts["stored_full_cell"]
        if dense_cells is not None:
            stored = np.where(dense_cells, 0, stored)
            stats["dense_cells"] = dense_cells.astype(int).tolist()
        stats.update(tile=(tile_counts["bm"], tile_counts["bk"]),
                     stored_tiles_max=int(stored.max()), stored_tiles_total=int(stored.sum()),
                     nnz_tiles_total=tile_counts["nnz_total"])
    return stats
