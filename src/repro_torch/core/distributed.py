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
        (kernels/csrc/partial_spmm.cu), f32 or bf16 block.
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

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.groups import GridGroups, all_gather, device_for_rank
from ..graphs.graph import Graph
from ..graphs.partition import TwoDPartition, partition_2d
from ..serving.sampling import eligible_roots, plan_sampling
from .bc import apply_sampling_rescale
from .driver import BCDriver, traversal_round
from .operators import DistributedFusedOperator, DistributedOperator
from .scheduler import build_schedule

__all__ = [
    "DIST_ENGINE_KINDS",
    "REFERENCE_DIST_ENGINE",
    "distributed_graph_arrays",
    "make_distributed_round_fn",
    "distributed_betweenness_centrality",
    "one_degree_reduce_distributed",
]

#: block-local compute engines of the distributed path: arc-list
#: gather/scatter-add, or the partial kernels K3/K4 on a dense f32 / bf16
#: block.  The BCSR and hybrid engines are ROADMAP Queue 1 item 6.
DIST_ENGINE_KINDS = ("sparse", "fused", "fused_bf16")

#: port engine -> the JAX package's distributed engine computing the same thing
REFERENCE_DIST_ENGINE = {"sparse": "sparse", "fused": "pallas", "fused_bf16": "pallas_bf16"}


def _check_engine(engine_kind: str) -> None:
    if engine_kind not in DIST_ENGINE_KINDS:
        raise ValueError(
            f"unknown distributed engine {engine_kind!r}; expected one of {DIST_ENGINE_KINDS}"
        )


def distributed_graph_arrays(
    partition: TwoDPartition, engine_kind: str, i: int, j: int, device
) -> tuple[torch.Tensor, ...]:
    """Grid cell (i, j)'s graph operands on ``device``: the flat arc arrays
    ``(src_local, dst_local)`` (int64 [max_arcs]) for ``"sparse"``; the
    dense block ``(A[rows_i, cols_j],)`` ([C·chunk, R·chunk], bf16 for
    ``"fused_bf16"``, built on the device) for the fused engines."""
    _check_engine(engine_kind)
    if engine_kind == "sparse":
        return tuple(
            torch.from_numpy(a[i, j]).to(device=device, dtype=torch.int64)
            for a in (partition.src_local, partition.dst_local)
        )
    dtype = torch.bfloat16 if engine_kind == "fused_bf16" else torch.float32
    return (partition.cell_dense_block(i, j, dtype, device),)


def make_distributed_round_fn(
    partition: TwoDPartition,
    groups: GridGroups,
    *,
    num_levels: int | None = None,
    fuse_backward_payload: bool = True,
    engine_kind: str = "sparse",
):
    """Build this rank's sub-cluster-parallel, 2-D-distributed round function

        round_fn(graph_args, omega f32 [n_pad], sources i32 [fr, s],
                 derived i32 [fr, k, 3])
          -> (bc f32 [fr, n_pad], ns f32 [fr, s+k], roots i32 [fr, s+k],
              levels i32 [fr])

    ``graph_args`` is :func:`distributed_graph_arrays` of the rank's cell;
    ``omega`` the 1-degree weights in vertex order (the rank reads its
    owned chunk).  Replica f runs round f of the block; every output is
    gathered to every rank (the BC in vertex order, the rest across the
    replica group), and ``levels`` are each replica's own traversal depth.

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
    chunk = partition.chunk
    base = partition.owned_vertex_base(groups.i, groups.j)

    def round_fn(graph_args, omega, sources, derived):
        if engine_kind == "sparse":
            op = DistributedOperator(
                *graph_args, chunk=chunk, groups=groups,
                split_backward=not fuse_backward_payload,
            )
        else:
            op = DistributedFusedOperator(*graph_args, chunk=chunk, groups=groups)
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
    (:data:`DIST_ENGINE_KINDS`).  ``heuristics``, ``num_levels``,
    ``ledger`` and fixed-k ``sampling`` (``sample_frac`` / ``sample_k`` /
    ``sample_seed``, rescaled by N/k; ``stop_rule`` may end it early)
    behave as in the single-device entry point.  ``device=None`` runs on
    the card ``cuda:LOCAL_RANK`` under NCCL; ``device="cpu"`` on the host
    under gloo.

    The remaining knobs keep the JAX signature and raise
    ``NotImplementedError`` until their ROADMAP item ports them:
    ``overlap`` (item 7), ``tile`` and ``hbm_limit_bytes`` (item 6),
    ``straggler``, ``chaos`` and ``integrity`` (item 8), ``autotune``
    (item 9), ``checkpoint`` (item 4a), ``weighted`` / ``delta`` (item 11),
    adaptive sampling (item 10).

    Returns ``(bc f64 [n], schedule)``, or the
    :class:`~repro_torch.core.driver.BCResult` with ``full_result``.
    """
    for name, value, default, item in (
        ("overlap", overlap, "none", "7"),
        ("tile", tile, None, "6"),
        ("hbm_limit_bytes", hbm_limit_bytes, None, "6"),
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
    round_fn = make_distributed_round_fn(
        part, groups, num_levels=num_levels, engine_kind=engine_kind
    )
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = omega_np
    omega = torch.from_numpy(omega_pad).to(dev)
    graph_args = distributed_graph_arrays(part, engine_kind, groups.i, groups.j, dev)
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
    return result if full_result else (result.bc, schedule)
