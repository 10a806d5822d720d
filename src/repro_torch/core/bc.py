"""Single-device betweenness centrality entry point.

Composes the round scheduler, the operator layer and the driver into the
full exact (or source-sampled) BC computation on one device.  The engine
names differ from the JAX package's where the thing differs:
``"fused"``/``"fused_bf16"`` run the hand-written CUDA level kernels
where the JAX package ran its Pallas kernels; :data:`REFERENCE_ENGINE`
maps each port engine to its JAX counterpart for the parity tests.
``weighted=True`` runs the bucketed (delta-stepping) traversal instead:
``sparse`` on the arc list, every other engine on the dense f32 weight
matrix (as the JAX package's ``pallas`` engines do: the weighted path
has no kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.graph import Graph
from ..serving.sampling import AdaptiveStopRule, SamplePlan, eligible_roots, plan_sampling
from .driver import BCDriver, BCResult, traversal_round
from .operators import (
    DenseOperator,
    FusedDenseOperator,
    SparseOperator,
    TraversalOperator,
    WeightedDenseOperator,
    WeightedSparseOperator,
    _check_delta,
    auto_delta,
)
from .scheduler import build_schedule

__all__ = [
    "BCResult",
    "betweenness_centrality",
    "make_round_fn",
    "make_operator",
    "device_adjacency",
    "apply_sampling_rescale",
    "ENGINE_KINDS",
    "REFERENCE_ENGINE",
    "WEIGHTED_HEURISTICS",
    "check_weighted",
]

#: heuristics usable under weighted traversal: the 1-degree reduction and
#: its tree variant are combinatorial (every path into a pendant subtree
#: crosses its anchor, whatever the weights); the 2-degree derivation
#: (h2/h3/h3t) rewrites levels, which assumes unit edge lengths
WEIGHTED_HEURISTICS = ("h0", "h1", "h1t")

#: the single source of truth for the port's ``--engine`` choices:
#: "dense" (torch.matmul), "sparse" (index_select + sorted row sums), "fused"
#: (CUDA level kernels, f32 adjacency), "fused_bf16" (same, bf16 adjacency)
ENGINE_KINDS = ("dense", "sparse", "fused", "fused_bf16")

#: port engine -> the JAX package's engine computing the same thing
REFERENCE_ENGINE = {
    "dense": "dense",
    "sparse": "sparse",
    "fused": "pallas",
    "fused_bf16": "pallas_bf16",
}


def device_adjacency(graph: Graph, dtype: torch.dtype, device: torch.device,
                     weighted: bool = False) -> torch.Tensor:
    """[n, n] 0/1 adjacency built on the device from the arc list (the
    host never holds the n² matrix); ``weighted`` puts the arc weights in
    place of the ones (0 = no edge)."""
    a = torch.zeros((graph.n, graph.n), dtype=dtype, device=device)
    src = torch.from_numpy(graph.src).to(device=device, dtype=torch.int64)
    dst = torch.from_numpy(graph.dst).to(device=device, dtype=torch.int64)
    a[src, dst] = torch.from_numpy(graph.w).to(device, dtype) if weighted else 1
    return a


def make_operator(residual: Graph, engine_kind: str, device: torch.device) -> TraversalOperator:
    """The level operator of an engine kind over the residual graph; the
    graph-constant operands are built once per call, on ``device``."""
    if engine_kind == "dense":
        return DenseOperator(device_adjacency(residual, torch.float32, device))
    if engine_kind == "sparse":
        src_p, dst_p, _ = residual.padded_arcs(multiple=8)
        return SparseOperator(
            torch.from_numpy(src_p).to(device=device, dtype=torch.int64),
            torch.from_numpy(dst_p).to(device=device, dtype=torch.int64),
            residual.n,
        )
    if engine_kind in ("fused", "fused_bf16"):
        dtype = torch.float32 if engine_kind == "fused" else torch.bfloat16
        return FusedDenseOperator(device_adjacency(residual, dtype, device))
    raise ValueError(f"unknown engine {engine_kind!r}; expected one of {ENGINE_KINDS}")


def make_weighted_operator(residual: Graph, engine_kind: str, delta: float,
                           device: torch.device) -> TraversalOperator:
    """The bucket operator of an engine kind over the (weighted) residual
    graph: the arc list for ``sparse``, the dense f32 weight matrix for
    ``dense``, ``fused`` and ``fused_bf16`` (weights never downcast: the
    distances feed exact equality masks)."""
    if engine_kind == "sparse":
        src_p, dst_p, _ = residual.padded_arcs(multiple=8)
        return WeightedSparseOperator(
            torch.from_numpy(src_p).to(device=device, dtype=torch.int64),
            torch.from_numpy(dst_p).to(device=device, dtype=torch.int64),
            torch.from_numpy(residual.padded_arc_weights(multiple=8)).to(device),
            residual.n, delta,
        )
    if engine_kind in ("dense", "fused", "fused_bf16"):
        return WeightedDenseOperator(
            device_adjacency(residual, torch.float32, device, weighted=True), delta)
    raise ValueError(f"unknown engine {engine_kind!r}; expected one of {ENGINE_KINDS}")


def check_weighted(graph: Graph, weighted: bool, delta: float | None, heuristics: str,
                   num_levels: int | None) -> float | None:
    """Validate the weighted knobs of an entry point; returns the bucket
    width (``auto_delta`` of the graph when ``delta`` is None), or None for
    an unweighted run (which ignores any weights the graph carries)."""
    if not weighted:
        if delta is not None:
            raise ValueError("delta is only meaningful with weighted=True")
        return None
    if graph.w is None:
        raise ValueError(
            "weighted=True needs edge weights: build the graph with "
            "Graph.from_edges(..., weights=) or a weighted generator "
            "(graphs.generators WEIGHT_MODES)"
        )
    if heuristics not in WEIGHTED_HEURISTICS:
        raise ValueError(
            f"heuristics={heuristics!r} is level-based (2-degree "
            f"derivation assumes unit edge lengths); weighted runs "
            f"accept {WEIGHTED_HEURISTICS}"
        )
    if num_levels is not None:
        raise ValueError(
            "num_levels is a static level bound for the level-"
            "synchronous engine; the weighted bucket loop's trip "
            "count is data-dependent"
        )
    return _check_delta(auto_delta(graph) if delta is None else delta)


def make_round_fn(op: TraversalOperator, omega: torch.Tensor, num_levels: int | None = None,
                  integrity: str = "off"):
    """The driver's round function on one device: ``(sources [fr, s],
    derived [fr, k, 3]) -> traversal_round(op, ...)`` of every lane, one
    lane after another, stacked along a leading lane dim (and the
    integrity record ``[fr, 2]`` when ``integrity != "off"``; under
    "checksum" every level runs the operator's checked step).  The
    single-device entry point deals one lane a block; a multi-lane block
    is how the multi-ledger straggler loop runs on one card."""

    def round_fn(sources, derived):
        lanes = [traversal_round(op, sources[r], derived[r], omega, num_levels=num_levels,
                                 integrity=integrity) for r in range(sources.shape[0])]
        bc, ns, roots, levels, *integ = zip(*lanes)
        return (torch.stack(bc), torch.stack(ns), torch.stack(roots), list(levels)) + tuple(
            torch.stack(x) for x in integ)

    return round_fn


def betweenness_centrality(
    graph: Graph,
    batch_size: int = 32,
    heuristics: str = "h0",
    engine_kind: str = "dense",
    num_levels: int | None = None,
    ledger=None,
    checkpoint=None,
    checkpoint_every: int = 8,
    overlap: str = "none",
    straggler: str = "none",
    sampling: str = "off",
    sample_frac: float | None = None,
    sample_k: int | None = None,
    sample_seed: int = 0,
    stop_rule=None,
    weighted: bool = False,
    delta: float | None = None,
    device: str | torch.device | None = None,
) -> BCResult:
    """Exact or source-sampled BC of an undirected graph (paper
    conventions: unnormalized, both traversal directions counted).

    Args:
      graph:       input graph.
      batch_size:  concurrent sources per round (multi-source width).
      heuristics:  one of ``HEURISTICS_MODES`` ("h0" … "h3t").
      engine_kind: one of :data:`ENGINE_KINDS`.
      num_levels:  optional static level bound (≥ graph diameter + 1).
      ledger:      optional RoundLedger — committed rounds are skipped.
      checkpoint:  optional :class:`~repro_torch.distributed.fault_tolerance.BCCheckpoint`
                   — durable kill-and-resume: the run resumes from its
                   newest intact snapshot and saves one after every
                   ``checkpoint_every`` blocks and at the end (the JAX
                   package's file format).
      sampling:    "off" (exact), "fixed" (seeded k-root subset, rescaled
                   by N/k) or "adaptive" (also stops once the top-k ranks
                   stabilise, :class:`~repro_torch.serving.AdaptiveStopRule`);
                   sampling requires ``heuristics="h0"``.
      sample_frac / sample_k / sample_seed: the sample size and its seed.
      stop_rule:   ``(bc_running, blocks_done) -> bool`` early stop
                   (requires ``sampling != "off"``; default under
                   "adaptive": ``AdaptiveStopRule()``).
      weighted:    run the bucketed (delta-stepping) weighted traversal;
                   needs ``graph.w`` and one of :data:`WEIGHTED_HEURISTICS`.
                   False on a weighted graph ignores the weights.
      delta:       the bucket width Δ of a weighted run; None derives it
                   from the weights (:func:`~repro_torch.core.operators.auto_delta`).
      device:      None → the CUDA card (raises without one); "cpu" runs
                   the plain PyTorch versions of every kernel.
      overlap, straggler: accepted for signature parity with the JAX
                   package; neither has a single-device meaning.
    """
    if overlap != "none":
        raise ValueError(
            "overlap schedules are a distributed-engine feature; "
            "single-device engines have no collectives to pipeline"
        )
    if straggler != "none":
        raise ValueError(
            "straggler scheduling is a sub-cluster feature; a single "
            "device has no replicas to steal rounds from or re-deal to"
        )
    if engine_kind not in ENGINE_KINDS:
        raise ValueError(f"unknown engine {engine_kind!r}; expected one of {ENGINE_KINDS}")
    dev = resolve_device(device)
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
    schedule, prep, residual, omega_np = build_schedule(
        graph, batch_size=batch_size, heuristics=heuristics, roots=plan.roots
    )
    omega = torch.from_numpy(omega_np).to(device=dev, dtype=torch.float32)
    if delta is None:
        op = make_operator(residual, engine_kind, dev)
    else:
        op = make_weighted_operator(residual, engine_kind, delta, dev)
    driver = BCDriver(
        make_round_fn(op, omega, num_levels),
        schedule,
        n=graph.n,
        device=dev,
        prep=prep,
        ledger=ledger,
        checkpoint=checkpoint,
        checkpoint_every=checkpoint_every,
        stop_rule=stop_rule,
    )
    return apply_sampling_rescale(driver.run(), plan)


def apply_sampling_rescale(result: BCResult, plan: SamplePlan) -> BCResult:
    """Rescale a sampled run's BC by N / roots_accumulated (in place).

    The denominator is what the driver committed, resumed rounds
    included, so fixed and adaptive share one calibration; checkpoints
    hold the raw accumulator (the driver saves before this runs), so a
    resumed run re-applies the then-current scale — rescale and resume
    commute."""
    if plan.mode == "off":
        return result
    denom = result.roots_accumulated
    scale = plan.num_eligible / denom if denom else 1.0
    if scale != 1.0:
        result.bc = result.bc * scale
    result.sampling_stats = {
        "mode": plan.mode,
        "seed": plan.seed,
        "num_eligible": plan.num_eligible,
        "k_planned": plan.k,
        "roots_accumulated": denom,
        "scale": scale,
    }
    return result
