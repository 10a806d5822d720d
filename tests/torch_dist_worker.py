"""Rank-side case runner for tests/test_torch_dist.py and
tests/test_torch_dist_weighted.py.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference, so the
children import this module).  It imports only numpy, torch and the port —
never jax or the JAX package — so a rank starts in about a second.  Every
rank runs the same cases in the same order, as the collectives require.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.driver import traversal_round
from repro_torch.core.distributed import (
    distributed_betweenness_centrality,
    distributed_graph_arrays,
    make_distributed_operator,
    make_distributed_round_fn,
    one_degree_reduce_distributed,
)
from repro_torch.core.scheduler import build_schedule
from repro_torch.graphs.partition import partition_2d
from repro_torch.kernels.ops import bucket_index

S = 8  # sources of an operator-state case (tests/test_operators.py)


def _bc(groups, graph, kwargs):
    res = distributed_betweenness_centrality(
        graph, groups, device="cpu", full_result=True, **kwargs
    )
    return {"bc": res.bc, "round_levels": res.round_levels, "rounds_run": res.rounds_run,
            "sampling_stats": res.sampling_stats, "layout": res.layout_stats}


def _state(groups, graph, engine_kind):
    """(σ, d, δ) [n, S] of one forward + backward pass through the rank's
    2-D operator, reassembled in vertex order (tests/test_operators.py's
    ``_distributed_state`` inputs: sources 0..S-1, ω from seed 7)."""
    part = partition_2d(graph, groups.R, groups.C)
    args = distributed_graph_arrays(part, engine_kind, groups.i, groups.j, "cpu")
    op = make_distributed_operator(engine_kind, args, chunk=part.chunk, groups=groups)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = np.random.default_rng(7).integers(0, 3, graph.n)
    base = part.owned_vertex_base(groups.i, groups.j)
    omega = torch.from_numpy(omega_pad[base : base + part.chunk])
    sources = torch.arange(min(S, graph.n), dtype=torch.int32)
    onehot = (op.row_ids()[:, None] == sources[None, :]).to(torch.float32)
    fwd = engine.forward_counting(op, onehot)
    delta = engine.backward_accumulation(op, fwd.sigma, fwd.depth, omega, fwd.max_depth)
    n = graph.n
    return tuple(
        groups.gather_vertices(x)[0, :n].numpy() for x in (fwd.sigma, fwd.depth, delta)
    )


def _first_round(groups, graph, batch_size, fuse):
    """BC of the schedule's first round through ``make_distributed_round_fn``."""
    schedule, _, residual, _ = build_schedule(graph, batch_size=batch_size)
    part = partition_2d(residual, groups.R, groups.C)
    fn = make_distributed_round_fn(part, groups, fuse_backward_payload=fuse)
    args = distributed_graph_arrays(part, "sparse", groups.i, groups.j, "cpu")
    rnd = schedule.rounds[0]
    bc, _, _, _ = fn(
        args, torch.zeros(part.n_pad), torch.from_numpy(rnd.sources[None]),
        torch.from_numpy(rnd.derived[None]),
    )
    return bc[0].numpy()


def _one_degree(groups, graph):
    return one_degree_reduce_distributed(graph, "cpu")


def _weighted_op(groups, graph, engine_kind, delta):
    part = partition_2d(graph, groups.R, groups.C)
    args = distributed_graph_arrays(part, engine_kind, groups.i, groups.j, "cpu",
                                    weights=graph.w)
    op = make_distributed_operator(engine_kind, args, chunk=part.chunk, groups=groups,
                                   delta=delta)
    return part, op


def _weighted_state(groups, graph, engine_kind, delta):
    """(σ, dist, δ) [n, S] of the bucket loops through the rank's weighted
    2-D operator, sources 0..S-1, ω from seed 7, in vertex order."""
    part, op = _weighted_op(groups, graph, engine_kind, delta)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = np.random.default_rng(7).integers(0, 3, graph.n)
    base = part.owned_vertex_base(groups.i, groups.j)
    sources = torch.arange(min(S, graph.n), dtype=torch.int32)
    onehot = (op.row_ids()[:, None] == sources[None, :]).to(torch.float32)
    fwd = engine.forward_buckets(op, onehot)
    max_bucket = int(op.reduce_max(bucket_index(fwd.dist, delta).max()))
    delta_acc = engine.backward_buckets(
        op, fwd.sigma, fwd.dist, torch.from_numpy(omega_pad[base : base + part.chunk]),
        max_bucket)
    return tuple(groups.gather_vertices(x)[0, : graph.n].numpy()
                 for x in (fwd.sigma, fwd.dist, delta_acc))


def _weighted_checksum(groups, graph):
    """The weighted round's refusal of the level-synchronous checksum lane,
    raised on every rank before any collective."""
    _, op = _weighted_op(groups, graph, "sparse", 0.5)
    try:
        traversal_round(op, torch.arange(4, dtype=torch.int32),
                        torch.full((2, 3), -1, dtype=torch.int32), torch.zeros(op.chunk),
                        integrity="checksum")
    except ValueError as err:
        return str(err)
    return None


RUNNERS = {"bc": _bc, "state": _state, "round": _first_round, "one_degree": _one_degree,
           "wstate": _weighted_state, "wchecksum": _weighted_checksum}


def run_cases(groups, cases):
    """``cases``: list of ``(name, kind, args)``; returns ``{name: result}``
    on every rank."""
    return {name: RUNNERS[kind](groups, *args) for name, kind, args in cases}
