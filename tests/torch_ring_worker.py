"""Rank-side case runner for tests/test_torch_ring.py: the ring schedules
and the checked level steps on spawned gloo grids.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require.

The package's work counter (roofline/counter.py) records every
collective the level steps issue; :func:`_counted` files each under the
group it ran on (``column``, ``row`` or ``other``), so a case can show
which exchanges its level steps made — the counterpart of the JAX
package's HLO check (tests/test_dist_overlap.py).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.distributed import (
    distributed_betweenness_centrality,
    distributed_graph_arrays,
    make_distributed_operator,
)
from repro_torch.core.operators import (
    DistributedFusedOperator,
    DistributedOperator,
    TraversalOperator,
)
from repro_torch.graphs.partition import partition_2d
from repro_torch.roofline.counter import WorkCounter

S = 8  # sources of an operator-state case (tests/test_dist_overlap.py)


#: the counter's collective classes, by the names the ring tests read
KINDS = {"all-gather": "gather", "reduce-scatter": "reduce_scatter",
         "collective-permute": "hops", "all-reduce": "all_reduce"}


def _counted(groups, fn):
    """``fn()`` under the package's :class:`WorkCounter`; returns (its
    result, the collectives it issued per group and kind — ``column``,
    ``row`` or ``other``; a ring hop is one record, whatever it sends)."""
    with WorkCounter() as counter:
        out = fn()
    counts = collections.Counter()
    for rec in counter.records:
        where = next((name for name in ("column", "row")
                      if rec["group"] is getattr(groups, name)), "other")
        counts[f"{where}/{KINDS[rec['class']]}"] += 1
    return out, dict(counts)


def _state(groups, graph, engine_kind, overlap):
    """(σ, d, δ) [n, S] of one forward + backward pass through the rank's
    2-D operator under ``overlap`` (tests/test_dist_overlap.py's
    ``_ring_state`` inputs: sources 0..S-1, ω from seed 7), in vertex
    order, with the collectives its level steps made and their count."""
    part = partition_2d(graph, groups.R, groups.C)
    args = distributed_graph_arrays(part, engine_kind, groups.i, groups.j, "cpu",
                                    overlap=overlap)
    op = make_distributed_operator(engine_kind, args, chunk=part.chunk, groups=groups,
                                   overlap=overlap)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = np.random.default_rng(7).integers(0, 3, graph.n)
    base = part.owned_vertex_base(groups.i, groups.j)
    omega = torch.from_numpy(omega_pad[base : base + part.chunk])
    sources = torch.arange(min(S, graph.n), dtype=torch.int32)
    onehot = (op.row_ids()[:, None] == sources[None, :]).to(torch.float32)
    levels = collections.Counter()
    for name in ("forward_level", "backward_level"):
        step = getattr(op, name)

        def counted(*a, _step=step, _name=name):
            levels[_name] += 1
            return _step(*a)

        setattr(op, name, counted)

    def traverse():
        fwd = engine.forward_counting(op, onehot)
        delta = engine.backward_accumulation(op, fwd.sigma, fwd.depth, omega, fwd.max_depth)
        return fwd.sigma, fwd.depth, delta

    (sigma, depth, delta), counts = _counted(groups, traverse)
    n = graph.n
    state = tuple(groups.gather_vertices(x)[0, :n].numpy() for x in (sigma, depth, delta))
    return state + (counts, levels["forward_level"] + levels["backward_level"])


def _bc(groups, graph, kwargs):
    """One run; ``steps`` counts the level steps this rank's operators ran
    (with replica lockstep, every rank of every replica runs the same)."""
    steps = [0]
    saved = []
    for cls in (TraversalOperator, DistributedFusedOperator):
        for name in ("forward_level", "backward_level"):
            fn = cls.__dict__[name]
            saved.append((cls, name, fn))

            def counted(*a, _fn=fn, **k):
                steps[0] += 1
                return _fn(*a, **k)

            setattr(cls, name, counted)
    try:
        res = distributed_betweenness_centrality(graph, groups, device="cpu", full_result=True,
                                                 **kwargs)
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return {"bc": res.bc, "round_levels": res.round_levels, "rounds_run": res.rounds_run,
            "recovery": res.recovery_stats, "overlap": res.layout_stats["overlap"],
            "steps": steps[0]}


def _perturbed(groups, graph, kwargs, rank, call):
    """:func:`_bc` with rank ``rank`` adding 5 to one entry of its folded
    t on its ``call``-th fold (counted from 1), once."""
    fold = DistributedOperator._fold_partial
    calls = [0]

    def perturbed(self, partial):
        t = fold(self, partial)
        calls[0] += 1
        if groups.rank == rank and calls[0] == call:
            t = t.clone()
            t[0, 0] += 5.0
        return t

    DistributedOperator._fold_partial = perturbed
    try:
        return _bc(groups, graph, kwargs)
    finally:
        DistributedOperator._fold_partial = fold


RUNNERS = {"state": _state, "bc": _bc, "perturbed": _perturbed}


def run_cases(groups, cases):
    """``cases``: list of ``(name, kind, args)``; returns ``{name: result}``
    on every rank."""
    return {name: RUNNERS[kind](groups, *args) for name, kind, args in cases}
