"""Rank-side case runner for tests/test_torch_cells.py and
tests/test_torch_roofline.py: the BC cell's round and the work counter on
spawned gloo grids.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import distributed_graph_arrays, make_distributed_round_fn
from repro_torch.core.scheduler import build_schedule
from repro_torch.graphs import partition_2d, rmat_graph
from repro_torch.launch.steps import build_cell
from repro_torch.roofline.counter import WorkCounter


def _numpy(out) -> tuple:
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in out)


def _cell(groups, bundle, shape_name, seed):
    """The cell's round on every dispatch block, at the static bound and
    with the liveness loop: ``{"static": [...], "liveness": [...]}`` (each
    block's outputs in numpy), the inputs, the meta and the set-up."""
    cell = build_cell(bundle, shape_name, groups, device="cpu", seed=seed)
    blocks = -(-len(cell.schedule.rounds) // groups.fr)
    out = {"static": [], "liveness": [], "inputs": [], "meta": cell.static_meta,
           "residual_n": cell.residual.n}
    for block in range(blocks):
        sources, derived = cell.round_inputs(block)
        out["inputs"].append((sources, derived))
        out["static"].append(_numpy(cell.fn(sources, derived)))
        out["liveness"].append(_numpy(cell.fn(sources, derived, num_levels=None)))
    return out


def _group_name(groups, group) -> str:
    for name in ("column", "row", "grid", "replica"):
        if group is getattr(groups, name):
            return name
    return "world" if group is None else "other"


def _counted_round(groups, engine_kind, overlap, num_levels):
    """One round of the benchmarks/fig9_overlap.py set-up —
    ``rmat_graph(8, 8, seed=0)``, ``build_schedule(batch_size=16)``, the
    residual's partition on the grid, ω = 0, the schedule's first round —
    under a :class:`WorkCounter`: its records (the group named, not the
    object), its terms, and what a counter entered and left before an
    uncounted run of the round recorded (must be nothing)."""
    graph = rmat_graph(8, 8, seed=0)
    schedule, _, residual, _ = build_schedule(graph, batch_size=16)
    part = partition_2d(residual, groups.R, groups.C)
    fn = make_distributed_round_fn(part, groups, num_levels=num_levels, engine_kind=engine_kind,
                                   overlap=overlap)
    args = distributed_graph_arrays(part, engine_kind, groups.i, groups.j, "cpu",
                                    overlap=overlap)
    rnd = schedule.rounds[0]
    inputs = (torch.zeros(part.n_pad), torch.from_numpy(rnd.sources[None]),
              torch.from_numpy(rnd.derived[None]))
    idle = WorkCounter()
    with idle:  # entered and left before the round: it must record nothing of it
        pass
    fn(args, *inputs)
    with WorkCounter() as counter:
        fn(args, *inputs)
    records = [dict(rec, group=_group_name(groups, rec["group"])) for rec in counter.records]
    return {"records": records, "terms": counter.terms(), "by_name": counter.by_name(),
            "idle": (idle.records, idle.work)}


RUNNERS = {"cell": _cell, "counted": _counted_round}


def run_cases(groups, cases):
    """``cases``: list of ``(name, kind, args)``; returns ``{name: result}``
    on every rank."""
    return {name: RUNNERS[kind](groups, *args) for name, kind, args in cases}
