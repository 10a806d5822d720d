"""Rank-side case runner for tests/test_torch_autotune.py: the measured-cost
autotuner on a spawned gloo grid.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require.

A "skewed" case replaces the planner's bench with one whose walls depend
on the rank, so that each rank alone would rank the candidates
differently: the grid must still plan alike on every rank (every wall is
agreed over the ranks).  The "plan" cases call the planner directly with
that bench, with the agreement and without it (the mutation check).
"""
from __future__ import annotations

import zlib

from repro_torch.autotune import CostRecord, measure, plan_autotune
from repro_torch.core.distributed import _max_over_ranks, distributed_betweenness_centrality
from repro_torch.core.scheduler import build_schedule
from repro_torch.graphs.partition import partition_2d


def skewed_bench(rank: int):
    """A fake bench whose per-level wall of a candidate depends on the rank
    (a different order of the candidates on every rank)."""

    def bench(cand):
        level_s = 1e-3 * (1 + (zlib.crc32(cand.key().encode()) + 5 * rank) % 11)
        return CostRecord(level_s=level_s, levels=measure.MEASURE_LEVELS, walls=(8 * level_s,))

    return bench


def _bc(groups, graph, kwargs, skewed):
    plain = measure.default_bench
    if skewed:
        measure.default_bench = lambda *a, **kw: skewed_bench(groups.rank)
    try:
        res = distributed_betweenness_centrality(graph, groups, device="cpu", full_result=True,
                                                 **kwargs)
    finally:
        measure.default_bench = plain
    lay = res.layout_stats
    return {"bc": res.bc, "report": lay.get("autotune"), "overlap": lay["overlap"],
            "tile": lay.get("tile"), "dense_cells": lay.get("dense_cells"),
            "round_depths": res.schedule.round_depths, "rounds_run": res.rounds_run}


def _plan(groups, graph, kwargs, agree):
    """The planner alone, on the rank-skewed bench: its report."""
    schedule, _, residual, _ = build_schedule(graph, batch_size=kwargs["batch_size"],
                                              root_order="eccentricity")
    part = partition_2d(residual, groups.R, groups.C)
    plan = plan_autotune(part, groups, graph=residual, fr=groups.fr, mode="measure",
                         bench=skewed_bench(groups.rank),
                         agree_seconds=_max_over_ranks("cpu") if agree else None, **kwargs)
    return {"report": plan.report(), "tile": plan.tile, "cell_costs": plan.cell_costs}


def run_cases(groups, cases):
    """``cases``: list of ``(name, kind, graph, kwargs)`` with kind "bc",
    "skewed", "plan" or "plan-unagreed"; returns ``{name: result}``."""
    out = {}
    for name, kind, graph, kwargs in cases:
        if kind in ("bc", "skewed"):
            out[name] = _bc(groups, graph, kwargs, skewed=kind == "skewed")
        else:
            out[name] = _plan(groups, graph, kwargs, agree=kind == "plan")
    return out
