"""The port's spans and counters (``repro_torch/tracing.py``) on the CPU:
off without a profiler, nested as the round loop nests under one, the
counters against hand counts on a path graph, fresh for each profiler
session, and the schedule's set-up phases inside its own time."""
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import repro_torch.graphs as pg
from repro_torch import tracing
from repro_torch.core import bc as pbc
from repro_torch.core.driver import traversal_round
from repro_torch.core.operators import DenseOperator
from repro_torch.core.scheduler import build_schedule

CPU = torch.device("cpu")


def _bc(graph, **kw):
    return pbc.betweenness_centrality(graph, batch_size=8, heuristics="h3",
                                      engine_kind="dense", device=CPU, **kw)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _spans(prof) -> dict[str, list[tuple[int, int]]]:
    out: dict[str, list[tuple[int, int]]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith("bc."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _inside(inner, outer) -> bool:
    return any(s <= a and b <= e for s, e in outer for a, b in [inner])


def test_off_without_a_profiler_enters_no_record_function(monkeypatch):
    _profiled(tracing.on)  # a session that records nothing: the counters start at zero
    assert tracing.counts() == {}
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    result = _bc(pg.grid_graph(4, 5), num_levels=None)
    assert result.rounds_run > 0
    assert calls == [] and tracing.counts() == {}
    # under a profiler the same run opens the spans through it
    _profiled(lambda: _bc(pg.grid_graph(4, 5)))
    assert {"bc.block", "bc.round", "bc.level.forward", "bc.readback"} <= set(calls)


def test_spans_nest_block_round_level_readback():
    prof, _ = _profiled(lambda: _bc(pg.grid_graph(4, 5)))
    spans = _spans(prof)
    for name in ("bc.block", "bc.round", "bc.level.forward", "bc.level.backward",
                 "bc.readback"):
        assert spans.get(name), name
    assert all(_inside(r, spans["bc.block"]) for r in spans["bc.round"])
    for level in spans["bc.level.forward"] + spans["bc.level.backward"]:
        assert _inside(level, spans["bc.round"])
    # the liveness loop reads its flag back inside every forward step
    assert all(any(_inside(r, [lv]) for r in spans["bc.readback"])
               for lv in spans["bc.level.forward"])
    # outside the blocks only the final fetch of the accumulator
    assert sum(not _inside(r, spans["bc.block"]) for r in spans["bc.readback"]) == 1


def _path_round(num_levels):
    # path 0-1-...-9; sources 0 (deepest vertex at 9) and 5 (at 5), one
    # padding source column and one padding derived column
    g = pg.path_graph(10)
    adj = torch.zeros(10, 10)
    adj[torch.from_numpy(g.src).long(), torch.from_numpy(g.dst).long()] = 1.0
    sources = torch.tensor([0, 5, -1], dtype=torch.int32)
    derived = torch.full((1, 3), -1, dtype=torch.int32)
    return traversal_round(DenseOperator(adj), sources, derived, torch.zeros(10),
                           num_levels=num_levels)


@pytest.mark.parametrize("num_levels, want", [
    # liveness: 10 forward steps (the last finds nothing), live 9 + 5;
    # 8 backward steps (from depth 9 - 1), live 8 + 4; s = 3, k = 1
    (None, {"level_steps": 18, "empty_level_steps": 1, "live_columns": 26,
            "operand_columns": 10 * 3 + 8 * 4}),
    # a static 12: forward steps 10-12 and backward steps 9-11 are empty
    (12, {"level_steps": 23, "empty_level_steps": 6, "live_columns": 26,
          "operand_columns": 12 * 3 + 11 * 4}),
])
def test_counters_on_a_path_graph_match_the_hand_count(num_levels, want):
    _path_round(num_levels)  # unprofiled: the next session counts from zero
    _, out = _profiled(lambda: _path_round(num_levels))
    assert out[3] == 10  # the round's levels: depth 9 + 1
    assert tracing.counts() == want


def test_each_profiler_session_counts_afresh():
    graph = pg.grid_graph(4, 5)
    _profiled(lambda: _bc(graph))
    first = tracing.counts()
    assert first["level_steps"] > 0 and first["live_columns"] > 0
    _bc(graph)  # unprofiled: adds nothing
    assert tracing.counts() == first
    _profiled(lambda: _bc(graph))
    assert tracing.counts() == first


def test_schedule_phase_seconds_fit_inside_the_call():
    graph = pg.rmat_graph(9, 8, seed=3)
    t = time.perf_counter()
    build_schedule(graph, batch_size=16, heuristics="h3")
    total = time.perf_counter() - t
    phases = [tracing.seconds()[f"bc.schedule.{p}"] for p in ("one_degree", "two_degree",
                                                                "pack")]
    assert all(s > 0 for s in phases)
    assert sum(phases) <= total
    assert np.isclose(sum(phases), total, rtol=0.5)
