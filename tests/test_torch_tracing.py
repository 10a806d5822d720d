"""The port's spans and counters (``repro_torch/tracing.py``) on the CPU:
off without a profiler, nested as the round loop nests under one, the
counters against hand counts on a path graph and on sampled and exact
schedules, fresh for each profiler session, and the set-up phases of the
schedule and of the sample's plan inside their own time."""
import collections
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import shortest_path
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.graphs as pg
from repro_torch import tracing
from repro_torch.core import bc as pbc
from repro_torch.core.driver import traversal_round
from repro_torch.core.operators import DenseOperator
from repro_torch.core.scheduler import build_schedule
from repro_torch.serving.sampling import eligible_roots, plan_sampling

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
    # 8 backward steps (from depth 9 - 1), live 8 + 4; s = 3, k = 1; the
    # padding source column in every step, the padding derived one backward
    # (a round called directly: no dispatch block trims it)
    (None, {"level_steps": 18, "empty_level_steps": 1, "live_columns": 26,
            "operand_columns": 10 * 3 + 8 * 4, "padded_columns": 10 * 1 + 8 * 2,
            "trimmed_slots": 0}),
    # a static 12: forward steps 10-12 and backward steps 9-11 are empty
    (12, {"level_steps": 23, "empty_level_steps": 6, "live_columns": 26,
          "operand_columns": 12 * 3 + 11 * 4, "padded_columns": 12 * 1 + 11 * 2,
          "trimmed_slots": 0}),
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


def _depth(graph, roots) -> int:
    """The deepest BFS level from any of ``roots`` (scipy, not the port)."""
    adj = sp.csr_matrix((np.ones(graph.src.size), (graph.src, graph.dst)),
                        shape=(graph.n, graph.n))
    d = shortest_path(adj, unweighted=True, indices=np.asarray(roots, np.int64))
    return int(d[np.isfinite(d)].max())


def _padded_by_hand(graph, rounds) -> int:
    """Σ over ``rounds`` of the liveness loops' steps times their unfilled
    slots: D_src + 1 forward steps (the last finds nothing) over the
    unfilled sources, D − 1 backward over the unfilled sources and derived
    slots, D_src the sources' depth and D the round's (derived columns
    searched from their own roots)."""
    total = 0
    for rnd in rounds:
        src = rnd.sources[rnd.sources >= 0]
        der = rnd.derived[rnd.derived[:, 0] >= 0, 0]
        d_src = _depth(graph, src)
        d_all = _depth(graph, np.concatenate([src, der]))
        pad_src = int((rnd.sources < 0).sum())
        pad_all = pad_src + int((rnd.derived[:, 0] < 0).sum())
        total += (d_src + 1) * pad_src + max(d_all - 1, 0) * pad_all
    return total


def test_sampled_h0_run_pads_its_unfilled_slots_in_every_step():
    # 11 sampled roots in rounds of 8: 8 + 3 sources, 4 derived slots a
    # round, all padding under h0
    graph = pg.grid_graph(4, 5)
    kw = dict(sampling="fixed", sample_k=11, sample_seed=3)
    plan = plan_sampling(eligible_roots(graph), "fixed", sample_k=11, seed=3)
    schedule = build_schedule(graph, batch_size=8, heuristics="h0", roots=plan.roots)[0]
    assert [int((r.sources >= 0).sum()) for r in schedule.rounds] == [8, 3]
    assert all((r.derived[:, 0] < 0).all() for r in schedule.rounds)
    _profiled(lambda: pbc.betweenness_centrality(graph, batch_size=8, heuristics="h0",
                                                 engine_kind="dense", device=CPU, **kw))
    got = tracing.counts()
    # the driver ships none of the 4 derived slots; the counters still
    # count them as padded backward columns, as the schedule has them
    assert got["padded_columns"] == _padded_by_hand(graph, schedule.rounds) > 0
    assert got["trimmed_slots"] == 2 * 4
    assert got["padded_columns"] + got["live_columns"] <= got["operand_columns"]


def test_exact_h3_round_pads_only_its_unclaimed_derived_slots():
    # R-MAT 6: its first round claims 2 of its 4 derived slots
    graph = pg.rmat_graph(6, 4, seed=2)
    schedule, _, residual, omega = build_schedule(graph, batch_size=8, heuristics="h3")
    rnd = next(r for r in schedule.rounds
               if 0 < (r.derived[:, 0] >= 0).sum() < r.derived.shape[0])
    adj = torch.zeros(residual.n, residual.n)
    adj[torch.from_numpy(residual.src).long(), torch.from_numpy(residual.dst).long()] = 1.0
    _profiled(lambda: traversal_round(DenseOperator(adj), torch.from_numpy(rnd.sources),
                                      torch.from_numpy(rnd.derived),
                                      torch.from_numpy(omega).float()))
    # the claimed triples' columns have roots: only the unclaimed derived
    # slots (and any unfilled source) are padding
    assert tracing.counts()["padded_columns"] == _padded_by_hand(residual, [rnd])


class _Ops(TorchDispatchMode):
    """The aten ops dispatched while active, counted by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_off_the_counters_launch_nothing_and_read_nothing_back(monkeypatch):
    def round_ops():
        with _Ops() as log:
            _path_round(None)
        return log.ops

    _profiled(tracing.on)
    calls = []
    real = tracing.count_levels
    monkeypatch.setattr(tracing, "count_levels", lambda *a, **k: calls.append(a) or real(*a, **k))
    off = round_ops()
    assert calls == [] and tracing.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = round_ops()
    assert len(calls) == 2
    # on, the counters add device ops and no readback; off, nothing at all
    extra = on - off
    assert not off - on
    assert on["aten._local_scalar_dense"] == off["aten._local_scalar_dense"]
    assert set(extra) <= {"aten.amax", "aten.sub", "aten.clamp", "aten.sum", "aten.add",
                          "aten.lt", "aten.mul", "profiler._record_function_enter_new",
                          "profiler._record_function_exit"}
    assert extra["aten.lt"] == 2


def test_sample_plan_seconds_are_kept_off_and_fit_inside_the_call():
    eligible = np.arange(200_000)
    t = time.perf_counter()
    plan = plan_sampling(eligible, "fixed", sample_k=512, seed=1)
    total = time.perf_counter() - t
    assert plan.roots.size == 512
    assert 0 < tracing.seconds()["bc.sample.plan"] <= total


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
