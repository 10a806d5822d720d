"""The readers of the program's own spans and counters
(``bcbench/spans.py`` and the metrics that use it): the gap split on a
synthetic trace, and the counters of traced CPU runs of both cells at
small sizes against the benchmark's own count and the loops' bounds."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from bcbench import harness  # noqa: E402
from bcbench.cell import program_schedule  # noqa: E402
from bcbench.spans import COLLECTIVE, HOST, SYNC, gap_seconds  # noqa: E402
from bcbench.trace import Trace  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
GAP_METRICS = ("sync_gap_ms_per_round", "collective_gap_ms_per_round", "host_gap_ms_per_round")


def _sizes(workload: str, kind: str) -> dict:
    """The configuration's ``test_sizes[kind]`` (``cpu``: the harness tests' sizes)."""
    return harness.load_cell(ROOT, workload)[2]["test_sizes"][kind]


def _cfg(workload: str) -> dict:
    return harness.load_cell(ROOT, workload, _sizes(workload, "cpu"))[2]


def _read(name: str, ctx):
    return harness._load_module(BENCH / "metrics" / f"{name}.py", f"tr_{name}").read(ctx)


def _traced_run(workload: str, mix=None):
    logged = []
    out = harness.run(workload, 2**31 + 5, 0.0, True, device="cpu",
                      overrides=_sizes(workload, "cpu"), mix=mix, log=logged.append)
    assert out["correct"] is True, out["checks"]
    levels = re.search(r"levels (\d+)-(\d+).*?; (\d+) level steps\)", logged[-1])
    return out, int(levels.group(1)), int(levels.group(2)), int(levels.group(3))


# ---------------------------------------------------------------- the gap split
def _trace() -> Trace:
    # device idle over (1, 2), (3, 4), (4.5, 5) and (6, 8)
    device = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 4.0, 4.5), ("k", 5.0, 6.0),
              ("k", 8.0, 10.0)]
    host = [("bench.round", 0.1, 5.0), ("bc.block", 0.0, 5.5), ("bc.round", 0.2, 4.8),
            ("bc.level.forward", 0.5, 1.6), ("bc.readback", 0.9, 1.5),
            ("bc.level.backward", 2.5, 4.6), ("bc.collective.all_reduce", 2.9, 3.3),
            ("aten::item", 4.4, 4.9)]
    return Trace(window_s=10.0, device=device, host=host)


def test_gaps_split_by_the_innermost_program_span_at_their_start():
    # (1, 2) opens in a readback inside a forward step; (3, 4) in a
    # collective inside a backward step; (4.5, 5) in the backward step
    # itself (an aten op and a benchmark span are not program spans);
    # (6, 8) outside every program span, counted in none
    gaps = gap_seconds(_trace())
    assert gaps == {SYNC: pytest.approx(1.0), COLLECTIVE: pytest.approx(1.0),
                    HOST: pytest.approx(0.5)}
    ctx = SimpleNamespace(trace=_trace(), rounds=[(5, 2, 3), (5, 2, 3)])
    assert _read("sync_gap_ms_per_round", ctx) == pytest.approx(500.0)
    assert _read("collective_gap_ms_per_round", ctx) == pytest.approx(500.0)
    assert _read("host_gap_ms_per_round", ctx) == pytest.approx(250.0)


def test_gap_readers_find_nothing_without_program_spans_or_device_activity():
    # a program without spans (its trace holds none) and a CPU trace
    bare = Trace(window_s=10.0, device=_trace().device, host=[("aten::mm", 0.0, 9.0)])
    cpu = Trace(window_s=10.0, device=[], host=_trace().host)
    for trace in (bare, cpu):
        assert gap_seconds(trace) is None
        for name in GAP_METRICS:
            assert _read(name, SimpleNamespace(trace=trace, rounds=[(5, 2, 3)])) is None


# ------------------------------------------------------------- the counters
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_level_steps_equal_the_benchmarks_count(workload):
    from repro_torch import tracing

    out, _, _, counted = _traced_run(workload)
    assert counted > 0 and tracing.counts()["level_steps"] == counted
    assert out["metrics"]["levels_per_round"]["value"] == pytest.approx(
        counted / out["attempted"])
    live = out["metrics"]["live_column_pct"]["value"]
    assert 0.0 < live < 100.0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_empty_level_pct_follows_the_loops_bounds(workload):
    from repro_torch.core.scheduler import bfs_depths

    cfg = _cfg(workload)
    # one round, the schedule's first, so its depths can be worked out here
    out, levels, _, steps = _traced_run(workload, mix={"pool_rounds": 1})
    assert out["attempted"] == 1
    L = cfg["max_levels"]
    if L is None:
        # the liveness loop: only its last forward step finds nothing
        want = 100.0 * out["attempted"] / steps
    else:
        (schedule, _, residual, _), _ = program_schedule(cfg, harness._graph(cfg, None))
        d_src = max(int(bfs_depths(residual, int(v)).max())
                    for v in schedule.rounds[0].sources if v >= 0)
        depth = levels - 1
        assert steps == 2 * L - 1
        want = 100.0 * ((L - min(d_src, L)) + (L - 1 - min(depth - 1, L - 1))) / steps
    assert out["metrics"]["empty_level_pct"]["value"] == pytest.approx(want)
    # the set-up phases split the benchmark's clock around build_schedule
    split = sum(out["metrics"][f"schedule_{p}_s"]["value"]
                for p in ("one_degree", "two_degree", "pack"))
    assert 0 < split <= out["metrics"]["schedule_s"]["value"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_gap_metrics_on_the_card_fit_in_the_idle_time(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(workload, 2**31 + 7, 1.0, True, device="cuda",
                      overrides=_sizes(workload, "card"), log=lambda msg: None)
    assert out["correct"] is True, out["checks"]
    dev, metrics = out["device"], out["metrics"]
    idle_ms = 1e3 * (dev["window_s"] - dev["busy_s"]) / out["attempted"]
    wanted = [m["name"] for m in MANIFEST["per_layer"] if m["name"] in GAP_METRICS
              and workload in m.get("workloads", [workload])]
    assert wanted and all(name in metrics for name in wanted)
    total = sum(metrics[name]["value"] for name in wanted)
    assert 0.0 <= total <= idle_ms * (1 + 1e-9)
    assert np.isfinite(metrics["live_column_pct"]["value"])
