"""``padding_column_pct`` (the program's ``padded_columns`` over its
``operand_columns``) of a traced CPU run of every cell at its small size,
against the share worked out on the host: the schedule's unfilled slots
times the loop bounds the reference's round depths give."""
from __future__ import annotations

import json
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

from bcbench import harness, reference, traffic  # noqa: E402
from bcbench.cell import program_schedule  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


def host_share(cfg: dict, graph, rounds) -> float:
    """100 · padded / operand column-steps of ``rounds``, each run once:
    D_src + 1 forward steps (the last finds nothing) and D − 1 backward
    under the liveness loop, D_src the sources' depth and D the round's
    (derived columns searched from their own roots), by the reference; L
    and L − 1 under a static bound L.  A forward step runs the source
    slots, a backward step the source and derived slots; a slot with no
    root is padded."""
    brandes = reference.Brandes(harness.decompose(cfg, graph), torch.device("cpu"))
    L = cfg["max_levels"]
    padded = operand = 0
    for rnd in rounds:
        src, der = rnd.sources, rnd.derived
        if L is None:
            d_src = brandes.round(src[src >= 0].astype(np.int64)).levels - 1
            depth = brandes.round(reference.round_roots(src, der)).levels - 1
            fwd, bwd = d_src + 1, max(depth - 1, 0)
        else:
            fwd, bwd = L, L - 1
        pad_src = int((src < 0).sum())
        padded += fwd * pad_src + bwd * (pad_src + int((der[:, 0] < 0).sum()))
        operand += fwd * src.size + bwd * (src.size + der.shape[0])
    return 100.0 * padded / operand


@pytest.mark.parametrize("workload", WORKLOADS)
def test_padding_column_pct_is_the_schedules_unfilled_slots_over_the_loops_bounds(workload):
    _, _, cfg, mix = harness.load_cell(ROOT, workload)
    sizes = cfg["test_sizes"]["cpu"]
    cfg = harness.load_cell(ROOT, workload, sizes)[2]
    # no seconds: one pass over the cell's own pool, each round once
    out = harness.run(workload, 2**31 + 5, 0.0, True, device="cpu", overrides=sizes,
                      log=lambda msg: None)
    assert out["correct"] is True, out["checks"]
    graph = harness._graph(cfg, None)
    (schedule, *_), _ = program_schedule(cfg, graph)
    pool = traffic.pool(len(schedule.rounds), mix)
    assert out["attempted"] == len(pool)
    want = host_share(cfg, graph, [schedule.rounds[i] for i in pool])
    assert out["metrics"]["padding_column_pct"]["value"] == pytest.approx(want)


def test_the_reader_finds_nothing_in_a_program_without_the_counter(monkeypatch):
    # a program from before the counter: its counts have no padded_columns
    reader = harness._load_module(BENCH / "metrics" / "padding_column_pct.py", "t_padding")
    ctx = SimpleNamespace(trace=object(), rounds=[(5, 2, 3)])
    counts = {"level_steps": 9, "empty_level_steps": 1, "operand_columns": 40,
              "live_columns": 20}
    monkeypatch.setattr(reader, "program_counts", lambda: counts)
    assert reader.read(ctx) is None
    monkeypatch.setattr(reader, "program_counts", lambda: dict(counts, padded_columns=10))
    assert reader.read(ctx) == pytest.approx(25.0)
