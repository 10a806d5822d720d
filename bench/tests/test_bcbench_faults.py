"""The comparison that decides ``correct`` has to fail: a whole run on the
CPU at a small size with the timed path broken underneath, once per fault
a cell can have, and the control (the reference in bfloat16 in the
program's place)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from bcbench import harness  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"bc-rmat-s17-fused": {"scale": 9, "batch_size": 16},
         "bc-rmat-s23": {"scale": 9}}
CONFIG = {w["name"]: w["config"] for w in MANIFEST["workloads"]}
#: the faults of each cell: the exchange between chips exists on the grid
FAULTS = {"bc-rmat-s17-fused": ("unchanged_step", "half_batch", "altered_answer"),
          "bc-rmat-s23": ("unchanged_step", "half_batch", "altered_answer", "no_exchange")}
CASES = [(w, f) for w, c in CONFIG.items() for f in FAULTS[c]]


def _half_batch(fn):
    """Half of each round's sources left out, the rest's BC doubled."""
    def broken(sources, derived):
        sources = sources.clone()
        sources[:, sources.shape[1] // 2:] = -1
        out = list(fn(sources, derived))
        out[0] = out[0] * 2.0
        return tuple(out)
    return broken


def _altered_answer(fn):
    """One vertex's BC of every round 1 % off where the round produces it."""
    def broken(sources, derived):
        out = list(fn(sources, derived))
        bc = out[0].clone()
        flat = bc.view(-1)
        flat[int(flat.argmax())] *= 1.01
        out[0] = bc
        return tuple(out)
    return broken


def _unchanged_step(monkeypatch):
    from repro_torch.core import operators

    def step(self, lvl, sigma, depth):
        return sigma, depth, torch.zeros((), dtype=torch.bool, device=sigma.device)

    monkeypatch.setattr(operators.TraversalOperator, "forward_level", step)
    monkeypatch.setattr(operators.FusedDenseOperator, "forward_level", step)


def _no_exchange(monkeypatch):
    import torch.distributed as dist

    def gather(out, x, group=None, async_op=False):
        out.zero_()

    monkeypatch.setattr(dist, "all_gather_into_tensor", gather)
    monkeypatch.setattr(dist, "reduce_scatter_tensor", gather)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    wrap = None
    if fault == "half_batch":
        wrap = _half_batch
    elif fault == "altered_answer":
        wrap = _altered_answer
    elif fault == "unchanged_step":
        _unchanged_step(monkeypatch)
    else:
        _no_exchange(monkeypatch)
    out = harness.run(workload, 77, 0.2, False, device="cpu",
                      overrides=SMALL[CONFIG[workload]], fault=wrap, log=lambda msg: None)
    assert out["correct"] is False
    assert out["failed"] >= 1


@pytest.mark.parametrize("workload", list(CONFIG))
def test_the_control_is_not_correct(workload):
    over = dict(SMALL[CONFIG[workload]], scale=10)
    rows = harness.control(workload, [3, 2**31 + 5, 11], 2, device="cpu", overrides=over)
    assert len(rows) == 3
    for row in rows:
        assert row["correct"] is False, row
        assert row["checks"]["bc_err"]["value"] > row["checks"]["bc_err"]["limit"]


@pytest.mark.parametrize("workload", list(CONFIG))
def test_the_unbroken_path_is_correct(workload):
    out = harness.run(workload, 77, 0.2, False, device="cpu",
                      overrides=SMALL[CONFIG[workload]], log=lambda msg: None)
    assert out["correct"] is True and out["failed"] == 0
