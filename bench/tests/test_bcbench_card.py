"""Each cell's path on the card at a small size: the fused kernels K1/K2
and the one-member NCCL grid, and a fixed h0 sample of roots on the fused
path, judged by the benchmark's own comparison.  Card-only; skips itself
without a CUDA device."""
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
#: a fixed sample of 512 roots under h0 (four rounds of 128), on the s17 configuration
SAMPLED = {"heuristics": "h0", "sampling": {"mode": "fixed", "k": 512, "seed": 3}}


def _card_run(workload: str, extra: dict) -> dict:
    sizes = harness.load_cell(ROOT, workload)[2]["test_sizes"]["card"]
    out = harness.run(workload, 3, 1.0, True, device="cuda", overrides=dict(sizes, **extra),
                      log=lambda msg: None)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["metrics"]["level_roofline"]["value"] < 100.0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_path_on_the_card_is_correct(entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _card_run(entry["name"], {})


@pytest.mark.gpu
def test_sampled_h0_variant_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _card_run("bc-rmat-s17.exact", SAMPLED)
    assert out["checks"]["plan_errors"]["value"] == 0 and out["attempted"] >= 4
