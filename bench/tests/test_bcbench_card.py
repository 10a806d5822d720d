"""Each cell's path on the card at a small size: the fused kernels K1/K2
and the one-member NCCL grid, judged by the benchmark's own comparison.
Card-only; skips itself without a CUDA device."""
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
SMALL = {"bc-rmat-s17-fused": {"scale": 11}, "bc-rmat-s23": {"scale": 12}}


@pytest.mark.gpu
@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_path_on_the_card_is_correct(entry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(entry["name"], 3, 1.0, True, device="cuda",
                      overrides=SMALL[entry["config"]], log=lambda msg: None)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["metrics"]["level_roofline"]["value"] < 100.0
