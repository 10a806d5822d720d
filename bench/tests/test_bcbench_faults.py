"""The comparison that decides ``correct`` has to fail: a whole run on the
CPU at a small size with the timed path broken underneath, once per fault
a cell can have, and the control (the reference in bfloat16 in the
program's place); the same for a fixed sample of roots under h0, and the
refusal of what the reference cannot check."""
from __future__ import annotations

import dataclasses
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
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
#: a fixed sample of 32 roots under h0, put on the s17 configuration
SAMPLED = {"heuristics": "h0", "sampling": {"mode": "fixed", "k": 32, "seed": 3}}
S17 = "bc-rmat-s17.exact"


def _cfg(workload: str) -> dict:
    return harness.load_cell(ROOT, workload)[2]


def sizes(workload: str, kind: str) -> dict:
    """The configuration's ``test_sizes[kind]``."""
    return _cfg(workload)["test_sizes"][kind]


def faults(workload: str) -> tuple[str, ...]:
    """The faults a cell can have: the exchange between chips exists on
    the grid."""
    grid = ("no_exchange",) if _cfg(workload)["path"] == "grid" else ()
    return ("unchanged_step", "half_batch", "altered_answer") + grid


CASES = [(w, f) for w in WORKLOADS for f in faults(w)]


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


def _other_sample(monkeypatch):
    """The program's plan drawn from the next seed, not the configured one."""
    from repro_torch.serving import sampling

    plan = sampling.plan_sampling

    def other(eligible, mode, sample_frac=None, sample_k=None, seed=0):
        return plan(eligible, mode, sample_frac, sample_k, seed + 1)

    monkeypatch.setattr(sampling, "plan_sampling", other)


def _rescale(monkeypatch, fault: str):
    """The program's sampled estimator broken: its rescale left out, or its
    N one short."""
    from repro_torch.core import bc
    from repro_torch.serving import sampling

    if fault == "no_rescale":
        monkeypatch.setattr(bc, "apply_sampling_rescale", lambda result, plan: result)
        return
    plan = sampling.plan_sampling

    def short(*args, **kwargs):
        out = plan(*args, **kwargs)
        return dataclasses.replace(out, num_eligible=out.num_eligible - 1)

    monkeypatch.setattr(sampling, "plan_sampling", short)


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
                      overrides=sizes(workload, "faults"), fault=wrap, log=lambda msg: None)
    assert out["correct"] is False
    assert out["failed"] >= 1


def _control_fails(rows):
    assert len(rows) == 3
    for row in rows:
        assert row["correct"] is False, row
        assert row["checks"]["bc_err"]["value"] > row["checks"]["bc_err"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    _control_fails(harness.control(workload, [3, 2**31 + 5, 11], 2, device="cpu",
                                   overrides=sizes(workload, "control")))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_unbroken_path_is_correct(workload):
    out = harness.run(workload, 77, 0.2, False, device="cpu",
                      overrides=sizes(workload, "faults"), log=lambda msg: None)
    assert out["correct"] is True and out["failed"] == 0


@pytest.mark.parametrize("fault", ["other_sample", "half_batch", "altered_answer", "no_rescale",
                                   "rescale_n_short"])
def test_a_broken_sampled_path_is_not_correct(fault, monkeypatch):
    wrap = {"half_batch": _half_batch, "altered_answer": _altered_answer}.get(fault)
    if fault == "other_sample":
        _other_sample(monkeypatch)
    elif fault in ("no_rescale", "rescale_n_short"):
        _rescale(monkeypatch, fault)
    out = harness.run(S17, 77, 0.2, False, device="cpu",
                      overrides=dict(sizes(S17, "faults"), **SAMPLED), fault=wrap,
                      log=lambda msg: None)
    assert out["correct"] is False
    if fault == "other_sample":
        # the program's rounds are the ones its own schedule gave them
        assert out["checks"]["plan_errors"]["value"] > 0
    elif fault in ("no_rescale", "rescale_n_short"):
        # every round's sums are right; only the estimator is not
        assert out["checks"]["plan_errors"]["value"] == 0
        assert out["checks"]["bc_err"]["value"] > out["checks"]["bc_err"]["limit"]
    else:
        assert out["failed"] >= 1


def test_the_sampled_control_is_not_correct():
    _control_fails(harness.control(S17, [3, 2**31 + 5, 11], 2, device="cpu",
                                   overrides=dict(sizes(S17, "control"), **SAMPLED)))


@pytest.mark.parametrize("sampling", [None, SAMPLED["sampling"]], ids=["exact", "sampled"])
def test_the_unbroken_h0_path_is_correct(sampling):
    out = harness.run(S17, 77, 0.2, False, device="cpu",
                      overrides=dict(sizes(S17, "faults"), heuristics="h0", sampling=sampling),
                      log=lambda msg: None)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["plan_errors"]["value"] == 0


@pytest.mark.parametrize("over", [
    {"heuristics": "h1t"}, {"heuristics": "h3t"},
    dict(SAMPLED, heuristics="h1"), dict(SAMPLED, heuristics="h2"),
    dict(SAMPLED, heuristics="h3"), dict(SAMPLED, heuristics="h3t"),
    {"heuristics": "h0", "sampling": {"mode": "adaptive", "k": 32, "seed": 3}},
], ids=["h1t", "h3t", "sampled_h1", "sampled_h2", "sampled_h3", "sampled_h3t", "adaptive"])
def test_what_the_reference_cannot_check_is_refused(over):
    over = dict(sizes(S17, "faults"), **over)
    with pytest.raises(ValueError, match="heuristics|sampling"):
        harness.load_cell(ROOT, S17, over)
    with pytest.raises(ValueError, match="heuristics|sampling"):
        harness.run(S17, 1, 0.0, False, device="cpu", overrides=over, log=lambda msg: None)
    with pytest.raises(ValueError, match="heuristics|sampling"):
        harness.control(S17, [1], 1, device="cpu", overrides=over)
