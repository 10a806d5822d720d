"""Sampling stop rules, the snapshot store and ``serve_bc`` in the port,
held against the JAX package (tests/test_sampling.py, tests/test_serving.py).

The stop rules and the store are numpy in both packages: they are held
equal on the same inputs.  The end-to-end runs (adaptive acceptance,
resume composed with sampling, ``run_serving``) compare the port's BC with
the JAX package's and the oracle at 1e-6 (rtol 1e-5 / atol 1e-4 for the
served estimates, as tests/test_serving.py holds them).
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import betweenness_centrality as jax_bc
from repro.distributed.fault_tolerance import BCCheckpoint as JaxBCCheckpoint
from repro.serving import sampling as jsamp
from repro.serving import store as jstore
import repro_torch.graphs as pg
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.distributed import BCCheckpoint
from repro_torch.launch.serve_bc import run_serving
from repro_torch.roofline import sampled_run_seconds
from repro_torch.serving import (
    AdaptiveStopRule,
    BCSnapshotStore,
    BlockBudgetStop,
    eligible_roots,
    rank_stability,
    top_k_indices,
)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)
SERVED = dict(rtol=1e-5, atol=1e-4)


def _bc(graph, **kw):
    return pbc.betweenness_centrality(graph, device="cpu", **kw)


# ------------------------------------------------- rank metrics, rules
@pytest.mark.parametrize("scores", [
    [1.0, 3.0, 3.0, 2.0], [0.0] * 6, [5.0, 5.0, 5.0, 1.0, 5.0], list(range(12))[::-1],
])
@pytest.mark.parametrize("k", [1, 3, 20])
def test_top_k_indices_match_jax_with_ties(scores, k):
    s = np.asarray(scores)
    np.testing.assert_array_equal(top_k_indices(s, k), jsamp.top_k_indices(s, k))
    assert top_k_indices(np.array([1.0, 3.0, 3.0, 2.0]), 3).tolist() == [1, 2, 3]


@pytest.mark.parametrize("method", ["jaccard", "kendall"])
@pytest.mark.parametrize("seed", range(4))
def test_rank_stability_matches_jax(method, seed):
    rng = np.random.default_rng(seed)
    a, b = rng.random(40), rng.random(40)
    b[:20] = a[:20]  # partial agreement
    for x, y in ((a, b), (a, a.copy()), (a, 2.5 * a)):
        assert rank_stability(x, y, k=10, method=method) == jsamp.rank_stability(
            x, y, k=10, method=method)
    assert rank_stability(a, 3.0 * a, k=10, method=method) == 1.0
    with pytest.raises(ValueError):
        rank_stability(a, b, method="spearman")


@pytest.mark.parametrize("window,min_blocks", [(1, 1), (2, 3), (3, 1), (1, 6), (4, 4)])
def test_adaptive_stop_min_blocks_matches_jax(window, min_blocks):
    """A frozen accumulator cannot stop before min_blocks; the port's rule
    fires at the JAX rule's block, with the same telemetry."""
    got = AdaptiveStopRule(top_k=4, window=window, min_blocks=min_blocks)
    want = jsamp.AdaptiveStopRule(top_k=4, window=window, min_blocks=min_blocks)
    bc = np.arange(16, dtype=np.float64)
    fired = [(got(bc, b), want(bc, b)) for b in range(1, 12)]
    assert all(a == b for a, b in fired)
    assert got.stats == want.stats
    assert got.stats["fired_at_block"] == max(min_blocks, window + 1)


def test_adaptive_stop_defers_while_ranks_move():
    got = AdaptiveStopRule(top_k=3, window=2, min_blocks=1)
    want = jsamp.AdaptiveStopRule(top_k=3, window=2, min_blocks=1)
    for block in range(1, 21):
        bc = np.zeros(24)
        bc[(3 * block) % 24], bc[(3 * block + 1) % 24] = 10.0, 5.0
        assert got(bc, block) is want(bc, block) is False
    assert got.stats == want.stats and got.stats["fired_at_block"] is None
    with pytest.raises(ValueError):
        AdaptiveStopRule(window=0)


def test_block_budget_stop_matches_jax():
    got, want = BlockBudgetStop(3), jsamp.BlockBudgetStop(3)
    bc = np.zeros(4)
    assert [got(bc, b) for b in (1, 2, 3, 4)] == [want(bc, b) for b in (1, 2, 3, 4)] == [
        False, False, True, True]
    assert got.stats == want.stats
    with pytest.raises(ValueError):
        BlockBudgetStop(0)


def test_sampled_run_seconds_matches_jax():
    from repro.roofline.model import sampled_run_seconds as jax_srs

    for args in ((0, 1, 1.0), (7, 2, 0.25), (8, 2, 0.25), (9, 4, 1.5), (5, 0, 2.0)):
        assert sampled_run_seconds(*args) == jax_srs(*args)


# ------------------------------------------------ sampled BC end to end
def test_adaptive_acceptance_rmat_8_8():
    """tests/test_sampling.py's acceptance: adaptive mode on rmat(8, 8)
    reaches top-10 Jaccard >= 0.9 vs exact while dispatching < 50 % of the
    rounds — and stops at the JAX package's block with its estimate."""
    jgraph, g = jg.rmat_graph(8, 8, seed=3), pg.rmat_graph(8, 8, seed=3)
    kw = dict(batch_size=8, heuristics="h0", sampling="adaptive")
    res = _bc(g, engine_kind="sparse",
              stop_rule=AdaptiveStopRule(top_k=10, window=3, min_blocks=3), **kw)
    assert res.stopped_early
    assert res.rounds_run < 0.5 * len(res.schedule.rounds)
    assert rank_stability(brandes_reference(g), res.bc, k=10) >= 0.9
    assert res.sampling_stats["scale"] > 1.0
    want = jax_bc(jgraph, engine_kind="sparse",
                  stop_rule=jsamp.AdaptiveStopRule(top_k=10, window=3, min_blocks=3), **kw)
    assert res.stop_stats["fired_at_block"] == want.stop_stats["fired_at_block"]
    assert res.sampling_stats == want.sampling_stats
    np.testing.assert_allclose(res.bc, want.bc, **TOL)


def test_adaptive_default_stop_rule():
    g = pg.rmat_graph(8, 8, seed=3)
    res = _bc(g, batch_size=8, sampling="adaptive")
    assert res.stop_stats["rule"] == "adaptive"
    with pytest.raises(ValueError):  # truncation needs the rescale
        _bc(g, stop_rule=BlockBudgetStop(1))


@pytest.mark.parametrize("engine", ["sparse", "fused"])
def test_checkpoint_resume_composes_with_sampling(tmp_path, engine):
    """Rescale and resume commute: the checkpoint holds the raw
    accumulator, so a run killed mid-sample finishes with the
    uninterrupted estimate (and the JAX package's)."""
    kw = dict(batch_size=4, heuristics="h0", engine_kind=engine, sampling="fixed",
              sample_k=12, sample_seed=5)
    g = pg.gnp_graph(36, 0.15, seed=6)
    path = str(tmp_path / "s.npz")
    partial = _bc(g, checkpoint=BCCheckpoint(path), stop_rule=BlockBudgetStop(1), **kw)
    assert partial.stopped_early and 0 < partial.sampling_stats["roots_accumulated"] < 12
    resumed = _bc(g, checkpoint=BCCheckpoint(path), **kw)
    assert not resumed.stopped_early
    assert resumed.sampling_stats["roots_accumulated"] == 12
    np.testing.assert_allclose(resumed.bc, _bc(g, **kw).bc, **TOL)
    want = jax_bc(jg.gnp_graph(36, 0.15, seed=6),
                  **dict(kw, engine_kind="sparse" if engine == "sparse" else "pallas"))
    np.testing.assert_allclose(resumed.bc, want.bc, **TOL)


# ------------------------------------------------------------ the store
def test_query_accounting_is_exhaustive():
    for store in (BCSnapshotStore(), jstore.BCSnapshotStore()):
        assert store.top_k(3) is None and store.score(0) is None
        assert store.publish(np.array([1.0, 3.0, 2.0]), {"tag": "a"}) == 1
        snap, top = store.top_k(2)
        assert snap.generation == 1 and [v for v, _ in top] == [1, 2]
        assert store.score(1)[1] == 3.0
        store.begin_refresh()
        store.top_k(1)  # served, but stale
        store.end_refresh()
        store.top_k(1)
        assert store.stats == {"queries": 6, "hits": 3, "misses": 2, "stale_hits": 1,
                               "publishes": 1}


def test_snapshots_are_isolated_from_caller_mutation():
    store = BCSnapshotStore()
    bc = np.array([1.0, 2.0])
    store.publish(bc)
    bc[0] = 99.0
    assert store.snapshot().bc[0] == 1.0


def test_atomic_swap_under_racing_reader():
    """A racing reader always sees a self-consistent snapshot (all
    entries equal to its generation) and generations never regress."""
    store = BCSnapshotStore()
    stop, bad = threading.Event(), []

    def reader():
        last = 0
        while not stop.is_set():
            res = store.top_k(4)
            if res is None:
                continue
            snap, top = res
            if {score for _, score in top} != {float(snap.generation)}:
                bad.append(f"torn snapshot at generation {snap.generation}")
            if snap.generation < last:
                bad.append(f"generation regressed {last} -> {snap.generation}")
            last = snap.generation

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for gen in range(300):
        store.publish(np.full(512, float(gen + 1)))
    stop.set()
    for t in threads:
        t.join()
    assert not bad, bad[:5]
    st = store.stats
    assert store.generation == 300
    assert st["queries"] == st["hits"] + st["stale_hits"] + st["misses"]


def test_publish_from_checkpoint_rescales_raw_accumulator(tmp_path):
    """N/k recomputed from the committed per-root ledger, as the JAX
    package's store does, on a snapshot either package wrote."""
    raw = np.array([2.0, 0.5, 1.0])
    for name, ckpt_cls in (("p.npz", BCCheckpoint), ("j.npz", JaxBCCheckpoint)):
        ckpt = ckpt_cls(str(tmp_path / name))
        assert BCSnapshotStore().publish_from_checkpoint(ckpt) is None  # cold
        ckpt.save(raw, {3: 4.0, 7: 2.0}, [0, 1], "fp")
        for store in (BCSnapshotStore(), jstore.BCSnapshotStore()):
            assert store.publish_from_checkpoint(BCCheckpoint(ckpt.path), num_eligible=8) == 1
            snap = store.snapshot()
            np.testing.assert_allclose(snap.bc, raw * 4.0)
            assert (snap.meta["roots_accumulated"], snap.meta["scale"],
                    snap.meta["committed_rounds"]) == (2, 4.0, 2)
        unscaled = BCSnapshotStore()
        unscaled.publish_from_checkpoint(ckpt)
        np.testing.assert_allclose(unscaled.snapshot().bc, raw)


# ------------------------------------------------ the serving front end
def test_run_serving_single_device(tmp_path):
    g = pg.gnp_graph(40, 0.15, seed=2)
    out = run_serving(g, None, ckpt_path=str(tmp_path / "s.npz"), batch_size=4,
                      sampling="fixed", sample_frac=1.0, refresh_blocks=2, generations=4,
                      queries=6, top_k=5, device="cpu")
    st = out["stats"]
    assert st["queries"] == st["hits"] + st["stale_hits"] + st["misses"]
    assert st["misses"] >= 1 and st["hits"] >= 1
    gens = [h["generation"] for h in out["history"]]
    assert gens == sorted(gens) and out["generations_published"] >= 2
    assert not out["refresh_runs"][-1]["stopped_early"]
    exact = brandes_reference(g)
    np.testing.assert_allclose(out["final_bc"], exact, **SERVED)
    assert out["final_top_k"] == [int(v) for v in top_k_indices(exact, 5)]
    from repro.launch.serve_bc import run_serving as jax_run_serving

    want = jax_run_serving(jg.gnp_graph(40, 0.15, seed=2), None,
                           ckpt_path=str(tmp_path / "j.npz"), batch_size=4, sampling="fixed",
                           sample_frac=1.0, refresh_blocks=2, generations=4, queries=6,
                           top_k=5)
    np.testing.assert_allclose(out["final_bc"], want["final_bc"], **TOL)
    assert [r["rounds_run"] for r in out["refresh_runs"]] == [
        r["rounds_run"] for r in want["refresh_runs"]]


def test_run_serving_rejects_unsampled_and_needs_a_card(tmp_path, monkeypatch):
    g = pg.gnp_graph(12, 0.3, seed=0)
    with pytest.raises(ValueError):
        run_serving(g, None, ckpt_path=str(tmp_path / "u.npz"), sampling="off", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving(g, None, ckpt_path=str(tmp_path / "u.npz"), sample_frac=1.0)
    assert not os.path.exists(tmp_path / "u.npz")


def test_killed_refresher_resumes_from_committed_generation(tmp_path):
    """The replacement serves the committed generation at once (no cold
    miss, ``resumed`` first) and runs only the remaining rounds."""
    g = pg.gnp_graph(40, 0.15, seed=2)
    path = str(tmp_path / "s.npz")
    kw = dict(batch_size=4, sampling="fixed", sample_frac=1.0)
    partial = _bc(g, heuristics="h0", engine_kind="sparse", checkpoint=BCCheckpoint(path),
                  stop_rule=BlockBudgetStop(2), **kw)
    assert partial.stopped_early
    out = run_serving(g, None, ckpt_path=path, refresh_blocks=2, generations=3, queries=4,
                      top_k=5, device="cpu", **kw)
    assert out["stats"]["misses"] == 0
    assert out["history"][0]["meta"].get("resumed") is True
    total_rounds = -(-eligible_roots(g).size // 4)
    assert sum(r["rounds_run"] for r in out["refresh_runs"]) == total_rounds - partial.rounds_run
    np.testing.assert_allclose(out["final_bc"], brandes_reference(g), **SERVED)


def test_serve_bc_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_bc", "--grid", "6x6",
           "--sample-frac", "1.0", "--device", "cpu", "--ckpt-dir", str(tmp_path),
           "--batch-size", "8", "--engine", "fused", "--generations", "2"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "grid_6x6: n=36" in first.stdout and "served" in first.stdout
    again = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resumed serving from committed snapshot" in again.stderr
    assert "0 misses" in again.stdout
