"""The port's CLI (``python -m repro_torch.launch.bc``) on the CPU, against
the numpy oracle (rtol 1e-5 / atol 1e-5) and the JAX launcher's graphs."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.graphs as jg
import repro_torch.graphs as pg
from repro_torch.core import ENGINE_KINDS, brandes_reference
from repro_torch.launch import bc as cli

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", list(ENGINE_KINDS))
def test_cli_engines_match_oracle(engine, tmp_path, capsys):
    out = tmp_path / "bc.npy"
    cli.main(["--grid", "4x5", "--engine", engine, "--heuristics", "h3",
              "--batch-size", "8", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "grid_4x5: n=20" in text and "done in" in text and "GTEPS_bc" in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(4, 5)), **TOL)


def test_cli_sampling_fixed(tmp_path, capsys):
    out = tmp_path / "bc.npy"
    cli.main(["--rmat-scale", "6", "--edge-factor", "4", "--engine", "fused",
              "--sampling", "fixed", "--sample-k", "20", "--device", "cpu",
              "--out", str(out)])
    text = capsys.readouterr().out
    assert "sampling[fixed]: 20/" in text
    assert np.load(out).shape == (64,)


def test_cli_rejects_sample_size_without_sampling():
    with pytest.raises(SystemExit):
        cli.main(["--grid", "3x3", "--sample-k", "4", "--device", "cpu"])


def test_cli_needs_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--grid", "3x3", "--engine", "fused"])


@pytest.mark.parametrize(
    "argv,builder",
    [
        (["--rmat-scale", "6", "--edge-factor", "4"], lambda m: m.rmat_graph(6, 4, seed=1)),
        (["--road", "4x5"], lambda m: m.road_like_graph(4, 5, seed=1)),
    ],
)
def test_cli_graphs_are_the_jax_launchers(argv, builder, tmp_path):
    """Same flags, same seed (1), same graph as ``repro.launch.bc``."""
    jgraph, pgraph = builder(jg), builder(pg)
    np.testing.assert_array_equal(jgraph.src, pgraph.src)
    np.testing.assert_array_equal(jgraph.dst, pgraph.dst)
    out = tmp_path / "bc.npy"
    cli.main(argv + ["--heuristics", "h1", "--device", "cpu", "--out", str(out)])
    np.testing.assert_allclose(np.load(out), brandes_reference(pgraph), **TOL)


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "bc.npy"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bc", "--road", "3x3", "--engine",
         "fused_bf16", "--heuristics", "h3t", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "done in" in proc.stdout
    np.testing.assert_allclose(
        np.load(out), brandes_reference(pg.road_like_graph(3, 3, seed=1)), **TOL
    )


def test_cli_mesh_spawns_a_gloo_grid(tmp_path, capsys):
    """``--mesh 2x2 --device cpu`` spawns four gloo ranks; rank 0's scores
    match the oracle."""
    out = tmp_path / "bc.npy"
    cli.main(["--grid", "4x5", "--mesh", "2x2", "--engine", "fused", "--heuristics", "h3",
              "--batch-size", "8", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "mesh=2x2" in text and "GTEPS_bc" in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(4, 5)), **TOL)


@pytest.mark.parametrize("mesh", ["2", "2x0", "axb", "1x2x3x4"])
def test_cli_rejects_a_malformed_mesh(mesh):
    with pytest.raises(SystemExit):
        cli.main(["--grid", "3x3", "--mesh", mesh, "--device", "cpu"])


def test_cli_mesh_on_the_card_needs_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --standalone --nproc-per-node 8"):
        cli.main(["--grid", "3x3", "--mesh", "2x4"])


def test_cli_mesh_under_torchrun(tmp_path):
    """Under torchrun every rank runs the launcher; rank 0 alone prints
    and writes ``--out``."""
    out = tmp_path / "bc.npy"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.bc", "--road", "3x4", "--mesh", "1x2", "--engine", "sparse",
         "--heuristics", "h3", "--batch-size", "8", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("done in") == 1
    np.testing.assert_allclose(
        np.load(out), brandes_reference(pg.road_like_graph(3, 4, seed=1)), **TOL
    )


@pytest.mark.parametrize("engine,extra,line", [
    ("fused_sparse", ["--tile", "4"], "BCSR tile 4x4: stored tiles max"),
    ("fused_hybrid", ["--hybrid-threshold", "0"], "dense cells [[1, 1, 1, 1], [1, 1, 1, 1]]"),
])
def test_cli_bcsr_engines_on_a_gloo_grid(engine, extra, line, tmp_path, capsys):
    """The BCSR engines run on ``--mesh`` and print the footprint and the
    stored tiles; threshold 0 makes every hybrid cell dense."""
    out = tmp_path / "bc.npy"
    cli.main(["--grid", "4x8", "--mesh", "2x4", "--engine", engine, *extra, "--heuristics", "h3",
              "--batch-size", "8", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert f"per-device footprint ({engine}): adjacency" in text and line in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(4, 8)), **TOL)


@pytest.mark.parametrize("argv", [
    ["--engine", "fused_sparse"],
    ["--engine", "fused_hybrid", "--tile", "4"],
    ["--engine", "fused", "--tile", "4"],
    ["--engine", "fused_sparse", "--mesh", "2x2", "--tile", "4x0"],
    ["--engine", "fused_sparse", "--mesh", "2x2", "--tile", "axb"],
], ids=["no-mesh", "hybrid-no-mesh", "tile-no-mesh", "zero-tile", "malformed-tile"])
def test_cli_rejects_bcsr_flags_without_a_mesh(argv):
    with pytest.raises(SystemExit):
        cli.main(["--grid", "3x3", "--device", "cpu", *argv])


def test_cli_memory_guard_refuses_before_the_run():
    with pytest.raises(RuntimeError, match="MemoryError"):
        cli.main(["--grid", "4x8", "--mesh", "1x2", "--engine", "fused", "--hbm-gb", "1e-6",
                  "--device", "cpu"])


@pytest.mark.parametrize("argv,build", [
    (["--road", "4x5"], lambda m: m.road_like_graph(4, 5, seed=1, weights="dyadic")),
    (["--grid", "4x5", "--mesh", "2x2", "--engine", "fused_sparse", "--tile", "5"],
     lambda m: m.generators.weighted_copy(m.grid_graph(4, 5), "dyadic", seed=1)),
], ids=["road", "grid-mesh"])
def test_cli_weighted_matches_the_dijkstra_oracle(argv, build, tmp_path, capsys):
    """``--weights dyadic --weighted`` scores the JAX launcher's weighted
    graph (same seed) with the bucketed traversal, on one device or a
    spawned gloo grid."""
    jgraph, pgraph = build(jg), build(pg)
    np.testing.assert_array_equal(jgraph.w, pgraph.w)
    out = tmp_path / "bc.npy"
    cli.main(argv + ["--weights", "dyadic", "--weighted", "--batch-size", "8", "--device", "cpu",
                     "--out", str(out)])
    assert "weighted(delta=auto)" in capsys.readouterr().out
    np.testing.assert_allclose(np.load(out), brandes_reference(pgraph), **TOL)


@pytest.mark.parametrize("argv,message", [
    (["--weights", "dyadic", "--delta", "0.5"],
     "--delta sizes the weighted buckets; pass --weighted"),
    (["--weighted"], "--weighted needs edge weights; pass --weights unit|dyadic"),
], ids=["delta-unweighted", "weighted-no-weights"])
def test_cli_weighted_flags_exit_with_the_jax_launchers_message(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        cli.main(["--road", "4x5", "--device", "cpu", *argv])


def test_cli_recovery_flags_parse_with_the_jax_launchers_choices():
    from repro.core.driver import INTEGRITY_MODES, STRAGGLER_POLICIES

    ap = cli.build_parser()
    actions = {a.dest: a for a in ap._actions}
    assert actions["straggler"].choices == list(STRAGGLER_POLICIES)
    assert actions["integrity"].choices == list(INTEGRITY_MODES)
    default = ap.parse_args(["--grid", "3x3"])
    assert (default.straggler, default.straggler_factor, default.integrity,
            default.dispatch_deadline, default.max_retries, default.retry_backoff,
            default.numeric_guard) == ("none", 2.0, "off", None, None, None, False)
    args = ap.parse_args(["--grid", "3x3", "--straggler", "redeal", "--straggler-factor", "3",
                          "--integrity", "checksum", "--dispatch-deadline", "auto",
                          "--max-retries", "1", "--retry-backoff", "0.01", "--numeric-guard"])
    assert (args.straggler, args.straggler_factor, args.integrity, args.dispatch_deadline,
            args.max_retries, args.retry_backoff, args.numeric_guard) == (
        "redeal", 3.0, "checksum", "auto", 1, 0.01, True)


def test_cli_mesh_straggler_steal_runs(tmp_path, capsys):
    """``--mesh 2x2x2 --straggler steal --device cpu`` spawns the eight
    gloo ranks of two replicas; the recovery knobs ride along."""
    out = tmp_path / "bc.npy"
    cli.main(["--grid", "5x5", "--mesh", "2x2x2", "--straggler", "steal", "--integrity", "audit",
              "--dispatch-deadline", "auto", "--max-retries", "1", "--retry-backoff", "0.01",
              "--numeric-guard", "--batch-size", "4", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "mesh=2x2x2 overlap=none straggler=steal" in text
    assert "straggler[steal]:" in text and "1/1 duplicates discarded" in text
    assert "integrity[audit]: 0 checksum + 0 audit failures" in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(5, 5)), **TOL)


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "2x2", "--straggler", "steal"], "replicated --mesh FRxRxC"),
    (["--mesh", "1x2x2", "--straggler", "redeal"], "replicated --mesh FRxRxC"),
    (["--integrity", "audit"], "--integrity audits the distributed round loop"),
    (["--dispatch-deadline", "5"], "--dispatch-deadline arms the distributed"),
    (["--mesh", "2x2", "--dispatch-deadline", "soon"], "takes seconds or 'auto'"),
    (["--mesh", "2x2", "--dispatch-deadline", "0"], "takes positive seconds"),
], ids=["straggler-2d", "straggler-fr1", "integrity-no-mesh", "deadline-no-mesh",
        "deadline-word", "deadline-zero"])
def test_cli_rejects_recovery_flags_it_cannot_honour(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        cli.main(["--grid", "3x3", "--device", "cpu", *argv])


def test_cli_autotune_and_chaos_flags_parse_with_the_jax_launchers_choices():
    from repro.autotune import AUTOTUNE_MODES

    ap = cli.build_parser()
    assert {a.dest: a for a in ap._actions}["autotune"].choices == list(AUTOTUNE_MODES)
    default = ap.parse_args(["--grid", "3x3"])
    assert (default.autotune, default.autotune_cache, default.chaos) == ("off", None, None)


def test_cli_autotune_measure_then_cache(tmp_path, capsys):
    """``--autotune measure --autotune-cache`` times the candidates on the
    gloo grid and records them; a ``cache`` rerun on the file measures
    nothing, picks alike and scores alike."""
    cache = tmp_path / "tune.json"
    argv = ["--rmat-scale", "6", "--edge-factor", "4", "--mesh", "2x2", "--engine",
            "fused_hybrid", "--overlap", "auto", "--batch-size", "8", "--device", "cpu",
            "--autotune-cache", str(cache)]
    scores = {}
    for mode in ("measure", "cache"):
        out = tmp_path / f"{mode}.npy"
        cli.main(argv + ["--autotune", mode, "--out", str(out)])
        text = capsys.readouterr().out
        line = next(ln for ln in text.splitlines() if ln.startswith(f"autotune[{mode}]:"))
        # chunk 16: two tiles, the dense calibration and three policies
        assert ("6 misses, 6 measured" if mode == "measure" else "0 misses, 0 measured") in line
        assert "(measured)" in line and "hybrid calibration measured" in line
        scores[mode] = np.load(out)
    assert cache.exists()
    np.testing.assert_array_equal(scores["cache"], scores["measure"])
    np.testing.assert_allclose(scores["measure"],
                               brandes_reference(pg.rmat_graph(6, 4, seed=1)), **TOL)


def test_cli_chaos_on_a_gloo_mesh(tmp_path, capsys):
    """``--chaos`` on the replicated gloo grid: two transient failures
    retried, the poisoned block recomputed, a replica lost and re-meshed
    around; the recovery line reports it and the scores are exact."""
    out = tmp_path / "bc.npy"
    cli.main(["--grid", "5x5", "--mesh", "2x2x2", "--straggler", "steal", "--chaos",
              "seed=7;transient@1x2;poison@3:nan;kill@5:r1", "--retry-backoff", "0.001",
              "--batch-size", "4", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert ("recovery: 2 retries (2 transient), 1 quarantined, 1 fallback recomputes, "
            "1 re-mesh events (dead replicas [1])") in text
    np.testing.assert_allclose(np.load(out), brandes_reference(pg.grid_graph(5, 5)), **TOL)


@pytest.mark.parametrize("argv,message", [
    (["--autotune", "measure"], "--autotune measures distributed round configs"),
    (["--chaos", "crash@1"], "--chaos injects faults at the distributed round seam"),
], ids=["autotune-no-mesh", "chaos-no-mesh"])
def test_cli_autotune_and_chaos_need_a_mesh(argv, message):
    with pytest.raises(SystemExit, match=re.escape(message)):
        cli.main(["--grid", "3x3", "--device", "cpu", *argv])


def test_cli_single_device_straggler_fails_as_the_entry_point_does():
    with pytest.raises(ValueError, match="no replicas"):
        cli.main(["--grid", "3x3", "--straggler", "steal", "--device", "cpu"])
