"""The port's CLI (``python -m repro_torch.launch.bc``) on the CPU, against
the numpy oracle (rtol 1e-5 / atol 1e-5) and the JAX launcher's graphs."""
import os
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
