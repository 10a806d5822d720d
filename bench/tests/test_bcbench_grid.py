"""The grid path (``bench/paths/grid.py``) repeats the calls of the
program's ``launch/steps.py:build_bc_cell`` on the benchmark's own graph.
On the CPU at a small scale, both build the cell of the same R-MAT graph
and seed on one gloo grid: the schedule, the partition's sizes and the
round outputs have to agree exactly, so that the copy cannot drift from
the program unseen."""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from bcbench import harness  # noqa: E402

SCALE = 9


def test_grid_path_builds_what_build_bc_cell_builds():
    from repro_torch.configs.base import BCShape
    from repro_torch.configs.bc_rmat import ARCH
    from repro_torch.configs.registry import ArchBundle
    from repro_torch.distributed.groups import GridGroups
    from repro_torch.launch.steps import build_bc_cell

    cfg = dict(json.loads((BENCH / "configs" / "bc-rmat-s23.json").read_text()), scale=SCALE)
    # the configuration runs the program's registered arch as it stands
    assert (cfg["batch_size"], cfg["heuristics"], cfg["max_levels"], cfg["edge_factor"]) == (
        ARCH.batch_size, ARCH.heuristics, ARCH.max_levels, ARCH.edge_factor)
    assert cfg["scale"] == SCALE and json.loads(
        (BENCH / "configs" / "bc-rmat-s23.json").read_text())["scale"] == ARCH.scale
    grid = harness._load_module(BENCH / "paths" / "grid.py", "bench_path_grid_t")
    graph = harness._graph(cfg, None)
    cell = grid.build(cfg, graph, torch.device("cpu"), harness.Spans())
    try:
        shape = BCShape("small", SCALE, cfg["edge_factor"])
        bundle = ArchBundle(arch=dataclasses.replace(ARCH, scale=SCALE),
                            shapes={shape.name: shape})
        theirs = build_bc_cell(bundle, shape.name, GridGroups(1, 1, 1), device="cpu",
                               seed=cfg["graph_seed"])
        ours, prog = cell.schedule, theirs.schedule
        assert (ours.batch_size, ours.derived_per_round, len(ours.rounds)) == (
            prog.batch_size, prog.derived_per_round, len(prog.rounds))
        for a, b in zip(ours.rounds, prog.rounds):
            np.testing.assert_array_equal(a.sources, b.sources)
            np.testing.assert_array_equal(a.derived, b.derived)
        assert (cell.info["n_pad"], cell.info["chunk"], cell.info["residual_arcs"]) == (
            theirs.partition.n_pad, theirs.partition.chunk, theirs.residual.num_arcs)
        n_rounds = len(ours.rounds)
        for idx in sorted({0, n_rounds // 2, n_rounds - 1}):
            rnd = ours.rounds[idx]
            src = torch.from_numpy(rnd.sources[None])
            der = torch.from_numpy(rnd.derived[None])
            a = cell.round_fn(src, der)
            b = theirs.fn(src, der)
            for x, y in zip(a[:3], b[:3]):
                assert x.shape == y.shape and torch.equal(x, y)
            assert torch.equal(torch.as_tensor(a[3]), torch.as_tensor(b[3]))
        # the benchmark's counter saw the static round's level steps
        assert cell.steps.count == 2 * (2 * cfg["max_levels"] - 1) * len(
            {0, n_rounds // 2, n_rounds - 1})
    finally:
        cell.close()
