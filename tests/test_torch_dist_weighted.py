"""The port's weighted (bucketed delta-stepping) BC on spawned gloo grids
(2x4, 4x2 and the 2x2x2 sub-cluster grid), against the Dijkstra oracle.

Each grid is spawned once for the module; its ranks run every case of
that grid (tests/torch_dist_worker.py) and the parametrised tests assert
one case each.  Every distributed engine runs weighted: ``sparse`` on the
arc list with its weights, the fused engines on the dense f32 weight block
(``fused_sparse`` and ``fused_hybrid`` turn their weighted tiles into it).
Tolerances: BC rtol 1e-5 / atol 1e-5 against the oracle; the grid's bucket
state against the single-device operator's with distances exact, σ rtol
1e-6 and δ rtol 1e-5 / atol 1e-6; unit weights at Δ = 1 against the
unweighted grid run within 1e-6 (tests/test_torch_weighted.py holds the
single-device operators against the JAX package's).
"""
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.distributed import weighted_prior_levels as jax_prior_levels
import repro_torch.graphs as pg
from repro_torch.core import brandes_reference, engine
from repro_torch.core.distributed import (
    PRIOR_LEVELS,
    distributed_betweenness_centrality,
    weighted_prior_levels,
)
from repro_torch.core.operators import WeightedSparseOperator
from repro_torch.distributed import GridGroups, run_gloo
from repro_torch.kernels.ops import bucket_index
import torch_dist_worker

MESHES = {"2x4": (1, 2, 4), "4x2": (1, 4, 2), "2x2x2": (2, 2, 2)}
TOL = dict(rtol=1e-5, atol=1e-5)

GRAPHS = {
    "rmat7": lambda: pg.rmat_graph(5, 3, seed=7, weights="dyadic"),
    "rmat11": lambda: pg.rmat_graph(5, 3, seed=11, weights="dyadic"),
    "rmat5": lambda: pg.rmat_graph(5, 3, seed=5, weights="dyadic"),
    "rmat3": lambda: pg.rmat_graph(5, 3, seed=3, weights="dyadic"),
    "road": lambda: pg.road_like_graph(4, 6, seed=2, weights="dyadic"),
    "unit": lambda: pg.rmat_graph(5, 3, seed=3, weights="unit"),
    "unit_bare": lambda: pg.rmat_graph(5, 3, seed=3),
}
KW = dict(batch_size=16, weighted=True)
TILED = dict(tile=(4, 4))  # chunk 4 on an 8-rank grid of a 32-vertex graph

# end-to-end cases: name -> (mesh, graph, kwargs)
BC_CASES = {
    **{f"2x4-{e}": ("2x4", "rmat7", dict(KW, engine_kind=e))
       for e in ("sparse", "fused", "fused_bf16")},
    "2x4-fused_sparse": ("2x4", "rmat7", dict(KW, engine_kind="fused_sparse", **TILED)),
    "2x4-fused_hybrid": ("2x4", "rmat7", dict(KW, engine_kind="fused_hybrid", **TILED)),
    "2x4-sparse-h1": ("2x4", "rmat3", dict(KW, engine_kind="sparse", heuristics="h1")),
    "2x4-fused_sparse-road-delta0.5": ("2x4", "road", dict(KW, engine_kind="fused_sparse",
                                                           delta=0.5)),
    **{f"4x2-{e}": ("4x2", "rmat11", dict(KW, engine_kind=e, **(TILED if "_" in e else {})))
       for e in ("sparse", "fused", "fused_sparse", "fused_hybrid")},
    **{f"2x2x2-{e}": ("2x2x2", "rmat5", dict(KW, engine_kind=e, **(TILED if "_" in e else {})))
       for e in ("sparse", "fused", "fused_sparse", "fused_hybrid")},
}
# unit weights at Δ = 1 and the same graph unweighted, on the 2x4 grid
UNIT_CASES = {
    f"unit-{e}": (dict(batch_size=16, engine_kind=e, weighted=True, delta=1.0),
                  dict(batch_size=16, engine_kind=e))
    for e in ("sparse", "fused")
}
STATE_CASES = ["sparse", "fused"]


def _cases(mesh):
    cases = [(name, "bc", (GRAPHS[g](), kw)) for name, (m, g, kw) in BC_CASES.items()
             if m == mesh]
    if mesh == "2x4":
        for name, (wkw, ukw) in UNIT_CASES.items():
            cases += [(name, "bc", (GRAPHS["unit"](), wkw)),
                      (name + "-bare", "bc", (GRAPHS["unit_bare"](), ukw))]
        cases += [(f"wstate-{e}", "wstate", (GRAPHS["rmat7"](), e, 0.5)) for e in STATE_CASES]
        cases += [("wchecksum", "wchecksum", (GRAPHS["rmat7"](),))]
    return cases


@pytest.fixture(scope="module")
def ranks():
    """mesh name -> every rank's ``{case: result}``, one spawn per grid."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            cache[mesh] = run_gloo(torch_dist_worker.run_cases, *MESHES[mesh],
                                   (_cases(mesh),), timeout_s=300)
        return cache[mesh]

    return get


@pytest.mark.parametrize("case", sorted(BC_CASES))
def test_weighted_grid_bc_matches_the_dijkstra_oracle(ranks, case):
    mesh, graph_name, kw = BC_CASES[case]
    got = ranks(mesh)[0][case]
    graph = GRAPHS[graph_name]()
    assert got["bc"].shape == (graph.n,) and got["bc"].dtype == np.float64
    np.testing.assert_allclose(got["bc"], brandes_reference(graph), **TOL)
    assert got["round_levels"] and min(got["round_levels"]) > 0  # buckets per round


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_same_weighted_result(ranks, mesh):
    results = ranks(mesh)
    for name, want in results[0].items():
        for r, res in enumerate(results[1:], start=1):
            got = res[name]
            if isinstance(want, dict):
                np.testing.assert_array_equal(got["bc"], want["bc"], err_msg=f"{name} rank {r}")
                assert got["round_levels"] == want["round_levels"]
            elif isinstance(want, tuple):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {r}")
            else:
                assert got == want


def test_weighted_engines_agree_on_the_buckets(ranks):
    """Every engine of a grid visits the same buckets per round."""
    for mesh in MESHES:
        levels = {name: res["round_levels"] for name, res in ranks(mesh)[0].items()
                  if name in BC_CASES and BC_CASES[name][1] == BC_CASES[f"{mesh}-sparse"][1]}
        assert len(set(map(tuple, levels.values()))) == 1, levels


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_weights_match_the_unweighted_grid_run(ranks, case):
    res = ranks("2x4")[0]
    weighted, bare = res[case], res[case + "-bare"]
    np.testing.assert_allclose(weighted["bc"], bare["bc"], rtol=1e-6, atol=1e-6)
    assert weighted["round_levels"] == bare["round_levels"]


@pytest.mark.parametrize("engine_kind", STATE_CASES)
def test_weighted_grid_state_matches_one_device(ranks, engine_kind):
    sigma, dist, delta = ranks("2x4")[0][f"wstate-{engine_kind}"]
    g = GRAPHS["rmat7"]()
    src, dst, _ = g.padded_arcs(8)
    op = WeightedSparseOperator(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                torch.from_numpy(g.padded_arc_weights(8)), g.n, 0.5)
    onehot = (np.arange(g.n)[:, None] == np.arange(torch_dist_worker.S)[None, :])
    fwd = engine.forward_buckets(op, torch.from_numpy(onehot.astype(np.float32)))
    omega = np.random.default_rng(7).integers(0, 3, g.n).astype(np.float32)
    max_bucket = int(bucket_index(fwd.dist, 0.5).max())
    want_delta = engine.backward_buckets(op, fwd.sigma, fwd.dist, torch.from_numpy(omega),
                                         max_bucket)
    np.testing.assert_array_equal(dist, fwd.dist.numpy())
    np.testing.assert_allclose(sigma, fwd.sigma.numpy(), rtol=1e-6)
    np.testing.assert_allclose(delta, want_delta.numpy(), rtol=1e-5, atol=1e-6)


def test_weighted_grid_round_refuses_the_checksum_lane(ranks):
    assert "level-synchronous" in ranks("2x4")[0]["wchecksum"]


@pytest.mark.parametrize("weights,kwargs,error,match", [
    ("dyadic", dict(weighted=True, integrity="checksum"), ValueError, "level-synchronous"),
    ("dyadic", dict(weighted=True, overlap="expand"), None, None),
    ("none", dict(weighted=True), ValueError, "edge weights"),
    ("dyadic", dict(delta=0.5), ValueError, "weighted=True"),
    ("dyadic", dict(weighted=True, heuristics="h3"), ValueError, "unit edge lengths"),
    ("dyadic", dict(weighted=True, num_levels=8), ValueError, "data-dependent"),
], ids=["checksum", "ring", "no-weights", "delta-unweighted", "h3", "num_levels"])
def test_weighted_grid_gates(weights, kwargs, error, match):
    """The weighted checks on a one-rank gloo group, before any
    collective: the checksum lane is refused with the JAX package's
    ``ValueError`` (weighted rounds take ``integrity="audit"``); a ring
    policy runs, on the barrier collectives, and matches the Dijkstra
    oracle."""
    graph = pg.rmat_graph(4, 2, seed=0, weights=weights)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "s"), 1),
                                rank=0, world_size=1)
        try:
            if error is None:
                bc, _ = distributed_betweenness_centrality(graph, GridGroups(1, 1, 1),
                                                           device="cpu", **kwargs)
            else:
                with pytest.raises(error, match=match):
                    distributed_betweenness_centrality(graph, GridGroups(1, 1, 1), device="cpu",
                                                       **kwargs)
        finally:
            dist.destroy_process_group()
    if error is None:
        np.testing.assert_allclose(bc, brandes_reference(graph), **TOL)


@pytest.mark.parametrize("delta", [0.1, 0.25, 0.657, 2.5, 100.0])
def test_weighted_prior_levels_is_the_jax_packages(delta):
    w = pg.rmat_graph(6, 4, seed=1, weights="dyadic").w
    assert weighted_prior_levels(w, delta) == jax_prior_levels(w, delta)
    assert weighted_prior_levels(w, delta) >= PRIOR_LEVELS
    assert weighted_prior_levels(np.zeros(0, np.float32), 1.0) == PRIOR_LEVELS
