"""The multi-ledger straggler loop and the recovery knobs on the port's 2-D
grid: one spawned 2×2×2 gloo grid (two replicas of a 2×2 grid) runs every
case (tests/torch_straggler_worker.py), held against the oracle and the
JAX package's ``distributed_betweenness_centrality(straggler=...)`` on
conftest's 8 host devices (tests/test_straggler.py's mesh), BC within
1e-6.

Every rank runs the driver loop and decides on its own; these tests show
that the ranks decide alike: each ends with the same straggler telemetry,
per-lane ledgers and BC, also when every rank's clock runs at another
speed, and a watchdog trip seen by one rank's clock re-meshes every rank.
A per-lane snapshot the grid wrote (rank 0 alone) resumes on the grid
under another policy and in the JAX package.
"""
import types

import jax
import numpy as np
import pytest

import repro.graphs as jg
from repro.core.distributed import distributed_betweenness_centrality as jax_dbc
from repro.distributed import fault_tolerance as jft
from repro.launch.mesh import make_mesh
import repro_torch.graphs as pg
from repro_torch.core import brandes_reference
from repro_torch.core.distributed import (
    WATCHDOG_MIN_DEADLINE_S,
    WATCHDOG_SAFETY,
    distributed_betweenness_centrality,
    prior_round_seconds,
)
from repro_torch.core.scheduler import build_schedule
from repro_torch.distributed import BCCheckpoint, run_gloo
from repro_torch.graphs.partition import partition_2d
from repro_torch.serving import BlockBudgetStop
import torch_straggler_worker as worker

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")

TOL = dict(rtol=1e-6, atol=1e-6)
BATCH = 8
GRAPH = dict(pairs=4, block=8)  # tests/test_straggler.py's skewed graph: 8 rounds
POLICIES = ["steal", "redeal"]
OVERLAPS = ["none", "expand"]
PARITY = {f"{p}-{ov}": dict(batch_size=BATCH, straggler=p, overlap=ov)
          for p in POLICIES for ov in OVERLAPS}
# one rank's clock jumps 100 s inside the second block's dispatch window
# (its 7th reading: 4 a block under a deadline); no retry budget
WATCHDOG = dict(batch_size=BATCH, straggler="steal", dispatch_deadline_s=50.0, max_retries=0)
KNOBS = dict(batch_size=BATCH, straggler="redeal", straggler_factor=3.0,
             dispatch_deadline_s="auto", max_retries=1, retry_backoff_s=0.01,
             numeric_guard=True, integrity="audit")
CASES = ([(name, kw, None) for name, kw in PARITY.items()]
         + [(f"speed-{p}", dict(batch_size=BATCH, straggler=p), ("speed",)) for p in POLICIES]
         + [("watchdog", WATCHDOG, ("jump", 5, 6)), ("knobs", KNOBS, None)])
# the whole schedule as a "sample" (scale 1), so that a stop rule may cut it
SAMPLED = dict(batch_size=BATCH, sampling="fixed", sample_frac=1.0)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("straggler_grid")
    return {name: str(tmp / f"{name}.npz") for name in ("grid", "for_jax")}


@pytest.fixture(scope="module")
def ranks(snapshots):
    graph = pg.skewed_depth_graph(**GRAPH)
    cases = [(name, graph, kw, spec) for name, kw, spec in CASES]
    # killed after 2 blocks under steal, resumed under redeal; and a
    # partial snapshot left for the JAX package
    cases += [
        ("ckpt-partial", graph, dict(SAMPLED, straggler="steal", stop_rule=BlockBudgetStop(2),
                                     checkpoint=BCCheckpoint(snapshots["grid"])), None),
        ("ckpt-resumed", graph, dict(SAMPLED, straggler="redeal",
                                     checkpoint=BCCheckpoint(snapshots["grid"])), None),
        ("ckpt-for-jax", graph, dict(SAMPLED, straggler="steal", stop_rule=BlockBudgetStop(2),
                                     checkpoint=BCCheckpoint(snapshots["for_jax"])), None),
    ]
    return run_gloo(worker.run_cases, 2, 2, 2, (cases,), timeout_s=300)


@pytest.fixture(scope="module")
def oracle():
    return brandes_reference(pg.skewed_depth_graph(**GRAPH))


@pytest.mark.parametrize("case", sorted(PARITY))
def test_grid_straggler_matches_the_oracle_and_jax(ranks, oracle, case):
    got = ranks[0][case]
    np.testing.assert_allclose(got["bc"], oracle, **TOL)
    kw = PARITY[case]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    want, _ = jax_dbc(jg.skewed_depth_graph(**GRAPH), mesh, replica_axis="pod", **kw)
    np.testing.assert_allclose(got["bc"], np.asarray(want), **TOL)
    assert got["rounds_run"] == 8 and got["overlap"] == kw["overlap"]
    assert sorted(got["round_levels"]) == sorted([8, 2] * 4)
    assert sorted(r for lane in got["ledgers"] for r in lane) == list(range(8))
    stats = got["stats"]
    assert stats["policy"] == kw["straggler"] and sum(stats["per_replica_rounds"]) == 8


@pytest.mark.parametrize("case", [name for name, _, _ in CASES]
                         + ["ckpt-partial", "ckpt-resumed", "ckpt-for-jax"])
def test_every_rank_ends_with_the_same_decisions(ranks, case):
    """The block walls every rank decides on are the max over the ranks:
    telemetry, ledgers and BC agree on all 8 ranks, bit for bit — under
    ``speed-*`` although each rank's clock runs at its own speed."""
    want = ranks[0][case]
    for other in ranks[1:]:
        got = other[case]
        np.testing.assert_array_equal(got["bc"], want["bc"])
        assert got["stats"] == want["stats"]
        assert got["ledgers"] == want["ledgers"]
        assert got["recovery"] == want["recovery"]
        assert got["round_levels"] == want["round_levels"]


@pytest.mark.parametrize("policy", POLICIES)
def test_rank_skewed_clocks_keep_the_answer(ranks, oracle, policy):
    got = ranks[0][f"speed-{policy}"]
    np.testing.assert_allclose(got["bc"], oracle, **TOL)
    assert got["rounds_run"] == 8 and got["blocks"] >= 4
    assert sum(got["stats"]["per_replica_wall_s"]) > 0


def test_one_ranks_stall_re_meshes_every_rank(ranks, oracle):
    """Only rank 5's clock sees the stall; the elapsed time is agreed, so
    every rank trips, escalates (no budget) and loses the same replica."""
    for r in ranks:
        got = r["watchdog"]
        rec = got["recovery"]
        assert rec["remesh_events"] == 1 and len(rec["dead_replicas"]) == 1
        assert (rec["integrity"]["watchdog_trips"],
                rec["integrity"]["watchdog_escalations"]) == (1, 1)
        np.testing.assert_allclose(got["bc"], oracle, **TOL)
        assert got["rounds_run"] == 8
        dead = rec["dead_replicas"][0]
        assert got["ledgers"][dead] == [] and got["stats"]["per_replica_rounds"][1 - dead] >= 5


def test_auto_deadline_and_the_knobs_reach_the_driver(ranks, oracle):
    got = ranks[0]["knobs"]
    np.testing.assert_allclose(got["bc"], oracle, **TOL)
    _, _, residual, _ = build_schedule(pg.skewed_depth_graph(**GRAPH), batch_size=BATCH)
    prior = prior_round_seconds(partition_2d(residual, 2, 2), "sparse", BATCH, "none")
    knobs = got["knobs"]
    assert knobs["prior_round_s"] == pytest.approx(prior, rel=1e-12) and prior > 0
    assert knobs["dispatch_deadline_s"] == max(WATCHDOG_MIN_DEADLINE_S, WATCHDOG_SAFETY * prior)
    assert (knobs["straggler"], knobs["straggler_factor"], knobs["max_retries"],
            knobs["retry_backoff_s"], knobs["numeric_guard"], knobs["fr"]) == (
        "redeal", 3.0, 1, 0.01, True, 2)
    assert knobs["mesh_shape"] == (2, 2, 2) and knobs["mesh_axes"] == ("pod", "data", "model")
    assert got["recovery"]["integrity"]["watchdog_trips"] == 0
    # without the knob the watchdog stays off
    assert ranks[0]["speed-steal"]["knobs"]["dispatch_deadline_s"] is None


def test_a_grid_without_replicas_refuses_a_straggler_policy():
    """fr = 1 (a 2×4 grid): the check comes before any collective, as does
    the check of a chaos plan (a kill names its replica; a plan's kill on
    an fr = 1 grid is refused at run time, tests/test_torch_chaos.py)."""
    groups = types.SimpleNamespace(fr=1, R=2, C=4)
    with pytest.raises(ValueError, match="replicas"):
        distributed_betweenness_centrality(pg.gnp_graph(16, 0.3, seed=0), groups,
                                           straggler="redeal", device="cpu")
    with pytest.raises(ValueError, match="kill needs a replica"):
        distributed_betweenness_centrality(pg.gnp_graph(16, 0.3, seed=0), groups,
                                           chaos="seed=1;kill@1", device="cpu")


def test_grid_per_lane_snapshot_resumes_under_another_policy(ranks, oracle, snapshots):
    """Rank 0 wrote the two replicas' ledgers after 2 blocks; every rank
    loaded the same sets and ran only the 4 rounds left."""
    partial, resumed = ranks[0]["ckpt-partial"], ranks[0]["ckpt-resumed"]
    assert partial["rounds_run"] == 4 and len(partial["ledgers"]) == 2
    assert resumed["rounds_run"] == 4 and resumed["recovery"]["resumed_generation"] == 0
    np.testing.assert_allclose(resumed["bc"], oracle, **TOL)
    by_lane = BCCheckpoint(snapshots["grid"]).load_namespaced()[2]
    assert by_lane == resumed["ledgers"] and sorted(sum(by_lane, [])) == list(range(8))


def test_jax_resumes_the_grids_per_lane_snapshot(ranks, oracle, snapshots):
    by_lane = jft.BCCheckpoint(snapshots["for_jax"]).load_namespaced()[2]
    assert by_lane == ranks[0]["ckpt-for-jax"]["ledgers"] and sum(map(len, by_lane)) == 4
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    res = jax_dbc(jg.skewed_depth_graph(**GRAPH), mesh, replica_axis="pod", straggler="redeal",
                  checkpoint=jft.BCCheckpoint(snapshots["for_jax"]), full_result=True, **SAMPLED)
    assert res.rounds_run == 4
    np.testing.assert_allclose(res.bc, oracle, **TOL)
