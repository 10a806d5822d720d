"""The port's ring-pipelined collective schedules (``overlap="expand"`` /
``"expand+fold"``) and the checked level steps on the 2-D grid, on
spawned gloo grids, against the numpy oracle and the JAX package's ring
path.

Each grid (2x4, 4x2 and the 2x2x2 sub-cluster grid) is spawned once per
module; its ranks run every case of that grid (tests/torch_ring_worker.py)
and the parametrised tests below assert one case each.  The JAX side runs
on conftest's 8 host devices as tests/test_dist_overlap.py runs it, with
its graphs and tolerances: operator state depth exact, σ rtol 1e-6, δ rtol
1e-5 / atol 1e-6; BC within 1e-6 of the oracle and of the barrier run.
The counted collectives (the worker's counter over ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``batch_isend_irecv``) stand in for the JAX
package's HLO check.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import repro.graphs as jg
from repro.compat import shard_map
from repro.core import engine as jengine
from repro.core.distributed import distributed_betweenness_centrality as jax_dbc
from repro.core.operators import (
    DistributedOperator as JaxDistributedOperator,
    DistributedPallasOperator,
    DistributedPallasSparseOperator,
)
from repro.graphs.partition import partition_2d as jax_partition_2d
from repro.launch.mesh import make_mesh
import repro_torch.graphs as pg
from repro_torch.core import brandes_reference
from repro_torch.core.distributed import REFERENCE_DIST_ENGINE
from repro_torch.core.driver import CHECKSUM_TOL
from repro_torch.distributed import run_gloo
import torch_ring_worker

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")

MESHES = {"2x4": (1, 2, 4), "4x2": (1, 4, 2), "2x2x2": (2, 2, 2)}
RINGS = ["expand", "expand+fold"]
POLICIES = ["none"] + RINGS
ENGINES = ["sparse", "fused", "fused_bf16", "fused_sparse", "fused_hybrid"]
STATE_ENGINES = ["sparse", "fused", "fused_bf16", "fused_sparse"]
TOL = dict(rtol=1e-6, atol=1e-6)

# the graphs of tests/test_dist_overlap.py and tests/test_dist_weighted.py
GRAPHS = {
    "gnp26": lambda m: m.gnp_graph(26, 0.15, seed=0),
    "gnp25": lambda m: m.gnp_graph(25, 0.15, seed=2),
    "road_spur": lambda m: m.road_like_graph(4, 4, spur_fraction=0.6, seed=2),
    "divergent": lambda m: m.disjoint_union(m.path_graph(40), m.gnp_graph(16, 0.3, seed=4)),
    "wrmat5": lambda m: m.rmat_graph(5, 3, seed=5, weights="dyadic"),
    "wroad": lambda m: m.road_like_graph(4, 6, seed=2, weights="dyadic"),
}
E2E = dict(heuristics="h3", batch_size=8)  # tests/test_dist_overlap.py's end-to-end cases
TILE = {"fused_sparse": dict(tile=(4, 4)), "fused_hybrid": dict(tile=(4, 4))}  # chunk 4

# end-to-end cases: name -> (mesh, graph, port kwargs)
BC_CASES = {
    **{f"{mesh}-{e}-{ov}": (mesh, "gnp26", dict(E2E, engine_kind=e, overlap=ov,
                                               **TILE.get(e, {})))
       for mesh in ("2x4", "4x2") for e in ENGINES for ov in POLICIES},
    "2x4-sparse-expand-road": ("2x4", "road_spur", dict(heuristics="h3", overlap="expand")),
    "2x4-fused-auto": ("2x4", "gnp26", dict(E2E, engine_kind="fused", overlap="auto")),
    # sub-clusters: tests/test_dist_overlap.py's replica and divergent-depth cases
    "2x2x2-sparse-subcluster": ("2x2x2", "gnp25", dict(heuristics="h1",
                                                       overlap="expand+fold")),
    **{f"2x2x2-sparse-divergent-{ov}": ("2x2x2", "divergent", dict(batch_size=8, overlap=ov))
       for ov in POLICIES},
    # weighted: barrier collectives, replica lockstep (tests/test_dist_weighted.py:71-74)
    "2x2x2-weighted-expand": ("2x2x2", "wrmat5", dict(batch_size=8, weighted=True,
                                                      overlap="expand")),
    # the grid's integrity modes
    **{f"2x4-{e}-{ov}-{mode}": ("2x4", "gnp26", dict(E2E, engine_kind=e, overlap=ov,
                                                     integrity=mode))
       for e in ("sparse", "fused") for ov in ("none", "expand+fold")
       for mode in ("audit", "checksum")},
    # a weighted audit at a Δ whose bucket indices pass n + 1
    "2x4-weighted-audit-small-delta": ("2x4", "wroad", dict(batch_size=16, weighted=True,
                                                            delta=0.05, integrity="audit")),
}
PERTURBED = ("2x4", "gnp26", dict(E2E, engine_kind="fused", overlap="expand+fold",
                                  integrity="checksum"))
# the JAX package's ring runs held against the port's (its overlap= path)
JAX_CASES = [f"{mesh}-{e}-{ov}" for mesh in ("2x4", "4x2") for e in ("sparse", "fused")
             for ov in RINGS] + ["2x2x2-sparse-subcluster", "2x2x2-weighted-expand"] + [
    f"2x2x2-sparse-divergent-{ov}" for ov in RINGS]


def _cases(mesh):
    cases = [(name, "bc", (GRAPHS[g](pg), kw)) for name, (m, g, kw) in BC_CASES.items()
             if m == mesh]
    if mesh in ("2x4", "4x2"):
        cases += [(f"state-{e}-{ov}", "state", (GRAPHS["gnp26"](pg), e, ov))
                  for e in STATE_ENGINES for ov in POLICIES]
    if mesh == "2x4":
        _, g, kw = PERTURBED
        cases += [("perturbed", "perturbed", (GRAPHS[g](pg), kw, 5, 2))]
    return cases


@pytest.fixture(scope="module")
def ranks():
    """mesh name -> every rank's ``{case: result}``, one spawn per grid."""
    cache = {}

    def get(mesh):
        if mesh not in cache:
            cache[mesh] = run_gloo(torch_ring_worker.run_cases, *MESHES[mesh],
                                   (_cases(mesh),), timeout_s=400)
        return cache[mesh]

    return get


def _jax_run(mesh, graph_name, kw, full=False):
    shape = MESHES[mesh]
    if shape[0] > 1:
        jmesh = make_mesh(shape, ("pod", "data", "model"))
        kw = dict(kw, replica_axis="pod")
    else:
        jmesh = make_mesh(shape[1:], ("data", "model"))
    if "engine_kind" in kw:
        kw = dict(kw, engine_kind=REFERENCE_DIST_ENGINE[kw["engine_kind"]])
    return jax_dbc(GRAPHS[graph_name](jg), jmesh, full_result=full, **kw)


# ----------------------------------------------------------- end to end
@pytest.mark.parametrize("case", sorted(n for n in BC_CASES if "-audit" not in n
                                        and "-checksum" not in n))
def test_ring_bc_matches_the_oracle_and_the_barrier_run(ranks, case):
    mesh, graph_name, kw = BC_CASES[case]
    got = ranks(mesh)[0][case]
    graph = GRAPHS[graph_name](pg)
    assert got["bc"].shape == (graph.n,) and got["bc"].dtype == np.float64
    np.testing.assert_allclose(got["bc"], brandes_reference(graph), **TOL)
    if kw.get("overlap") != "auto":
        assert got["overlap"] == kw.get("overlap", "none")
    barrier = case.rsplit("-", 1)[0] + "-none"
    if barrier in BC_CASES and barrier != case:
        np.testing.assert_allclose(got["bc"], ranks(mesh)[0][barrier]["bc"], **TOL)


@pytest.mark.parametrize("case", JAX_CASES)
def test_ring_bc_matches_the_jax_ring_path(ranks, case):
    """The JAX package's ``overlap=`` run of the same graph, grid and
    engine."""
    mesh, graph_name, kw = BC_CASES[case]
    got = ranks(mesh)[0][case]
    bc, _ = _jax_run(mesh, graph_name, kw)
    np.testing.assert_allclose(got["bc"], np.asarray(bc), **TOL)


def test_auto_resolves_to_a_ring_policy_it_logs(ranks):
    assert ranks("2x4")[0]["2x4-fused-auto"]["overlap"] in ("none", "expand", "expand+fold")


@pytest.mark.parametrize("overlap", POLICIES)
def test_divergent_replicas_keep_their_own_depths(ranks, overlap):
    """Lockstep makes the shallow replica run the deep one's level count,
    yet each round still reports its own depth: one more than the deepest
    BFS level of its sources, over the JAX package's schedule of the same
    graph (h0, batch 8)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from repro.core.scheduler import build_schedule

    graph = GRAPHS["divergent"](jg)
    schedule, _, residual, _ = build_schedule(graph, batch_size=8)
    adj = csr_matrix((np.ones(residual.src.size), (residual.src, residual.dst)),
                     shape=(residual.n, residual.n))
    want = []
    for rnd in schedule.rounds:
        dist = shortest_path(adj, unweighted=True, indices=rnd.sources[rnd.sources >= 0])
        want.append(int(dist[np.isfinite(dist)].max()) + 1)
    got = ranks("2x2x2")[0][f"2x2x2-sparse-divergent-{overlap}"]["round_levels"]
    assert got == want and max(want) > 2 * min(want)  # path rounds beside G(n, p) rounds


@pytest.mark.parametrize("overlap", POLICIES)
def test_ring_replicas_run_in_lockstep(ranks, overlap):
    """Under a ring every rank of both replicas runs the same level steps
    (the loop bounds agree over every rank); the barrier schedule lets the
    replica of the shallow rounds stop early."""
    steps = [r[f"2x2x2-sparse-divergent-{overlap}"]["steps"] for r in ranks("2x2x2")]
    replica0, replica1 = steps[:4], steps[4:]
    assert len(set(replica0)) == len(set(replica1)) == 1
    assert (replica0[0] == replica1[0]) == (overlap != "none")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_same_ring_result(ranks, mesh):
    results = ranks(mesh)
    for name, want in results[0].items():
        if name.startswith("state-"):
            continue
        for r, res in enumerate(results[1:], start=1):
            np.testing.assert_array_equal(res[name]["bc"], want["bc"], err_msg=f"{name} {r}")
            assert res[name]["round_levels"] == want["round_levels"]


# ------------------------------------------------------- operator state
def _jax_ring_state(engine_kind, overlap, R, C):
    """tests/test_dist_overlap.py's ``_ring_state``, with the BCSR ring
    layout for ``fused_sparse``."""
    graph = GRAPHS["gnp26"](jg)
    mesh = make_mesh((R, C), ("data", "model"))
    part = jax_partition_2d(graph, R, C)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = np.random.default_rng(7).integers(0, 3, graph.n)
    sources = jnp.arange(min(torch_ring_worker.S, graph.n), dtype=jnp.int32)
    axes = dict(chunk=part.chunk, R=R, C=C, row_axis="data", col_axis="model",
                overlap=overlap)

    def run(op, omega, srcs):
        onehot = ((op.row_ids()[:, None] == srcs[None, :]) & (srcs[None, :] >= 0)
                  ).astype(jnp.float32)
        fwd = jengine.forward_counting(op, onehot)
        delta = jengine.backward_accumulation(op, fwd.sigma, fwd.depth, omega, fwd.max_depth)
        return fwd.sigma, fwd.depth, delta

    if engine_kind == "sparse":
        def body(rs, rd, omega, srcs):
            op = JaxDistributedOperator(None, None, ring_src_local=rs[0, 0],
                                        ring_dst_local=rd[0, 0], **axes)
            return run(op, omega, srcs)

        graph_args = tuple(jnp.asarray(a) for a in part.ring_arcs())
        graph_specs = (P("data", "model", None, None),) * 2
    elif engine_kind == "fused_sparse":
        def body(tiles, rows, cols, omega, srcs):
            op = DistributedPallasSparseOperator(
                ring_tiles=tiles[0, 0], ring_tile_rows=rows[0, 0], ring_tile_cols=cols[0, 0],
                interpret=True, **axes)
            return run(op, omega, srcs)

        lay = part.blocked_sparse(ring=True)
        graph_args = tuple(jnp.asarray(a) for a in (lay.ring_tiles, lay.ring_tile_rows,
                                                    lay.ring_tile_cols))
        graph_specs = (P("data", "model", None, None, None, None),
                       P("data", "model", None, None), P("data", "model", None, None))
    else:
        def body(blocks, omega, srcs):
            return run(DistributedPallasOperator(blocks[0, 0], interpret=True, **axes),
                       omega, srcs)

        dt = jnp.bfloat16 if engine_kind == "fused_bf16" else jnp.float32
        graph_args = (jnp.asarray(part.dense_blocks(np.float32), dt),)
        graph_specs = (P("data", "model", None, None),)
    owner = P(("model", "data"), None)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=graph_specs + (P(("model", "data")), P()),
                           out_specs=(owner, owner, owner), check_vma=False))
    out = fn(*graph_args, jnp.asarray(omega_pad), sources)
    return tuple(np.asarray(x)[: graph.n] for x in out)


@pytest.mark.parametrize("grid", ["2x4", "4x2"])
@pytest.mark.parametrize("overlap", RINGS)
@pytest.mark.parametrize("engine_kind", STATE_ENGINES)
def test_ring_operator_state_matches_jax(ranks, engine_kind, overlap, grid):
    sigma, depth, delta, _, _ = ranks(grid)[0][f"state-{engine_kind}-{overlap}"]
    w_sigma, w_depth, w_delta = _jax_ring_state(engine_kind, overlap, *MESHES[grid][1:])
    np.testing.assert_array_equal(depth, w_depth)
    np.testing.assert_allclose(sigma, w_sigma, rtol=1e-6)
    np.testing.assert_allclose(delta, w_delta, rtol=1e-5, atol=1e-6)
    b_sigma, b_depth, b_delta, _, _ = ranks(grid)[0][f"state-{engine_kind}-none"]
    np.testing.assert_array_equal(depth, b_depth)  # and the port's barrier schedule
    np.testing.assert_allclose(sigma, b_sigma, rtol=1e-6)
    np.testing.assert_allclose(delta, b_delta, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grid", ["2x4", "4x2"])
@pytest.mark.parametrize("overlap", POLICIES)
@pytest.mark.parametrize("engine_kind", ["sparse", "fused"])
def test_counted_collectives_of_each_schedule(ranks, engine_kind, overlap, grid):
    """Barrier: column-group gathers and no hop.  "expand": no gather,
    R − 1 column hops a level, the row reduce-scatters kept.
    "expand+fold": no gather and no reduce-scatter, (R − 1) + (C − 1)
    hops a level."""
    _, R, C = MESHES[grid]
    for rank in ranks(grid):
        *_, counts, levels = rank[f"state-{engine_kind}-{overlap}"]
        assert levels > 0 and "other/gather" not in counts
        gathers = counts.get("column/gather", 0)
        scatters = counts.get("row/reduce_scatter", 0)
        col_hops, row_hops = counts.get("column/hops", 0), counts.get("row/hops", 0)
        if overlap == "none":
            assert gathers > 0 and scatters == levels and col_hops == row_hops == 0
        elif overlap == "expand":
            assert gathers == 0 and col_hops == (R - 1) * levels and row_hops == 0
            assert scatters == levels
        else:
            assert gathers == 0 and scatters == 0
            assert col_hops == (R - 1) * levels and row_hops == (C - 1) * levels


# ------------------------------------------------------- grid integrity
@pytest.mark.parametrize("mode", ["audit", "checksum"])
@pytest.mark.parametrize("overlap", ["none", "expand+fold"])
@pytest.mark.parametrize("engine_kind", ["sparse", "fused"])
def test_grid_integrity_runs_equal_the_unchecked_run(ranks, engine_kind, overlap, mode):
    res = ranks("2x4")[0]
    got = res[f"2x4-{engine_kind}-{overlap}-{mode}"]
    np.testing.assert_allclose(got["bc"], res[f"2x4-{engine_kind}-{overlap}"]["bc"], **TOL)
    integ = got["recovery"]["integrity"]
    assert integ["mode"] == mode and integ["checksum_failures"] == 0
    assert integ["audit_failures"] == 0 and got["recovery"]["quarantined_blocks"] == 0
    if mode == "checksum":
        assert 0.0 <= integ["max_checksum_residual"] < CHECKSUM_TOL


def test_a_perturbed_fold_is_quarantined_once(ranks):
    """One rank adds 5 to its folded t once (rank 5's second fold): the
    checksum lane catches it, the block is re-dispatched once and the BC
    is the unperturbed run's (tests/test_torch_durable.py's one-device
    case, on the grid)."""
    res = ranks("2x4")[0]
    got = res["perturbed"]
    rec = got["recovery"]
    assert rec["quarantined_blocks"] == 1 and rec["retries"] == 1
    assert rec["integrity"]["checksum_failures"] == 1
    assert rec["integrity"]["max_checksum_residual"] > CHECKSUM_TOL
    np.testing.assert_allclose(got["bc"], res["2x4-fused-expand+fold"]["bc"], **TOL)


def test_weighted_grid_audit_holds_rounds_to_the_bucket_bound(ranks):
    """At Δ = 0.05 a round's bucket count passes n + 1, the unweighted
    level bound; the weighted bound ⌈n·w_max/Δ⌉ + 2 quarantines nothing."""
    got = ranks("2x4")[0]["2x4-weighted-audit-small-delta"]
    graph = GRAPHS["wroad"](pg)
    assert max(got["round_levels"]) > graph.n + 1
    assert got["recovery"]["quarantined_blocks"] == 0
    np.testing.assert_allclose(got["bc"], brandes_reference(graph), **TOL)
