"""The port's 2-D decomposed BC (core/distributed.py) on spawned gloo
grids, against the numpy oracle and the JAX package's distributed path.

Each grid shape (2x4, 4x2 and the 2x2x2 sub-cluster grid) is spawned once
per module: every rank runs all of that grid's cases
(tests/torch_dist_worker.py) and the parametrised tests below assert one
case each.  The JAX side runs on the 8 host devices that conftest.py
provides.  Tolerances are those of the JAX package's own tests: BC rtol
1e-5 / atol 1e-5 against the oracle (1e-6 for the fused engines,
tests/test_dist_bc.py), and for the operator state depth exact, σ rtol
1e-6, δ rtol 1e-5 / atol 1e-6 (tests/test_operators.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.graphs as jg
from repro.core.distributed import distributed_betweenness_centrality as jax_dbc
from repro.core.distributed import one_degree_reduce_distributed as jax_one_degree
from repro.core.heuristics.one_degree import one_degree_reduce as jax_one_degree_host
from repro.launch.mesh import make_mesh
import repro_torch.graphs as pg
from repro_torch.core import brandes_reference
from repro_torch.core.distributed import REFERENCE_DIST_ENGINE
from repro_torch.core.heuristics.one_degree import one_degree_reduce
from repro_torch.distributed import run_gloo
import torch_dist_worker

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")

MESHES = {"2x4": (1, 2, 4), "4x2": (1, 4, 2), "2x2x2": (2, 2, 2)}

# the graphs of tests/test_dist_bc.py and tests/test_operators.py
GRAPHS = {
    "gnp26": lambda m: m.gnp_graph(26, 0.15, seed=0),
    "gnp23": lambda m: m.gnp_graph(23, 0.2, seed=1),
    "gnp25": lambda m: m.gnp_graph(25, 0.15, seed=2),
    "gnp20": lambda m: m.gnp_graph(20, 0.18, seed=7),
    "gnp24": lambda m: m.gnp_graph(24, 0.2, seed=9),
    "road_tree": lambda m: m.road_like_graph(4, 4, spur_fraction=1.0, seed=6),
    "road_spur": lambda m: m.road_like_graph(4, 4, spur_fraction=0.8, seed=3),
    "road4x4": lambda m: m.road_like_graph(4, 4, spur_fraction=0.5, seed=2),
    "rmat6": lambda m: m.rmat_graph(6, 4, seed=5),
    "rmat8_skew": lambda m: m.rmat_graph(8, 8, seed=0),  # tests/test_hybrid.py's mixed mesh
    "multi": lambda m: m.disjoint_union(
        m.path_graph(7), m.star_graph(5), m.gnp_graph(14, 0.2, seed=3)
    ),
}

FUSED_KW = dict(heuristics="h3", batch_size=8)  # tests/test_dist_bc.py's fused cases
SAMPLED_KW = dict(heuristics="h0", batch_size=8, sampling="fixed", sample_k=20, sample_seed=3)

# end-to-end cases: name -> (mesh, graph, port kwargs)
BC_CASES = {
    **{f"2x4-sparse-{h}": ("2x4", "gnp26", dict(heuristics=h)) for h in ("h0", "h1", "h2", "h3")},
    **{f"4x2-sparse-{h}": ("4x2", "gnp23", dict(heuristics=h)) for h in ("h0", "h3")},
    **{f"{mesh}-{e}-h3": (mesh, "gnp26", dict(FUSED_KW, engine_kind=e))
       for mesh in ("2x4", "4x2") for e in ("fused", "fused_bf16")},
    **{f"2x2x2-sparse-{h}": ("2x2x2", "gnp25", dict(heuristics=h)) for h in ("h0", "h3")},
    "2x2x2-fused-h0": ("2x2x2", "gnp25", dict(heuristics="h0", engine_kind="fused")),
    "2x2x2-fused_bf16-h3": ("2x2x2", "gnp25", dict(FUSED_KW, engine_kind="fused_bf16")),
    "2x4-sparse-static-levels": ("2x4", "gnp20", dict(num_levels=22)),
    **{f"2x4-sparse-{h}-tree": ("2x4", "road_tree", dict(heuristics=h)) for h in ("h1t", "h3t")},
    "2x4-sparse-h3-multi": ("2x4", "multi", dict(heuristics="h3")),
    "2x4-sparse-sampled": ("2x4", "rmat6", SAMPLED_KW),
    "2x2x2-fused-sampled": ("2x2x2", "rmat6", dict(SAMPLED_KW, engine_kind="fused")),
    **{f"{mesh}-fused_sparse-h3": (mesh, "gnp26", dict(FUSED_KW, engine_kind="fused_sparse",
                                                       tile=(4, 4)))
       for mesh in ("2x4", "4x2")},
    "2x2x2-fused_sparse-h0": ("2x2x2", "gnp25", dict(heuristics="h0", engine_kind="fused_sparse")),
    "2x4-fused_hybrid-h3": ("2x4", "rmat8_skew", dict(heuristics="h3", batch_size=64,
                                                      engine_kind="fused_hybrid", tile=(8, 8))),
    **{f"2x4-fused_hybrid-threshold{t:g}": ("2x4", "gnp26", dict(
        FUSED_KW, engine_kind="fused_hybrid", tile=(4, 4), hybrid_threshold=t))
       for t in (0.0, 1e9)},
}
STATE_CASES = [(g, e) for g in ("gnp26", "road4x4")
               for e in ("sparse", "fused", "fused_bf16", "fused_sparse")]


def _cases(mesh):
    cases = [(name, "bc", (GRAPHS[g](pg), kw))
             for name, (m, g, kw) in BC_CASES.items() if m == mesh]
    if mesh == "2x4":
        cases += [(f"state-{g}-{e}", "state", (GRAPHS[g](pg), e)) for g, e in STATE_CASES]
        cases += [(f"round-fuse{f}", "round", (GRAPHS["gnp24"](pg), 24, f)) for f in (True, False)]
        cases += [("one_degree", "one_degree", (GRAPHS["road_spur"](pg),))]
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


def _jax_bc(mesh, graph_name, kw):
    shape = MESHES[mesh]
    if shape[0] > 1:
        jmesh = make_mesh(shape, ("pod", "data", "model"))
        kw = dict(kw, replica_axis="pod")
    else:
        jmesh = make_mesh(shape[1:], ("data", "model"))
    if "engine_kind" in kw:
        kw = dict(kw, engine_kind=REFERENCE_DIST_ENGINE[kw["engine_kind"]])
    bc, _ = jax_dbc(GRAPHS[graph_name](jg), jmesh, **kw)
    return np.asarray(bc)


@pytest.mark.parametrize("case", sorted(BC_CASES))
def test_distributed_bc_matches_oracle_and_jax(ranks, case):
    mesh, graph_name, kw = BC_CASES[case]
    got = ranks(mesh)[0][case]
    engine = kw.get("engine_kind", "sparse")
    tol = 1e-6 if engine != "sparse" else 1e-5
    graph = GRAPHS[graph_name](pg)
    assert got["bc"].shape == (graph.n,) and got["bc"].dtype == np.float64
    if "sampling" not in kw:
        np.testing.assert_allclose(got["bc"], brandes_reference(graph), rtol=tol, atol=tol)
    else:
        stats = got["sampling_stats"]
        assert stats["roots_accumulated"] == kw["sample_k"] and stats["scale"] > 1.0
    jtol = 1e-6 if engine in ("fused_sparse", "fused_hybrid") else 1e-5
    np.testing.assert_allclose(got["bc"], _jax_bc(mesh, graph_name, kw), rtol=jtol, atol=jtol)


def test_hybrid_grids_hold_the_cells_they_chose(ranks):
    """The skewed R-MAT grid mixes dense and BCSR cells; thresholds 0 and
    1e9 force every cell dense or every cell BCSR.  Each rank holds only
    its own cell's choice, and a BCSR rank stores its cell's tiles."""
    res = ranks("2x4")[0]
    mixed = np.array(res["2x4-fused_hybrid-h3"]["layout"]["dense_cells"])
    assert 0 < mixed.sum() < mixed.size
    assert np.array(res["2x4-fused_hybrid-threshold0"]["layout"]["dense_cells"]).all()
    forced = res["2x4-fused_hybrid-threshold1e+09"]["layout"]
    assert not np.array(forced["dense_cells"]).any()
    sparse = res["2x4-fused_sparse-h3"]["layout"]
    assert forced["stored_tiles_total"] == sparse["stored_tiles_total"] > 0
    assert sparse["tile"] == (4, 4) and sparse["footprint"]["engine_kind"] == "fused_sparse"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_every_rank_returns_the_same_result(ranks, mesh):
    results = ranks(mesh)
    for name, want in results[0].items():
        for r, res in enumerate(results[1:], start=1):
            got = res[name]
            if isinstance(want, dict):
                np.testing.assert_array_equal(got["bc"], want["bc"], err_msg=f"{name} rank {r}")
                assert got["round_levels"] == want["round_levels"]
            else:
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=f"{name} rank {r}")


def test_subcluster_replicas_split_the_rounds(ranks):
    """fr = 2 replicas take one round each per dispatch block: the rounds
    run equal the schedule's, and every round reports its own depth."""
    got = ranks("2x2x2")[0]["2x2x2-sparse-h0"]
    flat = ranks("2x4")[0]["2x4-sparse-h0"]
    assert got["rounds_run"] == len(got["round_levels"]) >= 2
    assert all(lv > 0 for lv in got["round_levels"]) and flat["rounds_run"] >= 1


def _jax_state(graph_name, engine_kind):
    """tests/test_operators.py's ``_distributed_state`` on a 2x4 mesh."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.core import engine as jengine
    from repro.core.operators import (
        DistributedOperator,
        DistributedPallasOperator,
        DistributedPallasSparseOperator,
    )
    from repro.graphs.partition import partition_2d

    graph = GRAPHS[graph_name](jg)
    R, C = 2, 4
    mesh = make_mesh((R, C), ("data", "model"))
    part = partition_2d(graph, R, C)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: graph.n] = np.random.default_rng(7).integers(0, 3, graph.n)
    sources = jnp.arange(min(torch_dist_worker.S, graph.n), dtype=jnp.int32)
    axes = dict(chunk=part.chunk, R=R, C=C, row_axis="data", col_axis="model")

    def run(op, omega, srcs):
        onehot = (op.row_ids()[:, None] == srcs[None, :]).astype(jnp.float32)
        fwd = jengine.forward_counting(op, onehot)
        delta = jengine.backward_accumulation(op, fwd.sigma, fwd.depth, omega, fwd.max_depth)
        return fwd.sigma, fwd.depth, delta

    if engine_kind == "sparse":
        def body(src_local, dst_local, omega, srcs):
            return run(DistributedOperator(src_local[0, 0], dst_local[0, 0], **axes), omega, srcs)

        graph_args = (jnp.asarray(part.src_local), jnp.asarray(part.dst_local))
        graph_specs = (P("data", "model", None), P("data", "model", None))
    elif engine_kind == "fused_sparse":
        def body(tiles, rows, cols, omega, srcs):
            op = DistributedPallasSparseOperator(tiles[0, 0], rows[0, 0], cols[0, 0],
                                                 interpret=True, **axes)
            return run(op, omega, srcs)

        layout = part.blocked_sparse()
        graph_args = tuple(jnp.asarray(a) for a in (layout.tiles, layout.tile_rows,
                                                    layout.tile_cols))
        graph_specs = (P("data", "model", None, None, None), P("data", "model", None),
                       P("data", "model", None))
    else:
        def body(blocks, omega, srcs):
            op = DistributedPallasOperator(blocks[0, 0], interpret=True, **axes)
            return run(op, omega, srcs)

        dt = jnp.bfloat16 if engine_kind == "fused_bf16" else jnp.float32
        graph_args = (jnp.asarray(part.dense_blocks(np.float32), dt),)
        graph_specs = (P("data", "model", None, None),)
    owner = P(("model", "data"), None)
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=graph_specs + (P(("model", "data")), P()),
                           out_specs=(owner, owner, owner), check_vma=False))
    out = fn(*graph_args, jnp.asarray(omega_pad), sources)
    return tuple(np.asarray(x)[: graph.n] for x in out)


@pytest.mark.parametrize("graph_name,engine_kind", STATE_CASES)
def test_distributed_operator_state_matches_jax(ranks, graph_name, engine_kind):
    sigma, depth, delta = ranks("2x4")[0][f"state-{graph_name}-{engine_kind}"]
    w_sigma, w_depth, w_delta = _jax_state(graph_name, engine_kind)
    np.testing.assert_array_equal(depth, w_depth)
    np.testing.assert_allclose(sigma, w_sigma, rtol=1e-6)
    np.testing.assert_allclose(delta, w_delta, rtol=1e-5, atol=1e-6)


def test_split_backward_payload_matches_fused(ranks):
    res = ranks("2x4")[0]
    np.testing.assert_allclose(res["round-fuseFalse"], res["round-fuseTrue"], rtol=1e-6)
    assert np.abs(res["round-fuseTrue"]).sum() > 0


def test_distributed_one_degree_matches_host(ranks):
    omega, removed = ranks("2x4")[0]["one_degree"]
    graph = GRAPHS["road_spur"](pg)
    host = one_degree_reduce(graph)
    np.testing.assert_array_equal(omega, host.omega)
    # the kept arcs are the residual graph's
    np.testing.assert_array_equal(graph.src[~removed], host.residual.src)
    np.testing.assert_array_equal(graph.dst[~removed], host.residual.dst)
    j_omega, j_removed = jax_one_degree(
        GRAPHS["road_spur"](jg), make_mesh((2, 4), ("data", "model")), ("data", "model")
    )
    np.testing.assert_array_equal(omega, np.asarray(j_omega))
    np.testing.assert_array_equal(removed, np.asarray(j_removed))
    np.testing.assert_array_equal(omega, jax_one_degree_host(GRAPHS["road_spur"](jg)).omega)


@pytest.mark.parametrize("kwargs", [
    dict(overlap="expand"), dict(straggler="steal"), dict(chaos="seed=1"), dict(integrity="audit"),
    dict(autotune="on"), dict(checkpoint="ck"), dict(weighted=True),
], ids=lambda kw: next(iter(kw)))
def test_unported_knobs_raise(kwargs):
    from repro_torch.core.distributed import distributed_betweenness_centrality

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        distributed_betweenness_centrality(GRAPHS["gnp20"](pg), None, device="cpu", **kwargs)


@pytest.mark.parametrize("fr", [2, 3])
def test_dispatch_blocks_pad_the_last_block(fr):
    """BCDriver deals fr rounds per block; a short last block carries
    all-padding lanes that add nothing and report 0 levels."""
    import torch

    from repro_torch.core.bc import make_operator
    from repro_torch.core.driver import BCDriver, traversal_round
    from repro_torch.core.scheduler import build_schedule

    graph = GRAPHS["gnp25"](pg)
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=4, heuristics="h1")
    op = make_operator(residual, "sparse", torch.device("cpu"))
    omega = torch.from_numpy(omega_np.astype(np.float32))
    lanes_seen = []

    def round_fn(sources, derived):
        outs = [traversal_round(op, sources[f], derived[f], omega) for f in range(fr)]
        lanes_seen.append([int((sources[f] >= 0).sum()) for f in range(fr)])
        return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]), [o[3] for o in outs])

    res = BCDriver(round_fn, schedule, n=graph.n, device="cpu", prep=prep,
                   rounds_per_dispatch=fr).run()
    rounds = len(schedule.rounds)
    assert len(lanes_seen) == -(-rounds // fr) and res.rounds_run == rounds
    assert len(res.round_levels) == rounds and all(lv > 0 for lv in res.round_levels)
    if rounds % fr:
        assert lanes_seen[-1][rounds % fr:] == [0] * (fr - rounds % fr)
    np.testing.assert_allclose(res.bc, brandes_reference(graph), rtol=1e-5, atol=1e-5)
