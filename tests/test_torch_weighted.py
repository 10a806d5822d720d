"""The port's weighted (bucketed delta-stepping) BC on one device, against
the JAX package and both Dijkstra oracles (``repro``'s and the port's).

The counterparts of tests/test_weighted.py — hand-checked graphs, engine ×
heuristic parity, explicit bucket widths, boundary ties, the validation
gates — plus module-level parity with ``repro`` on the same numpy inputs:
the generators, ``bucket_index``, both operators' ``relax`` /
``sigma_step`` / ``delta_step``, the bucket loops and the weighted round.
Tolerances are the JAX package's: BC rtol 1e-5 / atol 1e-5 (1e-6 on the
hand-checked graphs and the boundary ties), distances and bucket ids
exact (dyadic weights make every f32 distance sum exact), σ rtol 1e-6
(integer path counts), δ rtol 1e-5 / atol 1e-6.  Unit weights at Δ = 1
reproduce the unweighted BC within 1e-6, not bitwise (the JAX package's
bitwise claim fails for its dense engine).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as jg
from repro.core import engine as jengine
from repro.core.bc import betweenness_centrality as jax_bc
from repro.core.brandes_ref import brandes_reference as jax_oracle
from repro.core.driver import traversal_round as jax_round
from repro.core.operators import WeightedDenseOperator as JaxDenseOp
from repro.core.operators import WeightedSparseOperator as JaxSparseOp
from repro.core.operators import auto_delta as jax_auto_delta
from repro.graphs import partition as jpart
from repro.kernels.ops import bucket_index as jax_bucket_index
import repro_torch.graphs as pg
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference, engine
from repro_torch.core.driver import BCDriver, traversal_round
from repro_torch.core.operators import (
    WeightedDenseOperator,
    WeightedSparseOperator,
    auto_delta,
)
from repro_torch.core.scheduler import build_schedule
from repro_torch.graphs import Graph
from repro_torch.graphs import partition as ppart
from repro_torch.graphs.generators import sample_weights
from repro_torch.kernels import ops
from repro_torch.kernels.ref import tiles_to_dense

TOL = dict(rtol=1e-5, atol=1e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")


def _bc(graph, **kw):
    kw.setdefault("batch_size", 8)
    return pbc.betweenness_centrality(graph, device="cpu", **kw)


def _weighted_path(m):
    # 0 -1.0- 1 -2.0- 2: every pair routes through 1 -> BC = [0, 2, 0]
    return m.Graph.from_edges(3, np.array([[0, 1], [1, 2]]),
                              weights=np.array([1.0, 2.0], np.float32))


def _weighted_square(m):
    # a unit square plus a 0-2 chord of weight 2 that ties both two-hop
    # routes: σ(0, 2) = 3.  Hand-derived BC = [1, 2/3, 1, 2/3].
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2]])
    return m.Graph.from_edges(4, edges, weights=np.array([1, 1, 1, 1, 2], np.float32))


def _ties(m):
    # weights ON the light/heavy boundary (w = Δ = 0.5) and distances
    # landing exactly on bucket edges
    edges = np.array([[0, 1], [1, 2], [2, 3], [0, 3], [1, 3]])
    return m.Graph.from_edges(4, edges,
                              weights=np.array([0.5, 0.5, 0.5, 1.0, 1.0], np.float32))


# ------------------------------------------------------------- generators

@pytest.mark.parametrize("mode", ["none", "unit", "dyadic"])
@pytest.mark.parametrize("name,build", [
    ("rmat", lambda m, w: m.rmat_graph(6, 4, seed=3, weights=w)),
    ("road", lambda m, w: m.road_like_graph(5, 6, seed=2, weights=w)),
    ("copy", lambda m, w: m.generators.weighted_copy(m.gnp_graph(20, 0.2, seed=1), w, seed=4)),
])
def test_weighted_generators_are_the_jax_packages(name, build, mode):
    want, got = build(jg, mode), build(pg, mode)
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    assert (got.w is None) == (want.w is None) == (mode == "none")
    assert got.weighted == want.weighted
    if mode != "none":
        np.testing.assert_array_equal(got.w, want.w)
        assert got.w.dtype == np.float32


def test_weights_do_not_change_the_topology():
    plain = pg.rmat_graph(7, 8, seed=1)
    weighted = pg.rmat_graph(7, 8, seed=1, weights="dyadic")
    np.testing.assert_array_equal(plain.src, weighted.src)
    np.testing.assert_array_equal(plain.dst, weighted.dst)


def test_weight_modes_constant():
    assert pg.WEIGHT_MODES == jg.generators.WEIGHT_MODES == ("none", "unit", "dyadic")
    rng = np.random.default_rng(0)
    w = sample_weights(rng, 1000, "dyadic")
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, np.round(w * 4) / 4)  # k/4: exact in f32
    assert w.min() >= 0.25 and w.max() <= 4.0
    np.testing.assert_array_equal(sample_weights(rng, 10, "unit"), 1.0)
    assert sample_weights(rng, 10, "none") is None
    with pytest.raises(ValueError, match="weight"):
        sample_weights(rng, 4, "bogus")


def test_weighted_copy_deterministic():
    g = pg.rmat_graph(5, 3, seed=1)
    a = pg.weighted_copy(g, weights="dyadic", seed=5)
    b = pg.weighted_copy(g, weights="dyadic", seed=5)
    np.testing.assert_array_equal(a.w, b.w)
    assert a.w.min() > 0
    np.testing.assert_array_equal(a.src, g.src)
    np.testing.assert_array_equal(a.dst, g.dst)


def test_weighted_graph_views_match_the_jax_packages():
    want, got = jg.rmat_graph(5, 3, seed=7, weights="dyadic"), pg.rmat_graph(
        5, 3, seed=7, weights="dyadic")
    np.testing.assert_array_equal(got.dense_weights(), want.dense_weights())
    np.testing.assert_array_equal(got.padded_arc_weights(8), want.padded_arc_weights(8))
    for (gn, gw), (wn, ww) in zip(got.weighted_adjacency_lists(),
                                  want.weighted_adjacency_lists()):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gw, ww)
    plain = pg.rmat_graph(5, 3, seed=7)
    for view in (plain.dense_weights, plain.weighted_adjacency_lists,
                 lambda: plain.padded_arc_weights(8)):
        with pytest.raises(ValueError, match="weighted graph"):
            view()


@pytest.mark.parametrize("grid", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_weighted_layouts_are_the_jax_packages(grid):
    """Arc weights in the slot layout, weighted dense blocks, BCSR tiles and
    hybrid layouts equal the JAX package's; the cells built on the device
    (dense, and tiles turned into a block) equal the host blocks."""
    jgraph = jg.road_like_graph(6, 8, seed=1, weights="dyadic")
    pgraph = pg.road_like_graph(6, 8, seed=1, weights="dyadic")
    want, got = jpart.partition_2d(jgraph, *grid), ppart.partition_2d(pgraph, *grid)
    w = pgraph.w
    np.testing.assert_array_equal(got.arc_weights(w), want.arc_weights(w))
    blocks = want.dense_blocks(weights=w)
    np.testing.assert_array_equal(got.dense_blocks(weights=w), blocks)
    bm = ppart.default_tile_dim(got.chunk, preferred=4)
    for field in ("tiles", "tile_rows", "tile_cols", "nnz_tiles"):
        np.testing.assert_array_equal(getattr(got.blocked_sparse(bm, bm, weights=w), field),
                                      getattr(want.blocked_sparse(bm, bm, weights=w), field))
    dense_cells = np.arange(got.R * got.C).reshape(got.R, got.C) % 2 == 0
    hw, hg = (x.blocked_hybrid(bm, bm, dense_cells=dense_cells, weights=w) for x in (want, got))
    np.testing.assert_array_equal(hg.blocks, hw.blocks)
    np.testing.assert_array_equal(hg.sparse.tiles, hw.sparse.tiles)
    m, k = got.C * got.chunk, got.R * got.chunk
    for i in range(got.R):
        for j in range(got.C):
            cell = got.cell_dense_block(i, j, device="cpu", weights=w)
            np.testing.assert_array_equal(cell.numpy(), blocks[i, j])
            tiles, rows, cols = got.cell_blocked_sparse(i, j, bm, bm, device="cpu", weights=w)
            np.testing.assert_array_equal(tiles_to_dense(tiles, rows, cols, m, k).numpy(),
                                          blocks[i, j])


# ----------------------------------------------------------------- oracle

@pytest.mark.parametrize("name,build", [
    ("rmat", lambda m: m.rmat_graph(6, 4, seed=2, weights="dyadic")),
    ("road", lambda m: m.road_like_graph(5, 5, seed=1, weights="dyadic")),
    ("square", _weighted_square),
])
def test_dijkstra_oracle_is_the_jax_packages(name, build):
    want, got = jax_oracle(build(jg)), brandes_reference(build(pg))
    np.testing.assert_array_equal(got, want)
    sources = np.array([0, 3])
    np.testing.assert_array_equal(brandes_reference(build(pg), sources=sources),
                                  jax_oracle(build(jg), sources=sources))


# ----------------------------------------------------------- hand-checked

def test_weighted_path_hand_checked():
    got = _bc(_weighted_path(pg), weighted=True, batch_size=3)
    np.testing.assert_allclose(got.bc, [0.0, 2.0, 0.0], **TIGHT)
    np.testing.assert_allclose(brandes_reference(_weighted_path(pg)), [0.0, 2.0, 0.0])


def test_weighted_square_tie_splitting():
    g = _weighted_square(pg)
    got = _bc(g, weighted=True, batch_size=4)
    np.testing.assert_allclose(got.bc, [1.0, 2.0 / 3.0, 1.0, 2.0 / 3.0], **TIGHT)
    np.testing.assert_allclose(got.bc, brandes_reference(g), **TIGHT)


# ------------------------------------------------- engine × heuristic parity

_JAX_CACHE: dict = {}


def _jax_weighted(name, build, engine_kind, heuristics, **kw):
    key = (name, engine_kind, heuristics, tuple(sorted(kw.items())))
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = np.asarray(jax_bc(build(jg), engine_kind=engine_kind,
                                            heuristics=heuristics, weighted=True, **kw).bc)
    return _JAX_CACHE[key]


def _rmat7(m):
    return m.rmat_graph(5, 3, seed=7, weights="dyadic")


@pytest.mark.parametrize("engine_kind", pbc.ENGINE_KINDS)
@pytest.mark.parametrize("heuristics", pbc.WEIGHTED_HEURISTICS)
def test_weighted_parity_engines_heuristics(engine_kind, heuristics):
    g = _rmat7(pg)
    got = _bc(g, engine_kind=engine_kind, heuristics=heuristics, weighted=True)
    np.testing.assert_allclose(got.bc, brandes_reference(g), **TOL)
    want = _jax_weighted("rmat7", _rmat7, pbc.REFERENCE_ENGINE[engine_kind], heuristics,
                         batch_size=8)
    np.testing.assert_allclose(got.bc, want, **TOL)
    assert got.round_levels and min(got.round_levels) > 0


def _road(m):
    return m.road_like_graph(4, 5, seed=3, weights="dyadic")


@pytest.mark.parametrize("engine_kind", ["sparse", "dense"])
def test_weighted_road_like_parity(engine_kind):
    g = _road(pg)
    got = _bc(g, engine_kind=engine_kind, weighted=True, heuristics="h1")
    np.testing.assert_allclose(got.bc, brandes_reference(g), **TOL)
    np.testing.assert_allclose(
        got.bc, _jax_weighted("road", _road, engine_kind, "h1", batch_size=8), **TOL)


@pytest.mark.parametrize("delta", [0.125, 0.25, 1.0, 8.0])
def test_weighted_explicit_delta_parity(delta):
    """Δ below the minimum weight (a settled front a bucket), at the dyadic
    quantum, and above the maximum (one bucket, a pure fixpoint)."""
    g = pg.rmat_graph(5, 3, seed=9, weights="dyadic")
    got = _bc(g, weighted=True, delta=delta)
    np.testing.assert_allclose(got.bc, brandes_reference(g), **TOL)
    want = _jax_weighted("rmat9", lambda m: m.rmat_graph(5, 3, seed=9, weights="dyadic"),
                         "dense", "h0", delta=delta, batch_size=8)
    np.testing.assert_allclose(got.bc, want, **TOL)


def test_bucket_boundary_ties_agree_across_engines():
    g = _ties(pg)
    ref = brandes_reference(g)
    results = [_bc(g, engine_kind=e, weighted=True, delta=0.5, batch_size=4).bc
               for e in pbc.ENGINE_KINDS]
    for got in results:
        np.testing.assert_allclose(got, ref, **TIGHT)
        np.testing.assert_array_equal(got, results[0])


@pytest.mark.parametrize("engine_kind", pbc.ENGINE_KINDS)
def test_unit_weights_reduce_to_unweighted(engine_kind):
    g = pg.rmat_graph(5, 3, seed=3, weights="unit")
    plain = _bc(Graph(n=g.n, src=g.src, dst=g.dst), engine_kind=engine_kind)
    weighted = _bc(g, engine_kind=engine_kind, weighted=True, delta=1.0)
    np.testing.assert_allclose(weighted.bc, plain.bc, **TIGHT)
    assert weighted.round_levels == plain.round_levels  # buckets are the BFS levels


def test_sampled_weighted_run_rescales_by_n_over_k():
    g = pg.rmat_graph(6, 4, seed=1, weights="dyadic")
    got = _bc(g, weighted=True, sampling="fixed", sample_k=12, sample_seed=3)
    from repro_torch.serving import eligible_roots, plan_sampling

    plan = plan_sampling(eligible_roots(g), "fixed", None, 12, 3)
    want = brandes_reference(g, sources=plan.roots) * plan.scale
    np.testing.assert_allclose(got.bc, want, **TOL)
    assert got.sampling_stats["roots_accumulated"] == 12


# ------------------------------------------------------------------ gates

@pytest.mark.parametrize("kwargs,match", [
    (dict(weighted=True), "edge weights"),  # on an unweighted graph
    (dict(delta=0.5), "weighted=True"),
    (dict(weighted=True, heuristics="h2"), "unit edge lengths"),
    (dict(weighted=True, heuristics="h3"), "unit edge lengths"),
    (dict(weighted=True, heuristics="h3t"), "unit edge lengths"),
    (dict(weighted=True, num_levels=4), "data-dependent"),
    (dict(weighted=True, delta=0.0), "delta"),
    (dict(weighted=True, delta=-1.0), "delta"),
    (dict(weighted=True, delta=float("inf")), "delta"),
    (dict(weighted=True, delta=float("nan")), "delta"),
], ids=["no-weights", "delta-unweighted", "h2", "h3", "h3t", "num_levels", "delta0",
        "delta-neg", "delta-inf", "delta-nan"])
def test_weighted_gates(kwargs, match):
    g = pg.rmat_graph(4, 2, seed=0, weights="none" if kwargs == dict(weighted=True) else "dyadic")
    with pytest.raises(ValueError, match=match):
        _bc(g, batch_size=4, **kwargs)


@pytest.mark.parametrize("bad", [0.0, -0.5, float("inf"), float("nan")])
def test_non_positive_and_non_finite_weights_rejected(bad):
    with pytest.raises(ValueError, match="strictly positive"):
        Graph.from_edges(3, np.array([[0, 1], [1, 2]]), weights=np.array([1.0, bad]))


def test_unweighted_run_ignores_the_weights():
    g = pg.rmat_graph(5, 3, seed=2, weights="dyadic")
    got = _bc(g)
    np.testing.assert_allclose(got.bc, brandes_reference(Graph(n=g.n, src=g.src, dst=g.dst)),
                               **TOL)


def test_auto_delta_deterministic_and_the_jax_packages():
    g1, g2 = pg.rmat_graph(5, 3, seed=42, weights="dyadic"), pg.rmat_graph(
        5, 3, seed=42, weights="dyadic")
    d1 = auto_delta(g1)
    assert d1 == auto_delta(g2) == jax_auto_delta(jg.rmat_graph(5, 3, seed=42, weights="dyadic"))
    assert 0 < d1 < np.inf and d1 >= float(g1.w.min())
    with pytest.raises(ValueError, match="weight"):
        auto_delta(pg.rmat_graph(4, 2, seed=0))


@pytest.mark.parametrize("bad", [0.0, -2.0, float("inf")])
def test_weighted_operators_reject_bad_delta(bad):
    with pytest.raises(ValueError, match="delta"):
        WeightedDenseOperator(torch.ones((3, 3)), bad)
    with pytest.raises(ValueError, match="delta"):
        WeightedSparseOperator(torch.tensor([0]), torch.tensor([1]), torch.tensor([1.0]), 2, bad)


# ------------------------------------------- module-level parity with repro

S = 8  # sources of the module-level cases


def _operators(kind, delta):
    """The same weighted operator in both packages over rmat_graph(5, 3,
    seed=7, dyadic)."""
    g = _rmat7(pg)
    if kind == "sparse":
        src, dst, _ = g.padded_arcs(8)
        w = g.padded_arc_weights(8)
        got = WeightedSparseOperator(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                     torch.from_numpy(w), g.n, delta)
        want = JaxSparseOp(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), g.n, delta)
    else:
        got = WeightedDenseOperator(torch.from_numpy(g.dense_weights()), delta)
        want = JaxDenseOp(jnp.asarray(g.dense_weights()), delta)
    return g, got, want


def _onehot(n):
    return (np.arange(n)[:, None] == np.arange(S)[None, :]).astype(np.float32)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("delta", [0.25, 0.657])
def test_bucket_loops_match_the_jax_packages(kind, delta):
    g, got_op, want_op = _operators(kind, delta)
    onehot = _onehot(g.n)
    fwd = engine.forward_buckets(got_op, torch.from_numpy(onehot))
    jfwd = jengine.forward_buckets(want_op, jnp.asarray(onehot))
    np.testing.assert_array_equal(fwd.dist.numpy(), np.asarray(jfwd.dist))
    np.testing.assert_allclose(fwd.sigma.numpy(), np.asarray(jfwd.sigma), rtol=1e-6)
    omega = np.random.default_rng(7).integers(0, 3, g.n).astype(np.float32)
    max_bucket = int(ops.bucket_index(fwd.dist, delta).max())
    dacc = engine.backward_buckets(got_op, fwd.sigma, fwd.dist, torch.from_numpy(omega),
                                   max_bucket)
    jdacc = jengine.backward_buckets(want_op, jfwd.sigma, jfwd.dist, jnp.asarray(omega),
                                     max_bucket)
    np.testing.assert_allclose(dacc.numpy(), np.asarray(jdacc), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("heavy", [False, True], ids=["light", "heavy"])
def test_operator_steps_match_the_jax_packages(kind, heavy):
    g, got_op, want_op = _operators(kind, 0.5)
    onehot = _onehot(g.n)
    jfwd = jengine.forward_buckets(want_op, jnp.asarray(onehot))
    dist = np.array(jfwd.dist)
    sigma = np.array(jfwd.sigma)
    frontier = (dist >= 0.5) & (dist < 1.5)
    g_op = np.random.default_rng(3).random(dist.shape).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        got_op.relax(t(dist), t(frontier), heavy).numpy(),
        np.asarray(want_op.relax(jnp.asarray(dist), jnp.asarray(frontier), heavy)))
    np.testing.assert_allclose(got_op.sigma_step(t(sigma), t(dist)).numpy(),
                               np.asarray(want_op.sigma_step(jnp.asarray(sigma),
                                                             jnp.asarray(dist))), rtol=1e-6)
    np.testing.assert_allclose(got_op.delta_step(t(g_op), t(dist)).numpy(),
                               np.asarray(want_op.delta_step(jnp.asarray(g_op),
                                                             jnp.asarray(dist))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("delta", [0.25, 0.657, 1.0, 3.0])
def test_bucket_index_matches_the_jax_packages(delta):
    rng = np.random.default_rng(1)
    dist = (rng.integers(0, 200, (50, 7)) * 0.25).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = np.inf
    got = ops.bucket_index(torch.from_numpy(dist), delta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_bucket_index(jnp.asarray(dist),
                                                                            delta)))
    assert (got.numpy()[np.isinf(dist)] == -1).all()


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_weighted_round_matches_the_jax_packages(kind):
    g, got_op, want_op = _operators(kind, 0.25)
    sources = np.array([0, 5, 9, -1, 17, 30, -1, 2], np.int32)
    derived = np.full((4, 3), -1, np.int32)
    omega = np.random.default_rng(7).integers(0, 3, g.n).astype(np.float32)
    got = traversal_round(got_op, torch.from_numpy(sources), torch.from_numpy(derived),
                          torch.from_numpy(omega), integrity="audit")
    want = jax_round(want_op, jnp.asarray(sources), jnp.asarray(derived), jnp.asarray(omega),
                     integrity="audit")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3] == int(want[3])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=1e-5, atol=1e-5)
    assert float(got[4][0]) == 0.0


@pytest.mark.parametrize("kwargs,match", [
    (dict(integrity="checksum"), "level-synchronous"),
    (dict(num_levels=4), "data-dependent"),
])
def test_weighted_round_refuses_level_synchronous_options(kwargs, match):
    _, op, _ = _operators("sparse", 0.5)
    with pytest.raises(ValueError, match=match):
        traversal_round(op, torch.arange(4, dtype=torch.int32),
                        torch.full((2, 3), -1, dtype=torch.int32), torch.zeros(32), **kwargs)


def test_integrity_audit_of_weighted_rounds():
    """``integrity="audit"`` through the driver: every weighted block passes
    the audit (bc-sum claim, zero residual, levels within n + 1) and the BC
    is the oracle's."""
    g = pg.rmat_graph(5, 3, seed=9, weights="dyadic")
    schedule, prep, residual, omega_np = build_schedule(g, batch_size=8)
    op = pbc.make_weighted_operator(residual, "sparse", auto_delta(g), CPU)
    round_fn = pbc.make_round_fn(op, torch.from_numpy(omega_np), integrity="audit")
    res = BCDriver(round_fn, schedule, n=g.n, device=CPU, prep=prep, integrity="audit",
                   max_retries=0).run()
    assert res.recovery_stats["integrity"]["audit_failures"] == 0
    np.testing.assert_allclose(res.bc, brandes_reference(g), **TOL)


_HOST_READS = ("tolist", "item", "__bool__", "__int__", "__float__", "__index__", "numpy")


def test_bucket_trips_count_every_readback(monkeypatch):
    """``BUCKET_TRIPS["readbacks"]`` is every host read of a tensor that a
    weighted round makes, counted independently by wrapping each way a
    tensor reaches the host; no loop reaches its cap."""
    g = _rmat7(pg)
    op = pbc.make_weighted_operator(g, "sparse", auto_delta(g), CPU)
    sources = torch.arange(8, dtype=torch.int32)
    derived = torch.full((2, 3), -1, dtype=torch.int32)
    reads = []
    for name in _HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    engine.reset_bucket_trips()
    out = traversal_round(op, sources, derived, torch.zeros(g.n))
    monkeypatch.undo()
    trips = dict(engine.BUCKET_TRIPS)
    assert trips["forward_buckets"] > 0 and trips["backward_buckets"] >= out[3]
    assert trips["readbacks"] == len(reads) > 0
    assert trips["capped"] == 0
    ops.reset_launches()
    _bc(g, weighted=True)
    assert not any(ops.LAUNCHES.values())  # the weighted path has no kernel


def test_bucket_trips_count_a_capped_loop(monkeypatch):
    """A fixpoint stopped by its trip cap before it converged is counted:
    with a cap of one trip the light-edge relaxation cannot settle a
    multi-hop bucket."""
    g = pg.road_like_graph(4, 4, seed=1, weights="dyadic")
    op = pbc.make_weighted_operator(g, "sparse", 8.0, CPU)
    monkeypatch.setattr(op, "level_cap", lambda: 1)
    engine.reset_bucket_trips()
    traversal_round(op, torch.arange(4, dtype=torch.int32),
                    torch.full((2, 3), -1, dtype=torch.int32), torch.zeros(g.n))
    assert engine.BUCKET_TRIPS["capped"] > 0
