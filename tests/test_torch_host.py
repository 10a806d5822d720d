"""The port's host side against the JAX package's: generators, the
1-degree reduction, the 2-degree claim and derivation, the round
scheduler, the sampling plan and the oracle — all exact equality, since
both sides are the same numpy arithmetic on the same seeds — plus the
state carried across (interop) and the import boundary of the port."""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import brandes_ref as jbrandes
from repro.core import scheduler as jsched
from repro.core.heuristics import one_degree as jone
from repro.core.heuristics import two_degree as jtwo
from repro.serving import sampling as jsamp
import repro_torch.graphs as pg
from repro_torch import interop
from repro_torch.core import brandes_ref as pbrandes
from repro_torch.core import scheduler as psched
from repro_torch.core.heuristics import one_degree as pone
from repro_torch.core.heuristics import two_degree as ptwo
from repro_torch.distributed import RoundLedger
from repro_torch.serving import sampling as psamp

REPO = Path(__file__).resolve().parents[1]

# the tests/test_bc_core.py families, as (name, builder(graphs module))
FAMILIES = {
    "path9": lambda m: m.path_graph(9),
    "cycle5": lambda m: m.cycle_graph(5),
    "cycle13": lambda m: m.cycle_graph(13),
    "star7": lambda m: m.star_graph(7),
    "complete6": lambda m: m.complete_graph(6),
    "grid4x5": lambda m: m.grid_graph(4, 5),
    "gnp24_s0": lambda m: m.gnp_graph(24, 0.12, seed=0),
    "gnp24_s2": lambda m: m.gnp_graph(24, 0.12, seed=2),
    "rmat6": lambda m: m.rmat_graph(6, 4, seed=3),
    "road4x4": lambda m: m.road_like_graph(4, 4, spur_fraction=0.5, seed=1),
    "multi": lambda m: m.disjoint_union(
        m.path_graph(6), m.star_graph(4), m.cycle_graph(5), m.gnp_graph(12, 0.2, seed=7)
    ),
    "k2s": lambda m: m.disjoint_union(m.path_graph(2), m.path_graph(2), m.path_graph(5)),
    "isolated": lambda m: m.disjoint_union(
        m.gnp_graph(10, 0.25, seed=9), m.path_graph(1), m.path_graph(1)
    ),
    "suburb": lambda m: m.suburb_graph(5, 5, leaf_fraction=0.6, seed=2),
    "sparse_gnp": lambda m: m.gnp_graph(26, 0.08, seed=1),
    "skewed": lambda m: m.skewed_depth_graph(2, 5),
}


def _pair(name):
    return FAMILIES[name](jg), FAMILIES[name](pg)


def _assert_graph_equal(jgraph, pgraph):
    assert jgraph.n == pgraph.n
    np.testing.assert_array_equal(jgraph.src, pgraph.src)
    np.testing.assert_array_equal(jgraph.dst, pgraph.dst)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generators_match_jax(family):
    _assert_graph_equal(*_pair(family))


@pytest.mark.parametrize("family", ["multi", "k2s", "isolated"])
def test_connected_components_match_jax(family):
    jgraph, pgraph = _pair(family)
    np.testing.assert_array_equal(
        pgraph.connected_components(), jgraph.connected_components()
    )


def test_paper_rmat_matches_jax():
    """The chip smoke test's full-width graph (the CLI's seed)."""
    _assert_graph_equal(jg.rmat_graph(10, 16, seed=1), pg.rmat_graph(10, 16, seed=1))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("exhaustive", [False, True])
def test_one_degree_reduce_matches_jax(family, exhaustive):
    jgraph, pgraph = _pair(family)
    want = jone.one_degree_reduce(jgraph, exhaustive=exhaustive)
    got = pone.one_degree_reduce(pgraph, exhaustive=exhaustive)
    _assert_graph_equal(want.residual, got.residual)
    for field in ("omega", "pair_credit", "weight", "parent", "removed"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.num_removed, got.iterations) == (want.num_removed, want.iterations)
    for u in np.nonzero(want.removed)[0]:
        assert got.resolve_root(int(u)) == want.resolve_root(int(u))
    S, P = want.omega, want.pair_credit
    np.testing.assert_array_equal(
        pone.leaf_correction(S, 7.0, P), jone.leaf_correction(S, 7.0, P)
    )


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_claim_two_degree_matches_jax(family):
    jgraph, pgraph = _pair(family)
    deg = pgraph.degrees()
    eligible = deg >= 1
    assert ptwo.claim_two_degree(deg, pgraph.adjacency_lists(), eligible) == (
        jtwo.claim_two_degree(deg, jgraph.adjacency_lists(), eligible)
    )


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("heuristics", list(psched.HEURISTICS_MODES))
def test_build_schedule_matches_jax(family, heuristics):
    jgraph, pgraph = _pair(family)
    jsch, jprep, jres, jomega = jsched.build_schedule(jgraph, batch_size=8, heuristics=heuristics)
    psch, pprep, pres, pomega = psched.build_schedule(pgraph, batch_size=8, heuristics=heuristics)
    assert len(psch.rounds) == len(jsch.rounds)
    for pr, jr in zip(psch.rounds, jsch.rounds):
        np.testing.assert_array_equal(pr.sources, jr.sources)
        np.testing.assert_array_equal(pr.derived, jr.derived)
    for field in ("batch_size", "derived_per_round", "num_explicit", "num_derived",
                  "num_leaf_skipped", "num_isolated_omega"):
        assert getattr(psch, field) == getattr(jsch, field), field
    np.testing.assert_array_equal(psch.analytic_corrections, jsch.analytic_corrections)
    np.testing.assert_array_equal(pomega, jomega)
    _assert_graph_equal(jres, pres)
    assert (pprep is None) == (jprep is None)


@pytest.mark.parametrize("family", ["road4x4", "skewed", "multi"])
def test_eccentricity_order_matches_jax(family):
    jgraph, pgraph = _pair(family)
    jsch = jsched.build_schedule(jgraph, batch_size=4, root_order="eccentricity")[0]
    psch = psched.build_schedule(pgraph, batch_size=4, root_order="eccentricity")[0]
    np.testing.assert_array_equal(psch.round_depths, jsch.round_depths)
    for pr, jr in zip(psch.rounds, jsch.rounds):
        np.testing.assert_array_equal(pr.sources, jr.sources)
    np.testing.assert_array_equal(
        psched.estimate_eccentricities(pgraph, seed=3),
        jsched.estimate_eccentricities(jgraph, seed=3),
    )


def test_validate_batch_size_rejects_empty_batch():
    with pytest.raises(ValueError, match="batch_size"):
        psched.validate_batch_size(0)
    assert psched.validate_batch_size(128) == 128


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derive_two_degree_columns_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, s, k = 20, 6, 4
    sigma = rng.integers(0, 4, size=(n, s)).astype(np.float32)
    depth = rng.integers(-1, 5, size=(n, s)).astype(np.int32)
    derived = np.stack(
        [rng.integers(0, n, k), rng.integers(0, s, k), rng.integers(0, s, k)], axis=1
    ).astype(np.int32)
    derived[-1] = -1  # a padding row
    want_s, want_d = jtwo.derive_two_degree_columns(
        jnp.asarray(sigma), jnp.asarray(depth), jnp.asarray(derived)
    )
    got_s, got_d = ptwo.derive_two_degree_columns(
        torch.from_numpy(sigma), torch.from_numpy(depth), torch.from_numpy(derived)
    )
    assert got_s.dtype == torch.float32 and got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("size", [("k", 7), ("k", 30), ("frac", 0.25), ("frac", 1.0)])
def test_plan_sampling_matches_jax(seed, size):
    graph = pg.gnp_graph(40, 0.1, seed=seed)
    eligible = psamp.eligible_roots(graph)
    np.testing.assert_array_equal(eligible, jsamp.eligible_roots(graph))
    kw = {"sample_k": size[1]} if size[0] == "k" else {"sample_frac": size[1]}
    want = jsamp.plan_sampling(eligible, "fixed", seed=seed, **kw)
    got = psamp.plan_sampling(eligible, "fixed", seed=seed, **kw)
    assert (got.k, got.num_eligible, got.scale) == (want.k, want.num_eligible, want.scale)
    if want.roots is None:
        assert got.roots is None
    else:
        np.testing.assert_array_equal(got.roots, want.roots)


def test_adaptive_sampling_is_not_ported():
    """Adaptive sampling is ported now: it draws the fixed plan (the stop
    rule is the driver's), as the JAX package does; unknown modes raise."""
    want = jsamp.plan_sampling(np.arange(10), "adaptive", sample_k=4, seed=3)
    got = psamp.plan_sampling(np.arange(10), "adaptive", sample_k=4, seed=3)
    assert got.mode == want.mode == "adaptive"
    np.testing.assert_array_equal(got.roots, want.roots)
    with pytest.raises(ValueError):
        psamp.normalize_sampling("bogus")


@pytest.mark.parametrize("family", ["path9", "grid4x5", "multi", "road4x4"])
def test_brandes_reference_matches_jax(family):
    jgraph, pgraph = _pair(family)
    np.testing.assert_allclose(
        pbrandes.brandes_reference(pgraph), jbrandes.brandes_reference(jgraph), rtol=1e-12
    )


@pytest.mark.parametrize("family", ["suburb", "multi"])
def test_interop_carries_graph_and_schedule(family):
    jgraph, pgraph = _pair(family)
    carried = interop.graph_from_arrays(jgraph.n, jgraph.src, jgraph.dst, jgraph.w)
    _assert_graph_equal(pgraph, carried)
    jsch = jsched.build_schedule(jgraph, batch_size=8, heuristics="h3")[0]
    sched = interop.schedule_from_arrays(
        [(r.sources, r.derived) for r in jsch.rounds], jsch.batch_size,
        jsch.derived_per_round, num_leaf_skipped=jsch.num_leaf_skipped,
        num_isolated_omega=jsch.num_isolated_omega,
        analytic_corrections=jsch.analytic_corrections,
    )
    psch = psched.build_schedule(pgraph, batch_size=8, heuristics="h3")[0]
    assert (sched.num_explicit, sched.num_derived) == (psch.num_explicit, psch.num_derived)
    for a, b in zip(sched.rounds, psch.rounds):
        np.testing.assert_array_equal(a.sources, b.sources)
        np.testing.assert_array_equal(a.derived, b.derived)


def test_interop_rejects_inconsistent_arrays():
    with pytest.raises(ValueError):
        interop.graph_from_arrays(3, np.array([0, 5]), np.array([1, 0]))
    with pytest.raises(ValueError):
        interop.schedule_from_arrays([(np.zeros(4), np.zeros((2, 3)))], 8, 2)


def test_round_ledger_is_exactly_once():
    led = RoundLedger()
    assert led.try_commit(2) and not led.try_commit(2)
    other = RoundLedger.from_state([1, 2, 5])
    assert led.merge(other) == 2 and other.state() == []
    assert led.state() == [1, 2, 5] and led.pending(6) == [0, 3, 4]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert bad == []
