"""Single-device BC in the port, end to end, on the CPU.

Held against the numpy oracle (``brandes_reference``) and against the JAX
package's ``betweenness_centrality`` on the same graphs, at rtol 1e-5 /
atol 1e-5 (tests/test_bc_core.py's tolerance: f32 device accumulation
over a handful of rounds).  ``traversal_round`` is compared round by round
on one schedule carried across with :mod:`repro_torch.interop`.  JAX's
Pallas engines run in interpret mode, so they get a few graphs only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import betweenness_centrality as jax_bc
from repro.core import driver as jdriver
from repro.core import operators as jops
from repro.core import scheduler as jsched
import repro_torch.graphs as pg
from repro_torch import interop
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.core import driver as pdriver
from repro_torch.core.scheduler import HEURISTICS_MODES, build_schedule
from repro_torch.distributed import RoundLedger

TOL = dict(rtol=1e-5, atol=1e-5)

GRAPHS = {
    "gnp24": lambda m: m.gnp_graph(24, 0.12, seed=1),
    "road4x4": lambda m: m.road_like_graph(4, 4, spur_fraction=0.5, seed=1),
    "multi": lambda m: m.disjoint_union(
        m.path_graph(6), m.star_graph(4), m.cycle_graph(5), m.gnp_graph(12, 0.2, seed=7)
    ),
}


def _bc(graph, **kw):
    kw.setdefault("batch_size", 8)
    return pbc.betweenness_centrality(graph, device="cpu", **kw)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("heuristics", list(HEURISTICS_MODES))
@pytest.mark.parametrize("engine", list(pbc.ENGINE_KINDS))
def test_bc_matches_oracle(graph, heuristics, engine):
    g = GRAPHS[graph](pg)
    got = _bc(g, heuristics=heuristics, engine_kind=engine)
    assert got.bc.dtype == np.float64 and got.bc.shape == (g.n,)
    np.testing.assert_allclose(got.bc, brandes_reference(g), **TOL)


@pytest.mark.parametrize("heuristics", list(HEURISTICS_MODES))
@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_bc_matches_jax_xla_engines(heuristics, engine):
    jgraph, g = GRAPHS["multi"](jg), GRAPHS["multi"](pg)
    want = jax_bc(jgraph, batch_size=8, heuristics=heuristics, engine_kind=engine)
    got = _bc(g, heuristics=heuristics, engine_kind=engine)
    np.testing.assert_allclose(got.bc, want.bc, **TOL)
    assert (got.rounds_run, got.forward_columns, got.backward_columns) == (
        want.rounds_run, want.forward_columns, want.backward_columns
    )


@pytest.mark.parametrize("engine", ["fused", "fused_bf16"])
@pytest.mark.parametrize("heuristics", list(HEURISTICS_MODES))
def test_bc_matches_jax_pallas_engines(engine, heuristics):
    jgraph, g = jg.gnp_graph(20, 0.18, seed=21), pg.gnp_graph(20, 0.18, seed=21)
    want = jax_bc(jgraph, batch_size=8, heuristics=heuristics,
                  engine_kind=pbc.REFERENCE_ENGINE[engine])
    got = _bc(g, heuristics=heuristics, engine_kind=engine)
    np.testing.assert_allclose(got.bc, want.bc, **TOL)


def _jax_operator(engine, adjacency):
    if engine == "dense":
        return jops.DenseOperator(jnp.asarray(adjacency))
    return jops.PallasDenseOperator(jnp.asarray(adjacency), interpret=True)


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_traversal_round_matches_jax_round_by_round(engine):
    """One JAX schedule, carried across, through both round bodies."""
    jgraph = jg.suburb_graph(3, 3, leaf_fraction=0.6, seed=2)
    jsch, _, jres, omega = jsched.build_schedule(jgraph, batch_size=8, heuristics="h3")
    sched = interop.schedule_from_arrays(
        [(r.sources, r.derived) for r in jsch.rounds], jsch.batch_size, jsch.derived_per_round
    )
    residual = interop.graph_from_arrays(jres.n, jres.src, jres.dst)
    jop = _jax_operator(engine, jres.dense_adjacency(np.float32))
    op = pbc.make_operator(residual, engine, torch.device("cpu"))
    omega_t = torch.from_numpy(omega).to(torch.float32)
    assert len(sched.rounds) == len(jsch.rounds) > 1
    for pr, jr in zip(sched.rounds, jsch.rounds):
        jbc, jns, jroots, jlevels = jdriver.traversal_round(
            jop, jnp.asarray(jr.sources), jnp.asarray(jr.derived), jnp.asarray(omega, jnp.float32)
        )
        bc, ns, roots, levels = pdriver.traversal_round(
            op, torch.from_numpy(pr.sources), torch.from_numpy(pr.derived), omega_t
        )
        np.testing.assert_allclose(bc.numpy(), np.asarray(jbc), **TOL)
        np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
        np.testing.assert_array_equal(roots.numpy(), np.asarray(jroots))
        assert levels == int(jlevels)


def test_sampling_fixed_matches_jax():
    jgraph, g = jg.rmat_graph(7, 8, seed=1), pg.rmat_graph(7, 8, seed=1)
    kw = dict(batch_size=16, sampling="fixed", sample_k=40, sample_seed=3)
    want = jax_bc(jgraph, engine_kind="dense", **kw)
    got = _bc(g, engine_kind="fused", **kw)
    assert got.sampling_stats == want.sampling_stats
    assert got.sampling_stats["scale"] > 1.0
    for a, b in zip(got.schedule.rounds, want.schedule.rounds):
        np.testing.assert_array_equal(a.sources, b.sources)
    np.testing.assert_allclose(got.bc, want.bc, **TOL)


def test_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = pg.cycle_graph(6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbc.betweenness_centrality(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbc.betweenness_centrality(g, engine_kind="fused", device="cuda")
    np.testing.assert_allclose(
        pbc.betweenness_centrality(g, device="cpu").bc, brandes_reference(g), **TOL
    )


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"checkpoint": object()}, AttributeError),
        ({"weighted": True}, ValueError),  # the graph carries no weights
        ({"delta": 1.0}, ValueError),  # delta without weighted=True
        ({"sampling": "adaptive", "heuristics": "h1"}, ValueError),
        ({"overlap": "expand"}, ValueError),
        ({"straggler": "steal"}, ValueError),
        ({"engine_kind": "pallas"}, ValueError),
        ({"sampling": "fixed", "sample_k": 3, "heuristics": "h1"}, ValueError),
        ({"stop_rule": lambda bc, r: True}, ValueError),
    ],
)
def test_unported_or_invalid_options_raise(kwargs, error):
    with pytest.raises(error):
        _bc(pg.cycle_graph(6), **kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [{"straggler": "steal", "ledger": RoundLedger()}, {"straggler": "work-steal"},
     {"integrity": "bogus"}, {"dispatch_deadline_s": 0.0}],
)
def test_driver_options_of_later_slices_raise(kwargs):
    """The multi-ledger straggler loop, the integrity modes and the
    watchdog are ported and validate their arguments: a straggler policy
    keeps one ledger per replica, so it refuses an external one, and an
    unknown policy is refused."""
    g = pg.cycle_graph(6)
    schedule = build_schedule(g, batch_size=4)[0]
    with pytest.raises(ValueError):
        pdriver.BCDriver(lambda s, d: None, schedule, n=g.n, device="cpu", **kwargs)


def test_static_num_levels_matches_dynamic():
    g = pg.gnp_graph(20, 0.15, seed=4)
    a = _bc(g, engine_kind="fused")
    b = _bc(g, engine_kind="fused", num_levels=22)
    np.testing.assert_allclose(a.bc, b.bc, rtol=1e-6)


def test_ledger_skips_committed_rounds():
    g = pg.gnp_graph(30, 0.1, seed=5)
    full = _bc(g, batch_size=8)
    ledger = RoundLedger.from_state([0])
    part = _bc(g, batch_size=8, ledger=ledger)
    assert part.rounds_run == full.rounds_run - 1
    assert ledger.state() == list(range(full.rounds_run))
    rest = _bc(g, batch_size=8, ledger=RoundLedger.from_state(range(1, full.rounds_run)))
    np.testing.assert_allclose(part.bc + rest.bc, full.bc, **TOL)


def test_stop_rule_truncates_a_sampled_run():
    g = pg.gnp_graph(30, 0.1, seed=5)
    res = _bc(g, sampling="fixed", sample_k=24, stop_rule=lambda bc, rounds: rounds >= 1)
    assert res.stopped_early and res.rounds_run == 1
    assert res.sampling_stats["roots_accumulated"] == 8


def test_batch_and_levels_bookkeeping():
    g = pg.path_graph(9)
    res = _bc(g, batch_size=4, engine_kind="fused")
    assert res.rounds_run == 3 and len(res.round_levels) == 3
    assert max(res.round_levels) == 9  # a path end reaches depth 8
