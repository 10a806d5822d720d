"""The port's multi-ledger straggler loop (``BCDriver(straggler="steal" |
"redeal")``) in one process, held against the JAX package and the oracle:
the analogues of tests/test_straggler.py and of tests/test_chaos.py's
replica-loss, watchdog and duplicate-vote cases.

* ``split_rounds`` / ``redeal_rounds`` list-equal to ``repro``'s on seeded
  inputs; ``plan_elastic_remesh`` and ``StragglerPolicy`` as in
  tests/test_substrates.py and tests/test_chaos.py;
* forced-straggler driver runs on a two-lane round function (each lane the
  real single-device traversal on the CPU, as tests/test_straggler.py
  drives the reference): BC within 1e-6 of ``repro``'s ``BCDriver`` on the
  same schedule and of the oracle; exactly-once across speculative
  duplicates, kill-and-resume (policy changed across the resume, and a
  per-lane snapshot resumed by the other package, both ways), replica
  loss, the watchdog's escalation and the duplicate vote.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.checkpoint import BCCheckpoint as JaxBCCheckpoint
from repro.core import engine as jengine
from repro.core import scheduler as jsched
from repro.core.driver import BCDriver as JaxBCDriver
from repro.core.driver import STRAGGLER_POLICIES as JAX_POLICIES
from repro.core.driver import traversal_round as jax_round
from repro.distributed import fault_tolerance as jft
import repro_torch.graphs as pg
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.core.driver import (
    STRAGGLER_POLICIES,
    VOTE_RTOL,
    BCDriver,
    normalize_straggler,
)
from repro_torch.core.scheduler import build_schedule, redeal_rounds, split_rounds
from repro_torch.distributed import (
    BCCheckpoint,
    RoundLedger,
    StragglerPolicy,
    plan_elastic_remesh,
    schedule_fingerprint,
)
from repro_torch.distributed.fault_tolerance import ReplicaLostError

TOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")


# ------------------------------------------------- pure scheduling logic
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("costed", [False, True])
def test_split_rounds_matches_jax(seed, costed):
    rng = np.random.default_rng(seed)
    num_rounds, fr = int(rng.integers(0, 40)), int(rng.integers(1, 5))
    committed = set(rng.choice(max(num_rounds, 1), size=min(num_rounds, 5), replace=False)
                    .tolist()) if num_rounds else set()
    costs = rng.integers(1, 9, size=num_rounds).tolist() if costed else None
    got = split_rounds(num_rounds, fr, committed, round_costs=costs)
    assert got == jsched.split_rounds(num_rounds, fr, committed, round_costs=costs)
    assert sorted(r for q in got for r in q) == sorted(set(range(num_rounds)) - committed)


@pytest.mark.parametrize("seed", range(6))
def test_redeal_rounds_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    fr = int(rng.integers(1, 5))
    rids = rng.permutation(int(rng.integers(0, 30))).tolist()
    cuts = np.sort(rng.integers(0, len(rids) + 1, size=fr - 1))
    queues = [list(q) for q in np.split(np.asarray(rids, int), cuts)]
    queues = [[int(r) for r in q] for q in queues]
    costs = rng.random(fr).round(2).tolist()
    got = redeal_rounds(queues, costs)
    assert got == jsched.redeal_rounds(queues, costs)
    assert sorted(r for q in got[0] for r in q) == sorted(rids)


def test_split_and_redeal_refuse_bad_input():
    assert split_rounds(7, 2) == [[0, 2, 4, 6], [1, 3, 5]]
    assert redeal_rounds([[0, 2, 4, 6], [1, 3, 5, 7]], [10.0, 1.0]) == (
        [[0, 4, 1, 5], [2, 6, 3, 7]], 4)
    with pytest.raises(ValueError):
        split_rounds(4, 0)
    with pytest.raises(ValueError):
        split_rounds(4, 2, round_costs=[1, 2])
    with pytest.raises(ValueError):
        redeal_rounds([[0], [1]], [1.0])


@pytest.mark.parametrize("shape, axes, lost", [
    ((2, 16, 16), ("pod", "data", "model"), 256),  # tests/test_substrates.py
    ((16, 16), ("data", "model"), 128),
    ((2, 2, 2), ("pod", "data", "model"), 4),  # the gloo grid, one replica lost
    ((3, 2, 2), ("pod", "data", "model"), 1),  # a partial pod: no change
    ((2,), ("pod",), 1),  # the one-process driver's default taxonomy
])
def test_plan_elastic_remesh_matches_jax(shape, axes, lost):
    got = plan_elastic_remesh(shape, axes, lost)
    want = jft.plan_elastic_remesh(shape, axes, lost)
    assert (got.shape, got.axes, got.reload_from_checkpoint, got.reshard_params, got.note) == (
        want.shape, want.axes, want.reload_from_checkpoint, want.reshard_params, want.note)


@pytest.mark.parametrize("shape, axes, lost", [((4, 4), ("data", "model"), 16),
                                               ((3, 4), ("data", "model"), 6)])
def test_plan_elastic_remesh_refuses_as_jax(shape, axes, lost):
    with pytest.raises(ValueError):
        jft.plan_elastic_remesh(shape, axes, lost)
    with pytest.raises(ValueError):
        plan_elastic_remesh(shape, axes, lost)


def test_straggler_policy_detects_and_keeps_a_bounded_history():
    pol = StragglerPolicy(factor=2.0, min_samples=3)
    for t in (1.0, 1.1, 0.9, 1.0):
        pol.observe(t)
    assert pol.should_speculate(5.0) and not pol.should_speculate(1.5)
    pol = StragglerPolicy(window=16)
    for i in range(1000):
        pol.observe(float(i))
    assert len(pol.times) == 16 and pol.times[0] == 984.0


def test_straggler_policy_validation():
    assert STRAGGLER_POLICIES == JAX_POLICIES
    assert normalize_straggler(None) == "none"
    with pytest.raises(ValueError, match="straggler"):
        normalize_straggler("work-steal")
    g = pg.gnp_graph(10, 0.3, seed=1)
    with pytest.raises(ValueError, match="straggler"):
        pbc.betweenness_centrality(g, straggler="steal", device="cpu")
    schedule = build_schedule(g, batch_size=4)[0]
    with pytest.raises(ValueError, match="ledger"):
        BCDriver(lambda s, d: None, schedule, n=g.n, device=CPU, straggler="redeal",
                 rounds_per_dispatch=2, ledger=RoundLedger())


# ------------------------------------------------ two-lane round functions
class Crash(RuntimeError):
    pass


def _round_fn(graph, batch, integrity="off"):
    """The port's two-lane dispatch (``make_round_fn`` runs the lanes one
    after another): each lane the real dense traversal on the CPU."""
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=batch)
    op = pbc.make_operator(residual, "dense", CPU)
    fn = pbc.make_round_fn(op, torch.from_numpy(omega_np).float(), integrity=integrity)
    return fn, schedule, prep


def _jax_round_fn(graph):
    """tests/test_straggler.py's two-lane dispatch of the JAX package."""
    adjacency = jnp.asarray(graph.dense_adjacency(np.float32))
    omega = jnp.zeros(graph.n, jnp.float32)
    base = jax.jit(lambda s, d: jax_round(jengine.make_dense_operator(adjacency), s, d, omega))

    def fn(sources, derived):
        outs = [base(sources[r], derived[r]) for r in range(sources.shape[0])]
        return tuple(jnp.stack([o[i] for o in outs]) for i in range(4))

    return fn


class Faulty:
    """A round function with faults at given dispatch calls (retries
    count): a crash, a replica loss (``lose``: call -> replica), a stall
    slept through ``sleeper``, or lane ``lane`` of ``deep`` calls doubled
    with its bc-sum claim forged to match (the audit cannot see it)."""

    def __init__(self, fn, *, crash=(), lose=None, stall=None, deep=(), lane=1, sleeper=None):
        self.fn, self.calls = fn, 0
        self.crash, self.lose, self.stall = set(crash), dict(lose or {}), dict(stall or {})
        self.deep, self.lane, self.sleeper = set(deep), lane, sleeper

    def __call__(self, sources, derived):
        call = self.calls
        self.calls += 1
        if call in self.crash:
            raise Crash(f"crash at dispatch {call}")
        if call in self.lose:
            raise ReplicaLostError(self.lose[call])
        if call in self.stall:
            self.sleeper(self.stall[call])
        out = self.fn(sources, derived)
        if call in self.deep:
            bc, integ = out[0].clone(), out[4].clone()
            bc[self.lane] *= 2.0
            integ[self.lane, 1] = bc[self.lane].sum()
            out = (bc,) + tuple(out[1:4]) + (integ,)
        return out


class FakeClock:
    """Time advances only when something sleeps through it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


@pytest.fixture(scope="module")
def skewed():
    """tests/test_straggler.py's case: 8 rounds at batch 8, deep (path)
    and shallow (clique) rounds alternating."""
    g = pg.skewed_depth_graph(4, 8)
    fn, schedule, prep = _round_fn(g, 8)
    assert len(schedule.rounds) == 8
    return g, fn, schedule, prep, brandes_reference(g)


def _driver(case, policy, fn=None, **kw):
    g, base, schedule, prep, _ = case
    kw.setdefault("retry_backoff_s", 1e-4)
    return BCDriver(fn or base, schedule, n=g.n, device=CPU, prep=prep, rounds_per_dispatch=2,
                    straggler=policy, **kw)


def _committed(drv) -> list[int]:
    return sorted(r for led in drv.ledgers for r in led.state())


# ------------------------------------------------ forced-straggler driver
@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_forced_straggler_parity(skewed, policy):
    """One lane draws every deep round, the other every shallow one: both
    policies reproduce the oracle and the JAX package's driver."""
    g, _, _, _, want = skewed
    result = _driver(skewed, policy, prior_round_s=1e-3).run()
    np.testing.assert_allclose(result.bc, want, **TOL)
    jgraph = jg.skewed_depth_graph(4, 8)
    jschedule, jprep, _, _ = jsched.build_schedule(jgraph, batch_size=8)
    jres = JaxBCDriver(_jax_round_fn(jgraph), jschedule, n=g.n, prep=jprep,
                       rounds_per_dispatch=2, straggler=policy, prior_round_s=1e-3).run()
    np.testing.assert_allclose(result.bc, jres.bc, **TOL)
    assert result.rounds_run == jres.rounds_run == 8
    stats = result.straggler_stats
    assert stats["policy"] == policy and sum(stats["per_replica_rounds"]) == 8
    assert len(result.block_times) == len(jres.block_times) and min(result.block_times) > 0
    assert result.recovery_stats["remesh_events"] == 0
    if policy == "redeal":  # path depth 8 against clique depth 2: the EWMAs split
        assert stats["redeal_events"] >= 1 and stats["rounds_redealt"] > 0
        assert jres.straggler_stats["redeal_events"] >= 1
    assert sorted(result.round_levels) == sorted([8, 2] * 4)


def test_steal_duplicates_are_discarded_not_double_committed():
    """An odd round count leaves a lane idle at the tail: it runs a
    duplicate of the straggler's round, which must be masked out."""
    g = pg.disjoint_union(pg.skewed_depth_graph(3, 8), pg.path_graph(8))  # 7 rounds
    fn, schedule, prep = _round_fn(g, 8)
    assert len(schedule.rounds) == 7
    drv = BCDriver(fn, schedule, n=g.n, device=CPU, prep=prep, rounds_per_dispatch=2,
                   straggler="steal")
    result = drv.run()
    np.testing.assert_allclose(result.bc, brandes_reference(g), **TOL)
    stats = result.straggler_stats
    assert stats["duplicates_dispatched"] >= 1
    assert stats["duplicates_discarded"] == stats["duplicates_dispatched"]
    assert result.rounds_run == 7 and _committed(drv) == list(range(7))


@pytest.mark.parametrize("resume_policy", ["redeal", "steal", "none"])
def test_straggler_kill_and_resume(tmp_path, skewed, resume_policy):
    """Killed under redeal, resumed under any policy: the merged per-lane
    ledgers keep every round exactly once; a third run is a no-op."""
    want = skewed[4]
    path = str(tmp_path / "bc.npz")

    def driver(policy, **kw):
        return _driver(skewed, policy, checkpoint=BCCheckpoint(path), checkpoint_every=1, **kw)

    with pytest.raises(Crash):
        driver("redeal", fn=Faulty(skewed[1], crash=range(2, 99))).run()
    _, _, by_lane = BCCheckpoint(path).load_namespaced()
    committed = {rid for lane in by_lane for rid in lane}
    assert len(by_lane) == 2 and 0 < len(committed) < 8
    resumed = driver(resume_policy).run()
    assert resumed.rounds_run == 8 - len(committed)
    np.testing.assert_allclose(resumed.bc, want, **TOL)
    third = driver(resume_policy).run()
    assert third.rounds_run == 0
    np.testing.assert_allclose(third.bc, want, **TOL)


def test_per_lane_snapshot_written_by_port_resumes_in_jax(tmp_path, skewed):
    path = str(tmp_path / "torch.npz")
    with pytest.raises(Crash):
        _driver(skewed, "steal", fn=Faulty(skewed[1], crash=range(2, 99)),
                checkpoint=BCCheckpoint(path), checkpoint_every=1).run()
    by_lane = BCCheckpoint(path).load_namespaced()[2]
    done = {rid for lane in by_lane for rid in lane}
    jgraph = jg.skewed_depth_graph(4, 8)
    jschedule, jprep, _, _ = jsched.build_schedule(jgraph, batch_size=8)
    resumed = JaxBCDriver(_jax_round_fn(jgraph), jschedule, n=jgraph.n, prep=jprep,
                          rounds_per_dispatch=2, straggler="redeal",
                          checkpoint=JaxBCCheckpoint(path)).run()
    assert len(done) == 4 and resumed.rounds_run == 4
    np.testing.assert_allclose(resumed.bc, skewed[4], **TOL)


def test_per_lane_snapshot_written_by_jax_resumes_in_port(tmp_path, skewed):
    path = str(tmp_path / "jax.npz")
    jgraph = jg.skewed_depth_graph(4, 8)
    jschedule, jprep, _, _ = jsched.build_schedule(jgraph, batch_size=8)
    jfn = _jax_round_fn(jgraph)
    calls = []

    def crashing(sources, derived):
        calls.append(1)
        if len(calls) > 3:
            raise Crash
        return jfn(sources, derived)

    with pytest.raises(Crash):
        JaxBCDriver(crashing, jschedule, n=jgraph.n, prep=jprep, rounds_per_dispatch=2,
                    straggler="steal", checkpoint=JaxBCCheckpoint(path),
                    checkpoint_every=1).run()
    by_lane = jft.BCCheckpoint(path).load_namespaced()[2]
    assert len(by_lane) == 2 and sum(map(len, by_lane)) == 6
    drv = _driver(skewed, "redeal", checkpoint=BCCheckpoint(path))
    assert [led.state() for led in drv.ledgers] == by_lane  # per-lane attribution kept
    resumed = drv.run()
    assert resumed.rounds_run == 2 and _committed(drv) == list(range(8))
    np.testing.assert_allclose(resumed.bc, skewed[4], **TOL)


def test_resume_with_another_replica_count_merges_the_lanes(tmp_path, skewed):
    g, fn, schedule, prep, want = skewed
    path = str(tmp_path / "bc.npz")
    fingerprint = schedule_fingerprint(g.n, schedule)
    BCCheckpoint(path).save(np.zeros(g.n), {}, [[0], [1], [2]], fingerprint)
    drv = _driver(skewed, "steal", checkpoint=BCCheckpoint(path))
    assert [led.state() for led in drv.ledgers] == [[0, 1, 2], []]


def test_straggler_requires_levels_output():
    g = pg.gnp_graph(12, 0.3, seed=0)
    fn, schedule, prep = _round_fn(g, 4)
    drv = BCDriver(lambda s, d: fn(s, d)[:3], schedule, n=g.n, device=CPU, prep=prep,
                   rounds_per_dispatch=2, straggler="steal")
    with pytest.raises(ValueError, match="levels"):
        drv.run()


# -------------------------------------------- replica loss, re-meshing
@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_replica_loss_triggers_remesh_and_parity(skewed, policy, caplog):
    drv = _driver(skewed, policy, fn=Faulty(skewed[1], lose={1: 1}), prior_round_s=1e-3)
    with caplog.at_level("WARNING"):
        result = drv.run()
    np.testing.assert_allclose(result.bc, skewed[4], **TOL)
    rec = result.recovery_stats
    assert rec["remesh_events"] == 1 and rec["dead_replicas"] == [1]
    assert result.rounds_run == 8 and _committed(drv) == list(range(8))
    assert drv.ledgers[1].state() == []  # merged into the survivor
    assert "replica 1 lost: re-mesh (2,) -> (1,)" in caplog.text


def test_all_replicas_dead_reraises(skewed):
    drv = _driver(skewed, "steal", fn=Faulty(skewed[1], lose={0: 0, 1: 1}))
    with pytest.raises(ReplicaLostError):
        drv.run()
    assert drv.recovery["remesh_events"] == 1  # the first loss healed, the second fatal


@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_watchdog_stall_escalates_into_remesh_and_parity(skewed, policy):
    """Three stalled dispatches spend the budget; the escalation names no
    replica, so the slowest lane is suspected, and the survivor finishes."""
    clk = FakeClock()
    drv = _driver(skewed, policy, fn=Faulty(skewed[1], stall={0: 0.05, 1: 0.05, 2: 0.05},
                                            sleeper=clk.sleep),
                  clock=clk, sleeper=clk.sleep, dispatch_deadline_s=0.02, max_retries=2,
                  prior_round_s=1e-3)
    result = drv.run()
    np.testing.assert_allclose(result.bc, skewed[4], **TOL)
    rec = result.recovery_stats
    integ = rec["integrity"]
    assert (integ["watchdog_trips"], integ["watchdog_redispatches"],
            integ["watchdog_escalations"]) == (3, 2, 1)
    assert rec["remesh_events"] == 1 and len(rec["dead_replicas"]) == 1
    assert result.rounds_run == 8 and _committed(drv) == list(range(8))


# ------------------------------------------------------ duplicate vote
def test_duplicate_vote_quarantines_a_deep_flip_and_the_owner_wins():
    """A flip that also forges the block's claim passes every audit; only
    the duplicated tail lane's vote catches it (tests/test_chaos.py's
    ``flip@2:d1``), and the tie-breaker sides with the owner lane."""
    g = pg.gnp_graph(20, 0.25, seed=5)
    fn, schedule, prep = _round_fn(g, 4, integrity="audit")
    assert len(schedule.rounds) == 5  # odd: the tail is duplicated onto lane 1
    drv = BCDriver(Faulty(fn, deep=(2,), lane=1), schedule, n=g.n, device=CPU, prep=prep,
                   rounds_per_dispatch=2, straggler="steal", prior_round_s=1e-3,
                   integrity="audit")
    result = drv.run()
    np.testing.assert_allclose(result.bc, brandes_reference(g), **TOL)
    integ = result.recovery_stats["integrity"]
    assert integ["votes"] >= 2 and integ["vote_mismatches"] == 1
    assert integ["quarantined_rounds"] == 1
    assert integ["vote_verdicts"] == [{"round": 4, "matched": "owner"}]
    assert integ["audit_failures"] == 0 and _committed(drv) == list(range(5))
    assert VOTE_RTOL == 1e-6


# --------------------------------------------- the static loop's knobs
def test_profile_fills_block_times_and_max_inflight_changes_nothing(skewed):
    g, fn, schedule, prep, want = skewed
    runs = [BCDriver(fn, schedule, n=g.n, device=CPU, prep=prep, rounds_per_dispatch=2,
                     max_inflight=m, profile=p).run() for m, p in ((1, True), (3, False))]
    for res in runs:
        np.testing.assert_allclose(res.bc, want, **TOL)
    np.testing.assert_array_equal(runs[0].bc, runs[1].bc)
    assert len(runs[0].block_times) == 4 and min(runs[0].block_times) > 0
    assert runs[1].block_times is None and runs[0].straggler_stats is None
