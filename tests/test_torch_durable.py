"""Durability and self-checks of the port on one device (and the 2-D
checkpoint on a gloo grid), held against the JAX package.

* ``schedule_fingerprint`` equal as strings; snapshots written by either
  package resume in the other (same npz keys, manifest, generations);
* the analogues of tests/test_system.py's ledger and checkpoint
  kill-and-resume tests; torn generations and fingerprint mismatches;
* the ABFT lane: ``checksum_append`` / ``checksum_residual`` and the
  checked level steps of ``dense``, ``sparse`` and ``fused`` against the
  JAX package's ``dense`` / ``sparse`` / ``pallas`` (interpret mode);
* the recovery ladder of ``BCDriver`` driven by a plain faulty round
  function, against tests/test_chaos.py's expected counters;
* ``checkpoint=`` on a 2×2 gloo grid (spawned once per module).

Tolerances: BC within 1e-6 of the oracle or the other package (the JAX
package's own, tests/test_chaos.py), level states as
tests/test_torch_bc.py holds them (σ exact, δ rtol 1e-6), residuals
1e-6 absolute.
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as jg
from repro.core import betweenness_centrality as jax_bc
from repro.core import operators as jops
from repro.core import scheduler as jsched
from repro.distributed import fault_tolerance as jft
from repro.kernels import ops as jkops
from repro.serving import BlockBudgetStop as JaxBlockBudgetStop
import repro_torch.graphs as pg
from repro_torch import interop
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.core import driver as pdriver
from repro_torch.core.scheduler import build_schedule
from repro_torch.distributed import BCCheckpoint, RoundLedger, run_gloo, schedule_fingerprint
from repro_torch.distributed.fault_tolerance import (
    IntegrityError,
    ReplicaLostError,
    TransientRoundError,
)
from repro_torch.kernels import ops as pops
from repro_torch.serving import BlockBudgetStop
import torch_durable_worker as worker

TOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")


def _bc(graph, **kw):
    return pbc.betweenness_centrality(graph, device="cpu", **kw)


# ------------------------------------------------------- fingerprints
@pytest.mark.parametrize("graph", ["gnp30", "road5x5", "rmat7"])
@pytest.mark.parametrize("batch", [4, 16])
@pytest.mark.parametrize("heuristics", ["h0", "h3", "h3t"])
def test_schedule_fingerprint_matches_jax(graph, batch, heuristics):
    make = {"gnp30": lambda m: m.gnp_graph(30, 0.15, seed=11),
            "road5x5": lambda m: m.road_like_graph(5, 5, spur_fraction=0.5, seed=4),
            "rmat7": lambda m: m.rmat_graph(7, 8, seed=2)}[graph]
    jgraph, g = make(jg), make(pg)
    jsch = jsched.build_schedule(jgraph, batch_size=batch, heuristics=heuristics)[0]
    psch = build_schedule(g, batch_size=batch, heuristics=heuristics)[0]
    want = jft.schedule_fingerprint(jgraph.n, jsch)
    assert schedule_fingerprint(g.n, psch) == want
    # and on the JAX schedule carried across
    carried = interop.schedule_from_arrays(
        [(r.sources, r.derived) for r in jsch.rounds], jsch.batch_size, jsch.derived_per_round)
    assert schedule_fingerprint(g.n, carried) == want


# --------------------------------------------- cross-package snapshots
SAMPLED = worker.SAMPLED


def test_snapshot_written_by_jax_resumes_in_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jgraph, g = jg.gnp_graph(**worker.SAMPLED_GRAPH), pg.gnp_graph(**worker.SAMPLED_GRAPH)
    partial = jax_bc(jgraph, engine_kind="dense", checkpoint=jft.BCCheckpoint(path),
                     stop_rule=JaxBlockBudgetStop(1), **SAMPLED)
    assert partial.stopped_early and partial.rounds_run == 1
    resumed = _bc(g, engine_kind="fused", checkpoint=BCCheckpoint(path), **SAMPLED)
    assert resumed.rounds_run == len(resumed.schedule.rounds) - 1
    assert resumed.recovery_stats["resumed_generation"] == 0
    want = jax_bc(jgraph, engine_kind="dense", **SAMPLED)
    np.testing.assert_allclose(resumed.bc, want.bc, **TOL)
    assert resumed.sampling_stats == want.sampling_stats


def test_snapshot_written_by_port_resumes_in_jax(tmp_path):
    path = str(tmp_path / "torch.npz")
    jgraph, g = jg.gnp_graph(30, 0.15, seed=13), pg.gnp_graph(30, 0.15, seed=13)
    kw = dict(batch_size=4, heuristics="h0", sampling="fixed", sample_frac=1.0)
    partial = _bc(g, engine_kind="sparse", checkpoint=BCCheckpoint(path),
                  stop_rule=BlockBudgetStop(3), **kw)
    assert partial.rounds_run == 3
    resumed = jax_bc(jgraph, engine_kind="dense", checkpoint=jft.BCCheckpoint(path), **kw)
    assert resumed.rounds_run == len(resumed.schedule.rounds) - 3
    np.testing.assert_allclose(resumed.bc, brandes_reference(g), **TOL)
    np.testing.assert_allclose(resumed.bc, _bc(g, engine_kind="sparse", **kw).bc, **TOL)


# ------------------------------------- tests/test_system.py analogues
def test_bc_resumes_from_partial_rounds():
    """Kill-and-resume through the ledger protocol: the rounds a first
    process committed are skipped by the second, and the two partial raw
    sums add up to the unbroken run (h0: the BC is the raw sum)."""
    g = pg.gnp_graph(30, 0.15, seed=11)
    full = _bc(g, batch_size=4)
    n_rounds = len(build_schedule(g, batch_size=4)[0].rounds)
    half = n_rounds // 2
    ledger = RoundLedger()
    first = _bc(g, batch_size=4, ledger=RoundLedger.from_state(range(half, n_rounds)))
    for rid in range(half):  # what the first process committed
        ledger.try_commit(rid)
    rest = _bc(g, batch_size=4, ledger=RoundLedger.from_state(ledger.state()))
    assert (first.rounds_run, rest.rounds_run) == (half, n_rounds - half)
    np.testing.assert_allclose(first.bc + rest.bc, full.bc, **TOL)
    np.testing.assert_allclose(full.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)
    want = jax_bc(jg.gnp_graph(30, 0.15, seed=11), batch_size=4)
    np.testing.assert_allclose(full.bc, want.bc, **TOL)


class Crash(RuntimeError):
    pass


def _dense_round_fn(graph, integrity="off", lanes=1):
    """The real single-device traversal, ``lanes`` rounds a block (the
    fake multi-lane dispatch of tests/test_chaos.py)."""
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=8)
    op = pbc.make_operator(residual, "dense", CPU)
    base = pbc.make_round_fn(op, torch.from_numpy(omega_np).float(), integrity=integrity)

    def fn(sources, derived):
        outs = [base(sources[r:r + 1], derived[r:r + 1]) for r in range(sources.shape[0])]
        return tuple(
            (sum((o[i] for o in outs), []) if isinstance(outs[0][i], list)
             else torch.cat([o[i] for o in outs]))
            for i in range(len(outs[0]))
        )

    return fn if lanes > 1 else base


class Faulty:
    """A round function with faults at given dispatch calls (retries count
    as calls, as tests/test_chaos.py's ChaosRoundFn counts them): crash,
    stall (slept through ``sleeper``), transient raise, then NaN poison of
    bc/ns or a finite flip ``2x + 1`` of lane 0's bc."""

    def __init__(self, fn, *, crash=(), stall=None, transient=(), poison=(), flip=(),
                 sleeper=None):
        self.fn, self.calls = fn, 0
        self.crash, self.transient = set(crash), set(transient)
        self.poison, self.flip = set(poison), set(flip)
        self.stall, self.sleeper = dict(stall or {}), sleeper

    def __call__(self, sources, derived):
        call = self.calls
        self.calls += 1
        if call in self.crash:
            raise Crash(f"crash at dispatch {call}")
        if call in self.stall:
            self.sleeper(self.stall[call] / 1000.0)
        if call in self.transient:
            raise TransientRoundError(f"transient failure at dispatch {call}")
        out = self.fn(sources, derived)
        if call in self.poison:
            out = (out[0] * float("nan"), out[1] * float("nan")) + tuple(out[2:])
        if call in self.flip:
            bc = out[0].clone()
            bc[0] = 2.0 * bc[0] + 1.0
            out = (bc,) + tuple(out[1:])
        return out


@pytest.fixture(scope="module")
def case():
    """tests/test_chaos.py's case: 8 rounds at batch 8, two lanes a block."""
    g = pg.skewed_depth_graph(4, 8)
    schedule, prep, _, _ = build_schedule(g, batch_size=8)
    assert len(schedule.rounds) == 8
    return g, schedule, prep, brandes_reference(g)


def _driver(case, integrity="off", **faults_and_kw):
    g, schedule, prep, _ = case
    kw = {k: faults_and_kw.pop(k) for k in list(faults_and_kw)
          if k not in ("crash", "stall", "transient", "poison", "flip")}
    fn = _dense_round_fn(g, integrity, lanes=2)
    round_fn = Faulty(fn, sleeper=kw.get("sleeper"), **faults_and_kw) if faults_and_kw else fn
    kw.setdefault("retry_backoff_s", 1e-4)
    return pdriver.BCDriver(round_fn, schedule, n=g.n, device=CPU, prep=prep,
                            rounds_per_dispatch=2, integrity=integrity, **kw)


def test_bc_driver_checkpoint_kill_and_resume(tmp_path):
    """A run killed mid-loop leaves a consistent BCCheckpoint; a fresh
    driver resumes from it and reproduces the unbroken result."""
    g = pg.gnp_graph(30, 0.15, seed=13)
    full = _bc(g, batch_size=4, heuristics="h3")
    schedule, prep, residual, omega_np = build_schedule(g, batch_size=4, heuristics="h3")
    op = pbc.make_operator(residual, "dense", CPU)
    base = pbc.make_round_fn(op, torch.from_numpy(omega_np).float())
    n_rounds = len(schedule.rounds)
    ckpt = BCCheckpoint(str(tmp_path / "bc.npz"))
    with pytest.raises(Crash):
        pdriver.BCDriver(Faulty(base, crash=range(n_rounds // 2, n_rounds)), schedule,
                         n=g.n, device=CPU, prep=prep, checkpoint=ckpt,
                         checkpoint_every=1).run()
    _, _, committed = ckpt.load()
    assert committed == list(range(n_rounds // 2))
    resumed = pdriver.BCDriver(base, schedule, n=g.n, device=CPU, prep=prep,
                               checkpoint=BCCheckpoint(str(tmp_path / "bc.npz"))).run()
    assert resumed.rounds_run == n_rounds - n_rounds // 2
    np.testing.assert_allclose(resumed.bc, full.bc, **TOL)
    np.testing.assert_allclose(resumed.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)


def test_torn_newest_generation_falls_back(tmp_path, case, caplog):
    g, schedule, _, _ = case
    fp = schedule_fingerprint(g.n, schedule)
    path = str(tmp_path / "bc.npz")
    ckpt = BCCheckpoint(path)
    ckpt.save(np.ones(g.n), {0: 3.0}, [0], fp)
    ckpt.save(2 * np.ones(g.n), {0: 3.0, 1: 4.0}, [0, 1], fp)
    assert os.path.exists(path + ".g1")
    with open(path, "r+b") as f:  # tear the newest generation
        f.truncate(os.path.getsize(path) // 2)
    with caplog.at_level(logging.WARNING):
        bc, ns, committed = BCCheckpoint(path).load(fp)
    assert "falling back" in caplog.text
    np.testing.assert_array_equal(bc, np.ones(g.n))
    assert committed == [0] and ns == {0: 3.0}
    # the JAX package reads the same generations the same way
    jck = jft.BCCheckpoint(path)
    jbc, _, jcommitted = jck.load(fp)
    np.testing.assert_array_equal(jbc, bc)
    assert jck.loaded_generation == 1 and jcommitted == committed


def test_fingerprint_mismatch_raises(tmp_path, case):
    g, schedule, _, _ = case
    ckpt = BCCheckpoint(str(tmp_path / "bc.npz"))
    ckpt.save(np.zeros(g.n), {}, [0], "n1_b1_k0_r1_00000000")
    with pytest.raises(ValueError, match="different schedule"):
        ckpt.load(schedule_fingerprint(g.n, schedule))


def test_snapshot_files_equal_jax_written(tmp_path):
    """Same arrays in, same npz keys, values and manifest out."""
    args = (np.arange(5, dtype=np.float64), {3: 4.0, 1: 2.0}, [[0, 2], [1]], "fp")
    stats = {"retries": 1, "integrity": {"mode": "audit"}}
    BCCheckpoint(str(tmp_path / "p.npz")).save(*args, stats=stats)
    jft.BCCheckpoint(str(tmp_path / "j.npz")).save(*args, stats=stats)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for key in p.files:
            np.testing.assert_array_equal(p[key], j[key])


# ------------------------------------------------------ the ABFT lane
def test_checksum_ops_match_jax():
    rng = np.random.default_rng(0)
    x = rng.random((37, 9)).astype(np.float32)
    got = pops.checksum_append(torch.from_numpy(x))
    want = np.asarray(jkops.checksum_append(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    t = got.numpy().copy()
    t[5, 2] += 3.0  # break one row's invariant
    r_got = float(pops.checksum_residual(torch.from_numpy(t)))
    r_want = float(jkops.checksum_residual(jnp.asarray(t)))
    assert r_got == pytest.approx(r_want, abs=1e-6) and r_got > 1e-2
    assert float(pops.checksum_residual(got)) < 1e-6


def _level_state(n, s, lvl, seed):
    rng = np.random.default_rng(seed)
    depth = rng.integers(-1, lvl + 3, size=(n, s)).astype(np.int32)
    sigma = np.where(depth >= 0, rng.integers(1, 5, size=(n, s)), 0).astype(np.float32)
    delta = (rng.random((n, s)) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=n).astype(np.float32)
    return sigma, depth, delta, omega


@pytest.mark.parametrize("engine", ["dense", "sparse", "fused", "fused_bf16"])
def test_checked_steps_match_jax(engine):
    jgraph, g = jg.gnp_graph(40, 0.12, seed=3), pg.gnp_graph(40, 0.12, seed=3)
    adjacency = jgraph.dense_adjacency(np.float32)
    if engine == "sparse":
        src, dst, _ = jgraph.padded_arcs(multiple=8)
        jop = jops.SparseOperator(jnp.asarray(src), jnp.asarray(dst), jgraph.n)
    elif engine == "dense":
        jop = jops.DenseOperator(jnp.asarray(adjacency))
    else:
        dt = jnp.float32 if engine == "fused" else jnp.bfloat16
        jop = jops.PallasDenseOperator(jnp.asarray(adjacency, dt), interpret=True)
    op = pbc.make_operator(g, engine, CPU)
    sigma, depth, delta, omega = _level_state(g.n, 7, 2, seed=1)
    j = [jnp.asarray(x) for x in (sigma, depth, delta, omega)]
    t = [torch.from_numpy(x) for x in (sigma, depth, delta, omega)]
    js, jd, jalive, jerr = jop.forward_level_checked(2, j[0], j[1])
    ps, pd, palive, perr = op.forward_level_checked(2, t[0], t[1])
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
    assert bool(palive) == bool(jalive)
    jdl, jberr = jop.backward_level_checked(1, j[0], j[1], j[3], j[2])
    pdl, pberr = op.backward_level_checked(1, t[0], t[1], t[3], t[2])
    np.testing.assert_allclose(pdl.numpy(), np.asarray(jdl), rtol=1e-6, atol=1e-6)
    for got, want in ((perr, jerr), (pberr, jberr)):
        assert float(got) == pytest.approx(float(want), abs=1e-6)
        assert float(got) < pdriver.CHECKSUM_TOL
    # the checked step advances the state exactly as the unchecked one
    us, ud, _ = op.forward_level(2, t[0], t[1])
    np.testing.assert_array_equal(ud.numpy(), pd.numpy())
    np.testing.assert_allclose(us.numpy(), ps.numpy(), rtol=1e-6)
    np.testing.assert_allclose(op.backward_level(1, t[0], t[1], t[3], t[2]).numpy(),
                               pdl.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("engine", ["dense", "sparse", "fused"])
def test_checksum_round_matches_unchecked(engine):
    g = pg.road_like_graph(5, 5, spur_fraction=0.5, seed=4)
    plain = _bc(g, batch_size=8, heuristics="h3", engine_kind=engine)
    schedule, prep, residual, omega_np = build_schedule(g, batch_size=8, heuristics="h3")
    op = pbc.make_operator(residual, engine, CPU)
    fn = pbc.make_round_fn(op, torch.from_numpy(omega_np).float(), integrity="checksum")
    res = pdriver.BCDriver(fn, schedule, n=g.n, device=CPU, prep=prep,
                           integrity="checksum").run()
    np.testing.assert_allclose(res.bc, plain.bc, **TOL)
    integ = res.recovery_stats["integrity"]
    assert integ["checksum_failures"] == integ["audit_failures"] == 0
    assert 0.0 <= integ["max_checksum_residual"] < 1e-4


# ------------------------------------ the recovery ladder (test_chaos)
def test_transient_rounds_are_retried(case):
    result = _driver(case, transient=(1, 2)).run()
    np.testing.assert_allclose(result.bc, case[3], **TOL)
    rec = result.recovery_stats
    assert rec["transient_errors"] == 2 and rec["retries"] == 2
    assert result.rounds_run == 8


def test_transient_budget_exhausted_raises(case):
    drv = _driver(case, transient=range(5), max_retries=1)
    with pytest.raises(TransientRoundError):
        drv.run()
    assert drv.recovery["retries"] == 1


def test_poison_block_quarantined_and_recovered(case):
    result = _driver(case, poison=(1,), numeric_guard=True).run()
    np.testing.assert_allclose(result.bc, case[3], **TOL)
    rec = result.recovery_stats
    assert rec["quarantined_blocks"] == 1 and rec["retries"] == 1
    assert rec["fallback_recomputes"] == 0


def test_persistent_poison_falls_back_to_clean_round_fn(case):
    g = case[0]
    result = _driver(case, poison=range(1, 101),
                     fallback_round_fn=_dense_round_fn(g, lanes=2)).run()
    np.testing.assert_allclose(result.bc, case[3], **TOL)
    rec = result.recovery_stats
    # blocks 1..3 each burn the 2-re-dispatch budget, then recompute clean
    assert rec["quarantined_blocks"] == 9 and rec["fallback_recomputes"] == 3
    assert result.rounds_run == 8


def test_persistent_poison_without_fallback_raises(case):
    drv = _driver(case, poison=range(10), numeric_guard=True, max_retries=0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        drv.run()


@pytest.mark.parametrize("mode", ["audit", "checksum"])
def test_claim_mismatch_quarantined_and_redispatched(case, mode):
    result = _driver(case, integrity=mode, flip=(1,)).run()
    np.testing.assert_allclose(result.bc, case[3], **TOL)
    rec = result.recovery_stats
    assert rec["integrity"]["mode"] == mode
    assert rec["integrity"]["audit_failures"] == 1 and rec["quarantined_blocks"] == 1
    assert rec["retries"] == 1 and result.rounds_run == 8


def test_flip_unnoticed_without_integrity(case):
    result = _driver(case, flip=(1,)).run()
    assert not np.allclose(result.bc, case[3], **TOL)
    assert result.recovery_stats["integrity"]["audit_failures"] == 0


def test_integrity_error_once_the_budget_is_spent(case):
    drv = _driver(case, integrity="audit", flip=range(1, 10), max_retries=1)
    with pytest.raises(IntegrityError, match="no fallback_round_fn"):
        drv.run()
    assert drv.recovery["integrity"]["audit_failures"] == 2


class FakeClock:
    """Time advances only when something sleeps through it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


def test_watchdog_static_escalates_to_replica_lost(case):
    clk = FakeClock()
    drv = _driver(case, stall={0: 50, 1: 50, 2: 50}, sleeper=clk.sleep, clock=clk,
                  dispatch_deadline_s=0.02, max_retries=2)
    with pytest.raises(ReplicaLostError):
        drv.run()
    integ = drv.recovery["integrity"]
    assert (integ["watchdog_trips"], integ["watchdog_redispatches"],
            integ["watchdog_escalations"]) == (3, 2, 1)


def test_recovery_stats_survive_kill_and_resume(tmp_path, case):
    """Detection counters are part of the durable story: the resumed run
    still reports the pre-crash quarantine (tests/test_chaos.py)."""
    path = str(tmp_path / "bc.npz")
    with pytest.raises(Crash):
        _driver(case, integrity="audit", flip=(1,), crash=(4,),
                checkpoint=BCCheckpoint(path), checkpoint_every=1).run()
    resumed = _driver(case, integrity="audit", checkpoint=BCCheckpoint(path)).run()
    np.testing.assert_allclose(resumed.bc, case[3], **TOL)
    rec = resumed.recovery_stats
    assert rec["integrity"]["audit_failures"] == 1 and rec["quarantined_blocks"] == 1
    assert rec["resumed_generation"] == 0
    # calls 0-3 ran blocks 0, 1 (flipped, then re-dispatched) and 2; the
    # crash at call 4 hit block 3, the only one left to run
    assert resumed.rounds_run == 2


# ------------------------------------------------ 2-D, 2×2 gloo grid
@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The port's 2×2 ranks run every 2-D case once; the JAX package
    writes the snapshot they resume first, and resumes theirs after."""
    tmp = tmp_path_factory.mktemp("durable_grid")
    jax_bc(jg.gnp_graph(**worker.SAMPLED_GRAPH), engine_kind="sparse",
           checkpoint=jft.BCCheckpoint(str(tmp / "jax.npz")),
           stop_rule=JaxBlockBudgetStop(1), **SAMPLED)
    return run_gloo(worker.run_cases, 1, 2, 2, (str(tmp),)), tmp


def test_grid_ranks_agree(grid):
    ranks, _ = grid
    for other in ranks[1:]:
        for key in ("partial", "resumed", "from_jax", "for_jax", "exact", "adaptive"):
            np.testing.assert_array_equal(other[key]["bc"], ranks[0][key]["bc"])
            assert other[key]["rounds_run"] == ranks[0][key]["rounds_run"]


def test_grid_kill_and_resume(grid):
    r = grid[0][0]
    total = r["partial"]["rounds_run"] + r["resumed"]["rounds_run"]
    assert r["partial"]["stopped_early"] and r["partial"]["rounds_run"] == 1
    assert total == r["uninterrupted"]["rounds_run"]
    assert r["resumed"]["resumed_generation"] == 0
    np.testing.assert_allclose(r["resumed"]["bc"], r["uninterrupted"]["bc"], **TOL)
    want = jax_bc(jg.gnp_graph(**worker.SAMPLED_GRAPH), engine_kind="sparse", **SAMPLED)
    np.testing.assert_allclose(r["resumed"]["bc"], want.bc, **TOL)


def test_grid_resumes_jax_snapshot(grid):
    r = grid[0][0]
    assert r["from_jax"]["rounds_run"] == r["uninterrupted"]["rounds_run"] - 1
    np.testing.assert_allclose(r["from_jax"]["bc"], r["uninterrupted"]["bc"], **TOL)


def test_jax_resumes_grid_snapshot(grid):
    ranks, tmp = grid
    r = ranks[0]
    assert r["for_jax"]["rounds_run"] == 2
    resumed = jax_bc(jg.gnp_graph(**worker.SAMPLED_GRAPH), engine_kind="sparse",
                     checkpoint=jft.BCCheckpoint(str(tmp / "torch.npz")), **SAMPLED)
    assert resumed.rounds_run == r["uninterrupted"]["rounds_run"] - 2
    np.testing.assert_allclose(resumed.bc, r["uninterrupted"]["bc"], **TOL)


def test_grid_exact_with_checkpoint(grid):
    r = grid[0][0]
    np.testing.assert_allclose(r["exact"]["bc"], brandes_reference(pg.gnp_graph(30, 0.15, seed=13)),
                               rtol=1e-5, atol=1e-5)
    assert BCCheckpoint(str(grid[1] / "exact.npz")).load()[2] == list(
        range(r["exact"]["rounds_run"]))


def test_grid_adaptive_stops_on_one_verdict(grid):
    ranks, _ = grid
    fired = {r["adaptive"]["stop_stats"]["fired_at_block"] for r in ranks}
    assert len(fired) == 1 and None not in fired
    r = ranks[0]["adaptive"]
    assert r["stopped_early"] and r["rounds_run"] == fired.pop()


def test_cli_ckpt_dir_resumes(tmp_path, capsys):
    """``launch/bc.py --ckpt-dir``: the rerun logs the committed rounds and
    runs none of them again (the JAX launcher's "resuming" line)."""
    from repro_torch.launch import bc as cli

    argv = ["--grid", "6x6", "--device", "cpu", "--batch-size", "8", "--ckpt-dir",
            str(tmp_path), "--generations", "2", "--out", str(tmp_path / "bc.npy")]
    cli.main(argv)
    first = capsys.readouterr().out
    assert "resuming" not in first and "5 rounds" in first
    cli.main(argv)
    again = capsys.readouterr().out
    assert "resuming: 5 rounds already committed" in again and "0 rounds" in again
    np.testing.assert_allclose(np.load(tmp_path / "bc.npy"),
                               brandes_reference(pg.grid_graph(6, 6)), rtol=1e-5, atol=1e-5)
    assert sorted(os.listdir(tmp_path)) == ["bc.npy", "grid_6x6.npz", "grid_6x6.npz.g1"]
