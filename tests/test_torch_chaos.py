"""The port's chaos harness (``repro_torch.distributed.chaos``), held against
the JAX package's ``repro.distributed.chaos``: the counterpart of
tests/test_chaos.py.

* ``FaultPlan.parse`` and its queries equal to ``repro``'s on the same
  specs, the rejected ones included; the file seam's seeded tear and
  garble write the same bytes;
* the two-lane matrix on one process (each lane the real dense traversal
  on the CPU; tests/test_chaos.py's harness): transient retries, an
  exhausted budget, poison with and without a fallback, a replica kill
  under steal and redeal, all replicas dead, flip under audit and
  checksum, a deep flip only the duplicate vote catches, a stalled
  dispatch on a fake clock, crash and generational resume, a torn newest
  generation, a garbled cost cache — each with the counters of
  ``repro``'s ``ChaosRoundFn`` and driver on the same graph and BC within
  1e-6 of ``repro``'s and of the oracle;
* the gloo 2×4 and 2×2×2 matrices of tests/test_chaos.py on spawned grids
  (tests/torch_chaos_worker.py, each grid spawned once): every rank ends
  with the same recovery record and BC, within 1e-6 of the oracle; a
  crash, a torn snapshot and a garbled cache written by rank 0 alone; a
  replica kill refused where fr = 1 leaves no replica to re-mesh to.

tests/test_chaos.py's ``Checkpointer`` case (``test_chaos.py:518``) has no
counterpart here: the port has no ``Checkpointer`` yet (ROADMAP Queue 1
item 12).
"""
import logging

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
from repro.core.driver import traversal_round as jax_round
from repro.distributed import chaos as jchaos
from repro.distributed import fault_tolerance as jft
import repro_torch.graphs as pg
from repro_torch.autotune import CostCache, CostRecord
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.core.driver import BCDriver
from repro_torch.core.scheduler import build_schedule
from repro_torch.distributed import BCCheckpoint, run_gloo, schedule_fingerprint
from repro_torch.distributed import chaos as pchaos
from repro_torch.distributed.fault_tolerance import ReplicaLostError, TransientRoundError
from repro_torch.serving import BlockBudgetStop
import torch_chaos_worker as worker

TOL = dict(rtol=1e-6, atol=1e-6)
CPU = torch.device("cpu")
RECOVERY = ("retries", "transient_errors", "quarantined_blocks", "fallback_recomputes",
            "remesh_events", "dead_replicas", "resumed_generation")
INTEGRITY = ("mode", "checksum_failures", "audit_failures", "votes", "vote_mismatches",
             "quarantined_rounds", "watchdog_trips", "watchdog_redispatches",
             "watchdog_escalations")


# ------------------------------------------------------------ fault plans
GOOD_SPECS = [
    "seed=7; transient@1x2, poison@3:inf; kill@4:r1; torn@0; cache@2x2; crash@9",
    "flip@1; flip@2:r1; flip@3:d0; flip@4:neg; stall@5x2; stall@7:120",
    "seed=7;transient@1x2;poison@3:nan;kill@4:r1;flip@5;stall@6:200",
    "", "seed=3",
]
BAD_SPECS = ["bogus@1", "transient", "transient@-1", "kill@2", "poison@1:huge", "transient@1x0",
             "kill@2:one", "flip@1:x3", "flip@1:rr", "stall@2:fast"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plan_parse_and_queries_match_jax(spec):
    got, want = pchaos.FaultPlan.parse(spec), jchaos.FaultPlan.parse(spec)
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.DEFAULT_STALL_MS == jchaos.DEFAULT_STALL_MS
    assert got.seed == want.seed and bool(got) == bool(want) and repr(got) == repr(want)
    assert [_event(e) for e in got.events] == [_event(e) for e in want.events]
    for tick in range(12):
        for query in ("transient_at", "poison_at", "crash_at", "killed_replicas", "flip_at",
                      "stall_ms", "torn_save", "corrupt_cache_put"):
            assert getattr(got, query)(tick) == getattr(want, query)(tick), (query, tick)
    again = pchaos.FaultPlan.parse(repr(got)[len("FaultPlan("):-1])  # repr round-trips
    assert again.events == got.events and again.seed == got.seed
    assert pchaos.FaultPlan.parse(got) is got and not pchaos.FaultPlan.parse(None)


def _event(e):
    return (e.kind, e.at, e.count, e.arg)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jchaos.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        pchaos.FaultPlan.parse(spec)


def test_chaos_crash_is_not_an_exception():
    assert issubclass(pchaos.ChaosCrash, BaseException)
    assert not issubclass(pchaos.ChaosCrash, Exception)


def test_file_seam_writes_the_bytes_jax_writes(tmp_path):
    data = bytes(range(256)) * 8
    for name in ("p", "j", "p2"):
        (tmp_path / name).write_bytes(data)
    pchaos.ChaosFS(pchaos.FaultPlan.parse("seed=9")).tear_file(tmp_path / "p")
    pchaos.ChaosFS(pchaos.FaultPlan.parse("seed=9")).tear_file(tmp_path / "p2")
    jchaos.ChaosFS(jchaos.FaultPlan.parse("seed=9")).tear_file(tmp_path / "j")
    torn = (tmp_path / "p").read_bytes()
    assert torn == (tmp_path / "j").read_bytes() == (tmp_path / "p2").read_bytes()
    assert 0 < len(torn) < len(data)
    fs, jfs = pchaos.ChaosFS("seed=4"), jchaos.ChaosFS("seed=4")
    fs.garble_file(tmp_path / "p")
    jfs.garble_file(tmp_path / "j")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    assert fs.files_corrupted == [str(tmp_path / "p")]


# ------------------------------------------------ two-lane driver matrix
class Case:
    """One graph's schedule and two-lane round functions in both packages
    (tests/test_chaos.py's harness: each lane the real dense traversal)."""

    def __init__(self, make, batch):
        self.g, jgraph = make(pg), make(jg)
        self.schedule, self.prep, residual, omega = build_schedule(self.g, batch_size=batch)
        self.jschedule, self.jprep, _, _ = jsched.build_schedule(jgraph, batch_size=batch)
        self.op = pbc.make_operator(residual, "dense", CPU)
        self.omega = torch.from_numpy(omega).float()
        self.adjacency = jnp.asarray(jgraph.dense_adjacency(np.float32))
        self.want = brandes_reference(self.g)
        self._jax = {}

    def port_fn(self, integrity="off"):
        return pbc.make_round_fn(self.op, self.omega, integrity=integrity)

    def jax_fn(self, integrity="off"):
        if integrity not in self._jax:
            omega = jnp.zeros(self.g.n, jnp.float32)
            base = jax.jit(lambda s, d: jax_round(jengine.make_dense_operator(self.adjacency),
                                                  s, d, omega, integrity=integrity))

            def fn(sources, derived):
                outs = [base(sources[r], derived[r]) for r in range(sources.shape[0])]
                return tuple(jnp.stack([o[i] for o in outs]) for i in range(len(outs[0])))

            self._jax[integrity] = fn
        return self._jax[integrity]


@pytest.fixture(scope="module")
def skewed():
    case = Case(lambda m: m.skewed_depth_graph(4, 8), 8)  # 8 rounds at batch 8
    assert len(case.schedule.rounds) == 8
    return case


@pytest.fixture(scope="module")
def odd():
    case = Case(lambda m: m.gnp_graph(20, 0.25, seed=5), 4)  # 5 rounds: a tail duplicate
    assert len(case.schedule.rounds) == 5
    return case


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds


def _run(case, spec, *, fallback=False, fake_clock=False, **kw):
    """The plan on both packages' two-lane drivers: ``(port, jax)`` pairs of
    ``(result or exception, driver, chaos wrapper)``."""
    kw.setdefault("retry_backoff_s", 1e-4)
    integrity = kw.get("integrity", "off")
    out = []
    for port in (True, False):
        clk = FakeClock() if fake_clock else None
        fn = case.port_fn(integrity) if port else case.jax_fn(integrity)
        mod = pchaos if port else jchaos
        chaos = mod.ChaosRoundFn(fn, mod.FaultPlan.parse(spec),
                                 sleeper=clk.sleep if clk else None)
        extra = dict(kw, fallback_round_fn=fn if fallback else None)
        if clk:
            extra.update(clock=clk, sleeper=clk.sleep)
        drv = (BCDriver(chaos, case.schedule, n=case.g.n, device=CPU, prep=case.prep,
                        rounds_per_dispatch=2, **extra) if port else
               JaxBCDriver(chaos, case.jschedule, n=case.g.n, prep=case.jprep,
                           rounds_per_dispatch=2, **extra))
        try:
            res = drv.run()
        except (Exception, pchaos.ChaosCrash, jchaos.ChaosCrash) as e:
            res = e
        out.append((res, drv, chaos))
    return out


def _same_record(got_rec, want_rec):
    for k in RECOVERY:
        assert got_rec[k] == want_rec[k], k
    for k in INTEGRITY:
        assert got_rec["integrity"][k] == want_rec["integrity"][k], k


def _parity(case, spec, **kw):
    """Both packages recover alike: BC (1e-6 of each other and of the
    oracle), rounds run, every recovery counter and the dispatch count."""
    (got, drv, chaos), (want, jdrv, jchaos_fn) = _run(case, spec, **kw)
    assert not isinstance(got, BaseException), got
    np.testing.assert_allclose(got.bc, case.want, **TOL)
    np.testing.assert_allclose(got.bc, np.asarray(want.bc), **TOL)
    assert got.rounds_run == want.rounds_run == len(case.schedule.rounds)
    _same_record(got.recovery_stats, want.recovery_stats)
    assert chaos.calls == jchaos_fn.calls
    return got, drv


def _committed(drv):
    return sorted(r for led in drv.ledgers for r in led.state())


def test_transient_rounds_are_retried(skewed):
    got, _ = _parity(skewed, "transient@1x2")
    assert got.recovery_stats["transient_errors"] == 2 == got.recovery_stats["retries"]


def test_transient_budget_exhausted_raises(skewed):
    (got, drv, _), (want, jdrv, _) = _run(skewed, "transient@0x5", max_retries=1)
    assert isinstance(got, TransientRoundError) and isinstance(want, jft.TransientRoundError)
    assert drv.recovery["retries"] == jdrv.recovery["retries"] == 1


def test_poison_block_quarantined_and_recovered(skewed):
    got, _ = _parity(skewed, "poison@1", numeric_guard=True)
    rec = got.recovery_stats
    assert rec["quarantined_blocks"] == 1 and rec["retries"] == 1
    assert rec["fallback_recomputes"] == 0


def test_persistent_poison_falls_back_to_the_clean_round_fn(skewed):
    got, _ = _parity(skewed, "poison@1x100", fallback=True)  # the guard is on: a fallback
    rec = got.recovery_stats
    assert rec["quarantined_blocks"] == 9 and rec["fallback_recomputes"] == 3


def test_persistent_poison_without_fallback_raises(skewed):
    (got, _, _), (want, _, _) = _run(skewed, "poison@0x10", numeric_guard=True, max_retries=0)
    assert isinstance(got, FloatingPointError) and isinstance(want, FloatingPointError)
    assert "non-finite" in str(got)


@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_replica_kill_triggers_remesh_and_parity(skewed, policy):
    got, drv = _parity(skewed, "kill@1:r1", straggler=policy, prior_round_s=1e-3)
    assert got.recovery_stats["remesh_events"] == 1
    assert got.recovery_stats["dead_replicas"] == [1]
    assert _committed(drv) == list(range(8))


def test_all_replicas_dead_reraises(skewed):
    (got, drv, _), (want, jdrv, _) = _run(skewed, "kill@0:r0;kill@0:r1", straggler="steal")
    assert isinstance(got, ReplicaLostError) and isinstance(want, jft.ReplicaLostError)
    assert drv.recovery["remesh_events"] == jdrv.recovery["remesh_events"] == 1


@pytest.mark.parametrize("mode", ["audit", "checksum"])
@pytest.mark.parametrize("spec", ["flip@1", "flip@1:neg", "flip@1:r1"])
def test_flip_detected_quarantined_and_redispatched(skewed, mode, spec):
    got, _ = _parity(skewed, spec, integrity=mode)
    integ = got.recovery_stats["integrity"]
    assert integ["mode"] == mode and integ["checksum_failures"] + integ["audit_failures"] >= 1
    assert got.recovery_stats["quarantined_blocks"] >= 1


def test_flip_unnoticed_without_integrity(skewed):
    (got, _, _), (want, _, _) = _run(skewed, "flip@1")
    assert not np.allclose(got.bc, skewed.want, **TOL)
    np.testing.assert_allclose(got.bc, np.asarray(want.bc), **TOL)  # the same wrong answer
    assert got.recovery_stats["integrity"]["audit_failures"] == 0


def test_deep_flip_caught_only_by_the_duplicate_vote(odd):
    got, drv = _parity(odd, "flip@2:d1", straggler="steal", prior_round_s=1e-3,
                       integrity="checksum")
    integ = got.recovery_stats["integrity"]
    assert integ["votes"] >= 2 and integ["vote_mismatches"] >= 1
    assert integ["quarantined_rounds"] >= 1
    assert any(v["matched"] == "owner" for v in integ["vote_verdicts"])
    assert integ["checksum_failures"] == 0 and integ["audit_failures"] == 0
    assert _committed(drv) == list(range(5))


def test_watchdog_static_escalates_to_replica_lost(skewed):
    (got, drv, _), (want, jdrv, _) = _run(
        skewed, "stall@0x3:50", fake_clock=True, dispatch_deadline_s=0.02, max_retries=2)
    assert isinstance(got, ReplicaLostError) and isinstance(want, jft.ReplicaLostError)
    for d in (drv, jdrv):
        integ = d.recovery["integrity"]
        assert (integ["watchdog_trips"], integ["watchdog_redispatches"],
                integ["watchdog_escalations"]) == (3, 2, 1)


def test_watchdog_stall_escalates_into_remesh_and_parity(skewed):
    got, drv = _parity(skewed, "stall@0x3:50", fake_clock=True, dispatch_deadline_s=0.02,
                       max_retries=2, straggler="steal", prior_round_s=1e-3, integrity="audit")
    integ = got.recovery_stats["integrity"]
    assert integ["watchdog_trips"] == 3 and integ["watchdog_escalations"] == 1
    assert got.recovery_stats["remesh_events"] == 1 and _committed(drv) == list(range(8))


def _ckpt_driver(case, spec, ckpt, port=True, integrity="off"):
    mod = pchaos if port else jchaos
    fn = case.port_fn(integrity) if port else case.jax_fn(integrity)
    round_fn = mod.ChaosRoundFn(fn, mod.FaultPlan.parse(spec)) if spec else fn
    kw = dict(rounds_per_dispatch=2, straggler="redeal", checkpoint=ckpt, checkpoint_every=1,
              integrity=integrity, retry_backoff_s=1e-4)
    if port:
        return BCDriver(round_fn, case.schedule, n=case.g.n, device=CPU, prep=case.prep, **kw)
    return JaxBCDriver(round_fn, case.jschedule, n=case.g.n, prep=case.jprep, **kw)


def test_crash_and_generational_resume(tmp_path, skewed):
    runs = {}
    for port, Ckpt, Crash in ((True, BCCheckpoint, pchaos.ChaosCrash),
                              (False, JaxBCCheckpoint, jchaos.ChaosCrash)):
        path = str(tmp_path / f"{port}.npz")
        with pytest.raises(Crash):
            _ckpt_driver(skewed, "crash@2", Ckpt(path), port).run()
        assert (tmp_path / f"{port}.npz.g1").exists()  # two snapshots rotated
        resumed = _ckpt_driver(skewed, None, Ckpt(path), port).run()
        third = _ckpt_driver(skewed, None, Ckpt(path), port).run()
        runs[port] = (resumed, third)
    for (resumed, third) in runs.values():
        np.testing.assert_allclose(resumed.bc, skewed.want, **TOL)
        np.testing.assert_allclose(third.bc, skewed.want, **TOL)
        assert resumed.rounds_run == 4 and third.rounds_run == 0  # blocks 0 and 1 survived
        assert resumed.recovery_stats["resumed_generation"] == 0


def test_integrity_stats_survive_crash_and_resume(tmp_path, skewed):
    for port, Ckpt, Crash in ((True, BCCheckpoint, pchaos.ChaosCrash),
                              (False, JaxBCCheckpoint, jchaos.ChaosCrash)):
        path = str(tmp_path / f"{port}.npz")
        with pytest.raises(Crash):
            _ckpt_driver(skewed, "flip@1;crash@4", Ckpt(path), port, "audit").run()
        resumed = _ckpt_driver(skewed, None, Ckpt(path), port, "audit").run()
        np.testing.assert_allclose(resumed.bc, skewed.want, **TOL)
        rec = resumed.recovery_stats
        assert rec["integrity"]["audit_failures"] == 1 and rec["quarantined_blocks"] == 1
        assert resumed.rounds_run < 8


def test_generation_fallback_after_a_torn_newest_save(tmp_path, skewed, caplog):
    """A ChaosCheckpoint tears the save the plan names; the next load falls
    back a generation (and the JAX package reads the same files alike)."""
    fp = schedule_fingerprint(skewed.g.n, skewed.schedule)
    fs = pchaos.ChaosFS("seed=3;torn@1")
    ckpt = pchaos.ChaosCheckpoint(BCCheckpoint(str(tmp_path / "bc.npz")), fs)
    ckpt.save(np.ones(skewed.g.n), {}, [0], fp)
    ckpt.save(np.full(skewed.g.n, 2.0), {}, [0, 1], fp)
    assert fs.checkpoint_saves == 2 and fs.files_corrupted == [str(tmp_path / "bc.npz")]
    for Ckpt in (BCCheckpoint, JaxBCCheckpoint):
        loader = Ckpt(str(tmp_path / "bc.npz"))
        with caplog.at_level(logging.WARNING):
            bc, _, committed = loader.load(fp)
        assert loader.loaded_generation == 1 and committed == [0]
        np.testing.assert_array_equal(bc, np.ones(skewed.g.n))
    drv = BCDriver(skewed.port_fn(), skewed.schedule, n=skewed.g.n, device=CPU,
                   rounds_per_dispatch=2, checkpoint=BCCheckpoint(str(tmp_path / "bc.npz")))
    assert drv.recovery["resumed_generation"] == 1


def test_all_generations_corrupt_cold_start(tmp_path, skewed):
    fp = schedule_fingerprint(skewed.g.n, skewed.schedule)
    ckpt = BCCheckpoint(str(tmp_path / "bc.npz"))
    ckpt.save(np.ones(skewed.g.n), {}, [0], fp)
    ckpt.save(np.ones(skewed.g.n), {}, [0, 1], fp)
    fs = pchaos.ChaosFS("seed=4")
    fs.garble_file(tmp_path / "bc.npz")
    fs.garble_file(tmp_path / "bc.npz.g1")
    bc, ns, committed = ckpt.load(fp)  # never a traceback
    assert bc is None and ns == {} and committed == [] and ckpt.loaded_generation is None
    result = BCDriver(skewed.port_fn(), skewed.schedule, n=skewed.g.n, device=CPU,
                      prep=skewed.prep, rounds_per_dispatch=2, checkpoint=ckpt).run()
    np.testing.assert_allclose(result.bc, skewed.want, **TOL)
    assert result.rounds_run == 8 and result.recovery_stats["resumed_generation"] is None


def test_chaos_cost_cache_garbles_the_named_put(tmp_path, caplog):
    path = str(tmp_path / "cache.json")
    fs = pchaos.ChaosFS("seed=2;cache@1")
    cache = pchaos.ChaosCostCache(path, fs)
    assert isinstance(cache, CostCache)  # the planner takes it unchanged
    cache.put("g", "c0", CostRecord(0.1))  # put 0: intact
    assert CostCache(path).num_records() == 1
    cache.put("g", "c1", CostRecord(0.2))  # put 1: garbled after the write
    assert fs.cache_puts == 2 and fs.files_corrupted == [path]
    with caplog.at_level(logging.WARNING, logger="repro_torch.autotune.cache"):
        assert CostCache(path).num_records() == 0  # starts empty, no traceback
    assert any("unreadable" in r.getMessage() for r in caplog.records)


# ------------------------------------------------- gloo grid matrices
G24 = lambda m: m.gnp_graph(24, 0.2, seed=3)  # noqa: E731  tests/test_chaos.py's graphs
G20 = lambda m: m.gnp_graph(20, 0.25, seed=5)  # noqa: E731
UNION = lambda m: m.disjoint_union(m.path_graph(40), m.gnp_graph(16, 0.3, seed=4))  # noqa: E731
SAMPLED = dict(batch_size=8, sampling="fixed", sample_frac=1.0)  # a stop rule may cut it

GRID_2X4 = {
    "transient-poison": (G24, dict(batch_size=8, chaos="seed=5;transient@1x2;poison@3:nan",
                                   retry_backoff_s=1e-3)),
    "flip-sparse-none": (G24, dict(batch_size=8, engine_kind="sparse", overlap="none",
                                   integrity="checksum", chaos="seed=5;flip@1",
                                   retry_backoff_s=1e-3)),
    "flip-fused-expand": (G24, dict(batch_size=8, engine_kind="fused", overlap="expand",
                                    integrity="checksum", chaos="seed=5;flip@1",
                                    retry_backoff_s=1e-3)),
    "kill-refused": (G24, dict(batch_size=8, chaos="seed=1;kill@1:r0")),
}
GRID_2X2X2 = {
    "kill": (UNION, dict(batch_size=8, overlap="expand", straggler="steal",
                         chaos="seed=1;kill@1:r1", retry_backoff_s=1e-3)),
    "deep-flip": (UNION, dict(batch_size=8, straggler="steal", integrity="checksum",
                              chaos="seed=1;flip@3:d1", retry_backoff_s=1e-3)),
    "stall": (G20, dict(batch_size=4, straggler="steal", integrity="audit",
                        chaos="seed=13;stall@0x3:200", dispatch_deadline_s=0.05, max_retries=2,
                        retry_backoff_s=1e-3, fake_clock=True)),
}


@pytest.fixture(scope="module")
def grid_2x4(tmp_path_factory):
    """The 2×4 matrix, then on one checkpoint: a first block, a crash, a
    save torn after its write, a resume; on one cost cache: a measured
    plan whose last put is garbled, then a "cache" plan on the file."""
    tmp = tmp_path_factory.mktemp("chaos_grid")
    ckpt, cache = BCCheckpoint(str(tmp / "bc.npz")), str(tmp / "tune.json")
    g = G24(pg)
    cases = [(name, make(pg), kw) for name, (make, kw) in GRID_2X4.items()] + [
        ("ckpt-first", g, dict(SAMPLED, checkpoint=ckpt, stop_rule=BlockBudgetStop(1))),
        ("ckpt-crash", g, dict(SAMPLED, checkpoint=ckpt, chaos="crash@1")),
        ("ckpt-torn", g, dict(SAMPLED, checkpoint=ckpt, chaos="seed=3;torn@0",
                              stop_rule=BlockBudgetStop(1))),
        ("ckpt-resume", g, dict(SAMPLED, checkpoint=ckpt)),
        ("cache-garbled", g, dict(batch_size=8, overlap="auto", autotune="measure",
                                  autotune_cache=cache, chaos="seed=2;cache@2")),
        ("cache-after", g, dict(batch_size=8, overlap="auto", autotune="cache",
                                autotune_cache=cache)),
    ]
    return run_gloo(worker.run_cases, 1, 2, 4, (cases,), timeout_s=300)


@pytest.fixture(scope="module")
def grid_2x2x2():
    cases = [(name, make(pg), kw) for name, (make, kw) in GRID_2X2X2.items()]
    return run_gloo(worker.run_cases, 2, 2, 2, (cases,), timeout_s=300)


GRID_CASES = ([("2x4", n) for n in GRID_2X4] + [("2x2x2", n) for n in GRID_2X2X2]
              + [("2x4", n) for n in ("ckpt-first", "ckpt-crash", "ckpt-torn", "ckpt-resume",
                                      "cache-garbled", "cache-after")])


@pytest.mark.parametrize("mesh, case", GRID_CASES, ids=lambda x: x)
def test_every_rank_sees_the_same_faults(request, mesh, case):
    """Every rank makes the same dispatch calls, poison and flip hit outputs
    every rank holds, and rank 0's file counters are sent to all: the
    same recovery record (chaos counters included) and BC on every rank."""
    ranks = request.getfixturevalue(f"grid_{mesh}")
    want = ranks[0][case]
    for other in ranks[1:]:
        got = other[case]
        if "error" in want:
            assert got == want
            continue
        np.testing.assert_array_equal(got["bc"], want["bc"])
        assert got["recovery"] == want["recovery"] and got["report"] == want["report"]


def _oracle(make):
    return brandes_reference(make(pg))


def test_grid_2x4_transient_and_poison_healed(grid_2x4):
    got = grid_2x4[0]["transient-poison"]
    np.testing.assert_allclose(got["bc"], _oracle(G24), **TOL)
    rec = got["recovery"]
    assert rec["transient_errors"] == 2 and rec["quarantined_blocks"] >= 1
    assert got["rounds_run"] == got["num_rounds"]
    assert rec["chaos"]["dispatch_calls"] > got["num_rounds"]


@pytest.mark.parametrize("case", ["flip-sparse-none", "flip-fused-expand"])
def test_grid_2x4_flip_detected_and_recomputed(grid_2x4, case):
    got = grid_2x4[0][case]
    np.testing.assert_allclose(got["bc"], _oracle(G24), **TOL)
    integ = got["recovery"]["integrity"]
    assert integ["checksum_failures"] + integ["audit_failures"] >= 1
    assert got["recovery"]["quarantined_blocks"] >= 1
    assert got["rounds_run"] == got["num_rounds"] and integ["max_checksum_residual"] < 1e-3


def test_grid_without_replicas_refuses_a_replica_kill(grid_2x4):
    """fr = 1: no replica to re-mesh to, so the loss ends the run on every
    rank (the JAX package's ``test_all_replicas_dead_reraises``)."""
    got = grid_2x4[0]["kill-refused"]
    assert got["error"] == "ReplicaLostError" and "replica 0 lost" in got["message"]


def test_grid_crash_torn_save_and_generational_resume(grid_2x4):
    """Rank 0 alone writes the snapshot: a crash is not retried and leaves
    the grid able to run on, a save torn after rank 0's write falls back
    one generation on every rank, and the resumed run is exact."""
    ranks = grid_2x4[0]
    first, crash, torn, resumed = (ranks[k] for k in ("ckpt-first", "ckpt-crash", "ckpt-torn",
                                                       "ckpt-resume"))
    assert first["rounds_run"] == 1
    assert crash["error"] == "ChaosCrash" and "dispatch 1" in crash["message"]
    assert torn["rounds_run"] == 1 and torn["recovery"]["resumed_generation"] == 0
    assert torn["recovery"]["chaos"]["checkpoint_saves"] == 1
    assert torn["recovery"]["chaos"]["files_corrupted"][0].endswith("bc.npz")
    assert resumed["recovery"]["resumed_generation"] == 1  # the torn newest was skipped
    assert resumed["rounds_run"] == resumed["num_rounds"] - 1
    np.testing.assert_allclose(resumed["bc"], _oracle(G24), **TOL)


def test_grid_garbled_cost_cache_starts_empty(grid_2x4):
    garbled, after = grid_2x4[0]["cache-garbled"], grid_2x4[0]["cache-after"]
    assert garbled["report"]["measured"] == 3 and garbled["recovery"]["chaos"]["cache_puts"] == 3
    assert len(garbled["recovery"]["chaos"]["files_corrupted"]) == 1
    assert after["report"]["hits"] == 0 and after["report"]["misses"] == 3
    for got in (garbled, after):
        np.testing.assert_allclose(got["bc"], _oracle(G24), **TOL)


def test_grid_2x2x2_replica_kill_remeshed(grid_2x2x2):
    got = grid_2x2x2[0]["kill"]
    np.testing.assert_allclose(got["bc"], _oracle(UNION), **TOL)
    rec = got["recovery"]
    assert rec["remesh_events"] == 1 and rec["dead_replicas"] == [1]
    assert got["rounds_run"] == got["num_rounds"]
    assert rec["chaos"]["plan"].startswith("FaultPlan(")


def test_grid_2x2x2_deep_flip_caught_by_the_vote(grid_2x2x2):
    got = grid_2x2x2[0]["deep-flip"]
    np.testing.assert_allclose(got["bc"], _oracle(UNION), **TOL)
    integ = got["recovery"]["integrity"]
    assert integ["votes"] >= 1 and integ["vote_mismatches"] >= 1
    assert integ["checksum_failures"] == 0 and integ["audit_failures"] == 0
    assert got["rounds_run"] == got["num_rounds"]


def test_grid_2x2x2_stall_tripped_and_remeshed(grid_2x2x2):
    got = grid_2x2x2[0]["stall"]
    np.testing.assert_allclose(got["bc"], _oracle(G20), **TOL)
    rec = got["recovery"]
    assert rec["integrity"]["watchdog_trips"] >= 3
    assert rec["integrity"]["watchdog_escalations"] >= 1 and rec["remesh_events"] >= 1
    assert got["rounds_run"] == got["num_rounds"]
