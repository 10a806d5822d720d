"""The port's measured-cost autotuner (``repro_torch.autotune`` and its four
choice seams), held against the JAX package's ``repro.autotune`` on the
same inputs, and on a spawned gloo grid against the oracle and ``repro``.

* keys, the tile menu, the cache file (round trip, both packages reading
  each other's file, corrupt and foreign files) and ``measure_walls`` on a
  fake clock equal to ``repro``'s;
* ``plan_autotune`` on one injected fake bench (the port's engine names
  mapped to ``repro``'s through ``REFERENCE_DIST_ENGINE``): the same
  ``TunePlan.report()`` as ``repro``'s under "off", "cache" and "measure",
  with an empty or a filled cache, the roofline fallback of the tile
  included;
* each seam with ``measured=`` makes ``repro``'s pick;
* one 2×2×2 gloo grid (tests/torch_autotune_worker.py, spawned once):
  "measure" then "cache" on one cache file, against the oracle and
  ``repro``'s BC at 1e-6, the cache run measuring nothing, picking alike
  and giving bit-equal BC; every rank plans alike when each rank's bench
  returns other walls, and without the all-ranks agreement the ranks'
  plans differ (the mutation check).
"""
import json
import logging

import jax
import numpy as np
import pytest

import repro.autotune as jat
import repro.graphs as jg
from repro.core import distributed as jdist
from repro.core import scheduler as jsched
from repro.graphs.partition import partition_2d as jax_partition_2d
from repro.launch.mesh import make_mesh
from repro.roofline import model as jmodel
import repro_torch.autotune as pat
import repro_torch.graphs as pg
from repro_torch.core import brandes_reference
from repro_torch.core import distributed as pdist
from repro_torch.core.operators import OVERLAP_POLICIES
from repro_torch.core.scheduler import build_schedule
from repro_torch.distributed import run_gloo
from repro_torch.graphs.partition import partition_2d
from repro_torch.roofline import model as pmodel
import torch_autotune_worker as worker

TOL = dict(rtol=1e-6, atol=1e-6)
ENGINES = ("sparse", "fused", "fused_sparse", "fused_hybrid")
JAX_ENGINE = pdist.REFERENCE_DIST_ENGINE
# (graph, R, C): the planner fixture of tests/test_autotune.py (chunk 16:
# tiles 16 and 8), a skewed R-MAT and a lattice whose chunk has no
# multiple of 8
PARTS = {
    "gnp64-2x2": (lambda m: m.gnp_graph(64, 0.15, seed=5), 2, 2),
    "rmat8-2x4": (lambda m: m.rmat_graph(8, 8, seed=0), 2, 4),
    "grid5x6-1x2": (lambda m: m.grid_graph(5, 6), 1, 2),
}


def _parts(name):
    make, R, C = PARTS[name]
    g, jgraph = make(pg), make(jg)
    return g, partition_2d(g, R, C), jgraph, jax_partition_2d(jgraph, R, C)


# ------------------------------------------------------- keys and cache
@pytest.mark.parametrize("name", sorted(PARTS))
@pytest.mark.parametrize("fr, nnz_tiles", [(1, 0), (2, 7)])
def test_keys_and_tile_menu_match_jax(name, fr, nnz_tiles):
    g, part, jgraph, jpart = _parts(name)
    got = pat.graph_key_for(part, g, fr=fr, nnz_tiles=nnz_tiles)
    assert got == jat.graph_key_for(jpart, jgraph, fr=fr, nnz_tiles=nnz_tiles)
    assert pat.graph_key_for(part, fr=fr) == jat.graph_key_for(jpart, fr=fr)  # no graph: skew 1
    assert part.tile_candidates() == jpart.tile_candidates()
    assert part.tile_candidates(limit=1) == jpart.tile_candidates(limit=1)
    assert part.tile_candidates()[0] == (pg.partition.default_tile_dim(part.chunk),) * 2
    for tile in (None, (8, 4)):
        for ov in OVERLAP_POLICIES:
            assert pat.config_key("fused_sparse", ov, 16, tile) == jat.config_key(
                "fused_sparse", ov, 16, tile)
    assert pat.graph_key(32, 100, R=2, C=4, fr=2, nnz_tiles=7, degree_skew=3.14) == (
        "n32_m100_r2x4x2_t7_k3.1")


def test_normalize_autotune_matches_jax():
    assert pat.AUTOTUNE_MODES == jat.AUTOTUNE_MODES
    for mode in (None,) + pat.AUTOTUNE_MODES:
        assert pat.normalize_autotune(mode) == jat.normalize_autotune(mode)
    for bad in ("on", "bogus"):
        with pytest.raises(ValueError, match="autotune"):
            jat.normalize_autotune(bad)
        with pytest.raises(ValueError, match="autotune"):
            pat.normalize_autotune(bad)


def test_cache_round_trip_and_both_packages_read_each_others_file(tmp_path):
    path = tmp_path / "tune.json"
    cache = pat.CostCache(path)
    gkey, ckey = pat.graph_key(32, 100, R=2, C=4), pat.config_key("fused", "none", 16)
    assert cache.get(gkey, ckey) is None and cache.misses == 1
    rec = pat.CostRecord(level_s=0.25, levels=4, walls=(2.0, 2.1))
    cache.put(gkey, ckey, rec)
    assert cache.stores == 1 and path.exists() and cache.get(gkey, ckey) == rec
    again = pat.CostCache(path)
    assert again.get(gkey, ckey) == rec and again.stats() == {
        "path": str(path), "records": 1, "hits": 1, "misses": 0, "stores": 0}
    obj = json.loads(path.read_text())
    assert obj["version"] == pat.cache.CACHE_VERSION == jat.cache.CACHE_VERSION
    # the JAX package reads the port's file, record for record
    jrec = jat.CostCache(path).get(gkey, ckey)
    assert (jrec.level_s, jrec.levels, jrec.walls) == (rec.level_s, rec.levels, rec.walls)
    # and the port reads the JAX package's; its pallas* configs never hit
    jpath = tmp_path / "jax.json"
    jcache = jat.CostCache(jpath)
    jcache.put(gkey, jat.config_key("pallas", "none", 16), jat.CostRecord(level_s=0.5))
    port = pat.CostCache(jpath)
    assert port.num_records() == 1 and port.get(gkey, ckey) is None
    mem = pat.CostCache(None)
    mem.put("g", "c", pat.CostRecord(level_s=1.0))
    assert mem.num_records() == 1 and mem.stats()["path"] is None
    assert pat.as_cache(mem) is mem and pat.as_cache(None).path is None


CORRUPT = {
    "garbage": (b"{not json", "unreadable"),
    "bytes": (b"\x00{{{garbage\xff", "unreadable"),
    "version": (json.dumps({"version": 999, "entries": {"g": {}}}).encode(), "version"),
    "shape": (json.dumps([1, 2]).encode(), "version"),
    "malformed": (json.dumps({"version": 1, "entries": {
        "g_good": {"cfg": {"level_s": 0.5}}, "g_bad": {"cfg": {"nope": 1}}}}).encode(),
        "malformed"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_cache_tolerates_corrupt_and_foreign_files(tmp_path, caplog, kind):
    data, words = CORRUPT[kind]
    path = tmp_path / "tune.json"
    path.write_bytes(data)
    with caplog.at_level(logging.WARNING, logger="repro_torch.autotune.cache"):
        cache = pat.CostCache(path)
    assert cache.num_records() == jat.CostCache(path).num_records() == (kind == "malformed")
    assert any(words in r.getMessage() for r in caplog.records
               if r.name == "repro_torch.autotune.cache")
    cache.put("g", "c", pat.CostRecord(level_s=1.0))  # still writable: a fresh start
    assert pat.CostCache(path).get("g", "c") == pat.CostRecord(level_s=1.0)


def test_measure_walls_fake_clock_matches_jax():
    walls = {}
    for mod in (pat, jat):
        ticks = iter(float(t * t) for t in range(100))
        runs = []
        walls[mod] = mod.measure_walls(lambda: runs.append(1), clock=lambda: next(ticks),
                                       warmup=1, iters=3)
        assert len(runs) == 4  # one warm-up, three timed
    assert walls[pat] == walls[jat] == [1.0, 5.0, 9.0]
    assert (pat.MEASURE_LEVELS, pat.measure.MEASURE_ITERS, pat.measure.MEASURE_WARMUP) == (
        jat.MEASURE_LEVELS, jat.measure.MEASURE_ITERS, jat.measure.MEASURE_WARMUP)


def test_sample_batch_matches_jax():
    for fr in (1, 2, 3):
        sched = build_schedule(pg.gnp_graph(20, 0.2, seed=4), batch_size=8)[0]
        jsched_ = jsched.build_schedule(jg.gnp_graph(20, 0.2, seed=4), batch_size=8)[0]
        for got, want in zip(pat.sample_batch(sched, fr), jat.sample_batch(jsched_, fr)):
            np.testing.assert_array_equal(got, want)
    assert pat.Candidate("sparse", "none", 8).key() == "sparse|none|b8|t-"


@pytest.mark.parametrize("make", [
    lambda m: m.rmat_graph(9, 4, seed=1),  # hundreds of isolated vertices
    lambda m: m.disjoint_union(m.path_graph(9), m.star_graph(5), m.gnp_graph(30, 0.1, seed=2)),
], ids=["rmat9", "union"])
def test_eccentricity_order_matches_jax_on_many_components(make):
    """Autotune packs rounds by eccentricity: the port's frontier-list search
    (linear in a component's size) finds the JAX package's depths, landmarks
    and schedule on graphs of many components."""
    g, jgraph = make(pg), make(jg)
    from repro_torch.core import scheduler as psched

    for root in (0, g.n // 2, g.n - 1):
        np.testing.assert_array_equal(psched.bfs_depths(g, root), jsched.bfs_depths(jgraph, root))
    for seed in (0, 3):
        np.testing.assert_array_equal(psched.estimate_eccentricities(g, seed=seed),
                                      jsched.estimate_eccentricities(jgraph, seed=seed))
    got = build_schedule(g, batch_size=16, root_order="eccentricity")[0]
    want = jsched.build_schedule(jgraph, batch_size=16, root_order="eccentricity")[0]
    np.testing.assert_array_equal(got.round_depths, want.round_depths)
    for a, b in zip(got.rounds, want.rounds):
        np.testing.assert_array_equal(a.sources, b.sources)


# ------------------------------------------------ the planner, fake bench
def _cost(engine, overlap, tile):
    """A fake per-level wall of a configuration, by the JAX package's name."""
    cost = {"pallas": 3.0, "pallas_sparse": 1.0, "pallas_hybrid": 2.0, "sparse": 4.0}[engine]
    cost += {"none": 0.3, "expand": 0.2, "expand+fold": 0.1}[overlap]
    return cost + (0.0 if tile is None else 0.01 * abs(tile[0] - 8))


def _bench(calls, port: bool):
    def bench(cand):
        engine = JAX_ENGINE[cand.engine_kind] if port else cand.engine_kind
        calls.append((engine, cand.overlap, cand.tile))
        c = _cost(engine, cand.overlap, cand.tile)
        rec = pat.CostRecord if port else jat.CostRecord
        return rec(level_s=c, levels=4, walls=(8 * c, 8 * c + 1))
    return bench


def _plans(name, engine, overlap, mode, prefill, tile=None):
    g, part, jgraph, jpart = _parts(name)
    caches, calls = (pat.CostCache(None), jat.CostCache(None)), ([], [])
    kw = dict(overlap=overlap, batch_size=16, tile=tile)
    if prefill:  # a measured run of another schedule first: partial hits
        pat.plan_autotune(part, engine_kind=engine, mode="measure", cache=caches[0], graph=g,
                          bench=_bench([], True), **dict(kw, overlap="expand"))
        jat.plan_autotune(jpart, engine_kind=JAX_ENGINE[engine], mode="measure",
                          cache=caches[1], graph=jgraph, bench=_bench([], False),
                          **dict(kw, overlap="expand"))
    got = pat.plan_autotune(part, engine_kind=engine, mode=mode, cache=caches[0], graph=g,
                            bench=_bench(calls[0], True), **kw)
    want = jat.plan_autotune(jpart, engine_kind=JAX_ENGINE[engine], mode=mode,
                             cache=caches[1], graph=jgraph, bench=_bench(calls[1], False), **kw)
    return got, want, calls


@pytest.mark.parametrize("prefill", [False, True], ids=["cold", "filled"])
@pytest.mark.parametrize("mode", pat.AUTOTUNE_MODES)
@pytest.mark.parametrize("overlap", ["none", "auto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_plan_matches_jax(engine, overlap, mode, prefill):
    got, want, calls = _plans("gnp64-2x2", engine, overlap, mode, prefill)
    assert got.report() == want.report()
    assert calls[0] == calls[1]  # the same candidates measured, in the same order
    assert got.tile == want.tile and got.cell_costs == want.cell_costs
    assert got.overlap_level_s == want.overlap_level_s
    for policy in OVERLAP_POLICIES:
        assert got.level_s_for(policy) == want.level_s_for(policy)
    if mode == "off":
        assert got.hits == got.misses == got.measured == 0 and got.tile is None
    if mode == "cache":
        assert got.measured == 0
    if engine in ("fused_sparse", "fused_hybrid") and mode == "cache" and not prefill:
        assert got.tile_source == "roofline"  # nothing measured: the model picks


@pytest.mark.parametrize("name", sorted(PARTS))
def test_plan_tile_fallback_and_explicit_tile_match_jax(name):
    got, want, _ = _plans(name, "fused_sparse", "none", "cache", False)
    assert got.tile_source == want.tile_source == "roofline" and got.tile == want.tile
    tile = _parts(name)[1].tile_candidates()[-1]
    got, want, calls = _plans(name, "fused_hybrid", "auto", "measure", False, tile=tile)
    assert got.report() == want.report() and got.tile_source == "explicit"
    assert calls[0] == calls[1] and all(c[2] in (tile, None) for c in calls[0])


def test_plan_measures_once_across_runs(tmp_path):
    g, part, _, _ = _parts("gnp64-2x2")
    path = tmp_path / "tune.json"
    kw = dict(engine_kind="fused_hybrid", overlap="auto", batch_size=16, mode="measure", graph=g)
    cold = []
    plan1 = pat.plan_autotune(part, cache=pat.CostCache(path), bench=_bench(cold, True), **kw)
    assert plan1.measured == len(cold) == len(set(cold)) > 0
    assert plan1.tile_source == "measured" and plan1.cell_costs is not None
    assert set(plan1.overlap_level_s) == set(OVERLAP_POLICIES)
    warm = []
    plan2 = pat.plan_autotune(part, cache=pat.CostCache(path), bench=_bench(warm, True), **kw)
    assert warm == [] and plan2.measured == 0 and plan2.hits == plan1.hits + plan1.measured
    assert (plan2.tile, plan2.cell_costs, plan2.overlap_level_s) == (
        plan1.tile, plan1.cell_costs, plan1.overlap_level_s)


def test_plan_agrees_every_measured_number():
    g, part, _, _ = _parts("gnp64-2x2")
    seen = []

    def agree(x):
        seen.append(x)
        return 2.0 * x

    plan = pat.plan_autotune(part, engine_kind="fused", overlap="none", batch_size=16,
                             mode="measure", graph=g, bench=_bench([], True),
                             agree_seconds=agree)
    c = _cost("pallas", "none", None)
    assert seen == [c, 8 * c, 8 * c + 1] and plan.level_s_for("none") == 2.0 * c


@pytest.mark.parametrize("calibration", [(1e-9, 1.0), (1.0, 1e-9)], ids=["dense", "bcsr"])
def test_default_bench_times_the_hybrid_cells_the_run_uses(tmp_path, caplog, calibration):
    """Stage 3 times fused_hybrid with the cells the run will have: the
    bench's cell choice reads the plan's stage-2 calibration, where the
    JAX package's reads the roofline bytes alone."""
    import torch.distributed as dist

    from repro_torch.distributed import GridGroups

    g = pg.grid_graph(8, 8)
    part = partition_2d(g, 1, 1)
    schedule, _, _, _ = build_schedule(g, batch_size=8, heuristics="h0")
    sources, derived = pat.sample_batch(schedule, 1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        bench = pat.default_bench(part, GridGroups(1, 1, 1), device="cpu", sources=sources,
                                  derived=derived, cell_costs=lambda: calibration)
        with caplog.at_level(logging.INFO, logger="repro_torch.core.distributed"):
            bench(pat.Candidate("fused_hybrid", "none", 8, (8, 8)))
        plan = pat.plan_autotune(part, GridGroups(1, 1, 1), engine_kind="fused_hybrid",
                                 overlap="none", batch_size=8, tile=(8, 8), mode="measure",
                                 graph=g, device="cpu", sources=sources, derived=derived)
    finally:
        dist.destroy_process_group()
    choice = [r.getMessage() for r in caplog.records if "hybrid cell choice" in r.getMessage()]
    want, _ = pdist.hybrid_cell_choice(part, 8, 8, measured=calibration)
    assert choice == [f"hybrid cell choice (threshold 1, tile 8x8, measured costs): "
                      f"{int(want.sum())} dense / {int(want.size - want.sum())} sparse cells "
                      f"{want.astype(int).tolist()}"]
    assert bool(want.all()) == (calibration[0] < calibration[1])
    # the planner hands its calibration to the bench it builds
    assert plan.cell_costs is not None and plan.measured == 3


def test_plan_without_a_grid_refuses_to_measure():
    g, part, _, _ = _parts("gnp64-2x2")
    with pytest.raises(ValueError, match="grid"):
        pat.plan_autotune(part, engine_kind="fused", overlap="none", batch_size=16,
                          mode="measure", graph=g)


# --------------------------------------------------------- the four seams
@pytest.mark.parametrize("seed", range(4))
def test_seam_cell_kernel_choice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    stored = rng.integers(0, 40, size=(2, 3)).astype(np.float64)
    kw = dict(R=2, C=3, chunk=16, bm=8, bk=8)
    for measured in (None, (1.0, 1e-3), (1e-6, 10.0), tuple(rng.random(2))):
        for threshold in (0.0, 1.0, 1e12):
            got = pmodel.cell_kernel_choice(stored, threshold=threshold, measured=measured, **kw)
            want = jmodel.cell_kernel_choice(stored, threshold=threshold, measured=measured, **kw)
            np.testing.assert_array_equal(got, want)
    assert not pmodel.cell_kernel_choice(stored, measured=(1.0, 1e-3), **kw).any()


@pytest.mark.parametrize("measured", [
    {"none": 1.0, "expand": 0.125, "expand+fold": 1.0},
    {"expand+fold": 999.0},  # a lone measurement wins: no cross-scale mixing
    {"none": 0.5, "expand": None, "bogus": 0.1},
    {},
])
def test_seam_auto_overlap_policy_matches_jax(measured):
    hw = pmodel.HardwareSpec(name=jmodel.V5E.name, peak_flops=jmodel.V5E.peak_bf16_flops,
                             hbm_bandwidth=jmodel.V5E.hbm_bandwidth,
                             link_bandwidth=jmodel.V5E.ici_link_bandwidth,
                             hop_latency_s=jmodel.V5E.ici_step_latency_s)
    got = pmodel.auto_overlap_policy(1e-3, 5e-4, 5e-4, 2, 4, hw=hw, measured=measured)
    want = jmodel.auto_overlap_policy(1e-3, 5e-4, 5e-4, 2, 4, measured=measured)
    assert got == want
    known = {p: s for p, s in measured.items() if p in OVERLAP_POLICIES and s is not None}
    if known:  # the pick is a measured policy, its estimate the measurement
        assert got[0] in known and got[1][got[0]] == known[got[0]]


def test_seam_prior_round_seconds_and_grid_seams_match_jax():
    g, part, jgraph, jpart = _parts("rmat8-2x4")
    for levels in (None, 40):
        got = pdist.prior_round_seconds(part, "sparse", 8, "none", measured_level_s=0.1234,
                                        prior_levels=levels)
        want = jdist.prior_round_seconds(jpart, "sparse", 8, "none", measured_level_s=0.1234,
                                         prior_levels=levels)
        assert got == pytest.approx(want) == pytest.approx(0.1234 * (levels or 16))
    assert pdist.prior_round_seconds(part, "sparse", 8, "none") != pytest.approx(0.1234 * 16)
    for measured in ((1.0, 1e-3), (1e-6, 10.0), (2e-3, 1e-3)):
        got, _ = pdist.hybrid_cell_choice(part, 8, 8, measured=measured)
        want, _ = jdist.hybrid_cell_choice(jpart, 8, 8, measured=measured)
        np.testing.assert_array_equal(got, want)
    for measured in ({"expand": 0.1, "none": 0.2}, {"none": 0.01}):
        for engine in ENGINES:
            got = pdist.resolve_overlap("auto", part, engine, 16, bm=8, bk=8,
                                        measured=measured)
            want = jdist.resolve_overlap("auto", jpart, JAX_ENGINE[engine], 16, bm=8, bk=8,
                                         measured=measured)
            assert got == want == min(measured, key=measured.get)
    assert pdist.resolve_overlap("expand", part, "sparse", 16, measured={"none": 0.0}) == "expand"


def test_entry_validates_autotune_before_the_grid():
    g = pg.gnp_graph(6, 0.5, seed=0)
    for bad in ("on", "bogus"):
        with pytest.raises(ValueError, match="autotune"):
            pdist.distributed_betweenness_centrality(g, None, autotune=bad, device="cpu")
    w = pg.weighted_copy(g, weights="dyadic", seed=1)
    with pytest.raises(ValueError, match="autotune"):
        pdist.distributed_betweenness_centrality(w, None, weighted=True, autotune="measure",
                                                 device="cpu")


# ------------------------------------------------- the 2x2x2 gloo grid
GRAPH = lambda m: m.gnp_graph(24, 0.2, seed=3)  # noqa: E731  tests/test_autotune.py's
HYBRID = dict(batch_size=8, engine_kind="fused_hybrid", overlap="auto")
SPARSE = dict(batch_size=8, engine_kind="sparse", overlap="auto")
PLAN = dict(engine_kind="fused_hybrid", overlap="auto", batch_size=8)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autotune_grid")
    paths = {k: str(tmp / f"{k}.json") for k in ("hybrid", "sparse")}
    g = GRAPH(pg)
    cases = [
        ("hybrid-measure", "bc", g, dict(HYBRID, autotune="measure",
                                         autotune_cache=paths["hybrid"])),
        ("hybrid-cache", "bc", g, dict(HYBRID, autotune="cache", autotune_cache=paths["hybrid"])),
        ("sparse-measure", "bc", g, dict(SPARSE, autotune="measure",
                                         autotune_cache=paths["sparse"])),
        ("sparse-cache", "bc", g, dict(SPARSE, autotune="cache", autotune_cache=paths["sparse"])),
        ("hybrid-off", "bc", g, HYBRID),
        ("skewed", "skewed", g, dict(HYBRID, autotune="measure")),
        ("plan", "plan", g, PLAN),
        ("plan-unagreed", "plan-unagreed", g, PLAN),
    ]
    return run_gloo(worker.run_cases, 2, 2, 2, (cases,), timeout_s=300), paths


@pytest.fixture(scope="module")
def jax_bc():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    bc, schedule = jdist.distributed_betweenness_centrality(
        GRAPH(jg), mesh, replica_axis="pod", autotune="cache", autotune_cache=None, **SPARSE)
    assert schedule.round_depths is not None  # autotune packs rounds by eccentricity
    return np.asarray(bc)


TUNED = ["hybrid-measure", "hybrid-cache", "sparse-measure", "sparse-cache", "skewed"]


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 host devices")
@pytest.mark.parametrize("case", TUNED + ["hybrid-off"])
def test_grid_bc_matches_the_oracle_and_jax(grid, jax_bc, case):
    got = grid[0][0][case]
    np.testing.assert_allclose(got["bc"], brandes_reference(GRAPH(pg)), **TOL)
    np.testing.assert_allclose(got["bc"], jax_bc, **TOL)
    assert (got["round_depths"] is not None) == (case != "hybrid-off")
    assert (got["report"] is None) == (case == "hybrid-off")


@pytest.mark.parametrize("case", TUNED + ["hybrid-off", "plan"])
def test_every_rank_makes_the_same_plan(grid, case):
    """Rank 0 alone reads and writes the cache; every rank plans on its
    entries with walls maxed over the ranks: the same report, tile,
    schedule, hybrid cells and BC, bit for bit, on all 8 ranks — under
    ``skewed`` although each rank's bench returns other walls."""
    ranks = grid[0]
    want = ranks[0][case]
    for other in ranks[1:]:
        got = other[case]
        assert got["report"] == want["report"] and got["tile"] == want["tile"]
        if case != "plan":
            np.testing.assert_array_equal(got["bc"], want["bc"])
            assert (got["overlap"], got["dense_cells"]) == (want["overlap"], want["dense_cells"])
        else:
            assert got["cell_costs"] == want["cell_costs"]


def test_without_agreement_rank_skewed_walls_give_different_plans(grid):
    """The mutation check: the same planner on the same rank-skewed bench,
    but with no all-ranks agreement, plans differently across the ranks
    (which on a real grid posts different collectives and hangs)."""
    reports = [r["plan-unagreed"]["report"] for r in grid[0]]
    assert any(rep != reports[0] for rep in reports[1:])
    assert all(r["plan"]["report"] == grid[0][0]["plan"]["report"] for r in grid[0])


@pytest.mark.parametrize("engine", ["hybrid", "sparse"])
def test_grid_cache_round_trip(grid, engine):
    """A "cache" run after a "measure" run on one file measures nothing,
    picks alike and gives bit-equal BC; rank 0 wrote the file."""
    ranks, paths = grid
    cold, warm = ranks[0][f"{engine}-measure"], ranks[0][f"{engine}-cache"]
    assert cold["report"]["measured"] > 0 and warm["report"]["measured"] == 0
    assert warm["report"]["misses"] == 0
    assert warm["report"]["hits"] == cold["report"]["hits"] + cold["report"]["measured"]
    for key in ("tile", "overlap", "dense_cells"):
        assert warm[key] == cold[key]
    assert warm["report"]["overlap_level_s"] == cold["report"]["overlap_level_s"]
    np.testing.assert_array_equal(warm["bc"], cold["bc"])
    assert pat.CostCache(paths[engine]).num_records() == cold["report"]["measured"]
    if engine == "hybrid":  # the tile, hybrid and overlap stages all ran
        assert cold["report"]["tile_source"] == "measured"
        assert cold["report"]["cell_costs_measured"]
        assert set(cold["report"]["overlap_level_s"]) == set(OVERLAP_POLICIES)
        assert cold["report"]["measured"] == len(_parts_tiles()) + 1 + 3


def _parts_tiles():
    return partition_2d(GRAPH(pg), 2, 2).tile_candidates()
