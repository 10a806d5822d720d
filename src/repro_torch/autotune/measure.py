"""Micro-benchmarks and the staged planner of the measured-cost cache.

:func:`plan_autotune` is the one entry: given the partition, the grid and
the run's requested configuration, it resolves a measured per-level cost
for every choice the run is about to make, reading the
:class:`~repro_torch.autotune.cache.CostCache` first and, in
``"measure"`` mode, timing a candidate on a miss.  Three bounded stages
keep a cold run to a handful of timings:

  1. **tile** — the candidate BCSR tiles
     (:meth:`TwoDPartition.tile_candidates`), each timed as a plain
     ``fused_sparse`` round under ``overlap="none"`` (the tile prices the
     BCSR side whatever engine surrounds it);
  2. **hybrid calibration** — for ``fused_hybrid``, one all-dense
     (``fused``) and one all-BCSR (``fused_sparse``) timing: the
     (dense_level_s, sparse_level_s) pair
     :func:`repro_torch.roofline.model.cell_kernel_choice` takes;
  3. **overlap** — the requested policy (all of ``OVERLAP_POLICIES``
     under ``overlap="auto"``) on the final engine and tile: what
     :func:`~repro_torch.roofline.model.auto_overlap_policy` and the
     straggler prior (:func:`~repro_torch.core.distributed.prior_round_seconds`)
     read.

Each timing runs the real distributed round function at
:data:`MEASURE_LEVELS` levels, one warm-up and :data:`MEASURE_ITERS`
timed calls, and records ``min(walls) / (2 · levels)``: the forward and
the backward loop both sweep the levels.  The clock and the whole bench
are injectable, so CPU tests drive the planner with fake walls.

On a grid every rank plans: each timing is a collective, so every rank
must time the same candidates in the same order, and every rank must
pick alike, or the ranks post different collectives and hang.  So the
cache every rank reads holds the same entries (the caller hands rank 0's
to the others), and every measured number passes through
``agree_seconds`` (the all-ranks max) before it is recorded or compared.

When some candidates are measured and others are not (``"cache"`` mode),
comparisons keep to the measured ones: measured walls and modelled
seconds are not on one scale.  ``"measure"`` mode never mixes.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..core.operators import OVERLAP_POLICIES, normalize_overlap
from .cache import CostCache, CostRecord, config_key, graph_key_for, normalize_autotune

__all__ = [
    "MEASURE_LEVELS",
    "MEASURE_ITERS",
    "MEASURE_WARMUP",
    "TILED_ENGINES",
    "Candidate",
    "TunePlan",
    "default_bench",
    "measure_walls",
    "plan_autotune",
    "sample_batch",
]

logger = logging.getLogger(__name__)

#: the static level bound of a micro-benchmark round: deep enough to
#: amortise a round's fixed cost, shallow enough that a cold plan adds only
#: a few rounds' work
MEASURE_LEVELS = 4
MEASURE_ITERS = 2
MEASURE_WARMUP = 1

#: engines whose graph operands are BCSR tiles (the tile stage applies)
TILED_ENGINES = ("fused_sparse", "fused_hybrid")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One measurable configuration (the cache's config-key tuple)."""

    engine_kind: str
    overlap: str
    batch_size: int
    tile: tuple[int, int] | None = None

    def key(self) -> str:
        return config_key(self.engine_kind, self.overlap, self.batch_size, self.tile)


def measure_walls(run, *, clock=time.perf_counter, warmup: int = MEASURE_WARMUP,
                  iters: int = MEASURE_ITERS) -> list[float]:
    """Time ``run()``: ``warmup`` untimed calls (the first builds kernels
    and communicators), then ``iters`` timed calls.  Returns the raw
    walls; the caller takes their min, the least disturbed sample."""
    for _ in range(warmup):
        run()
    walls = []
    for _ in range(iters):
        t0 = clock()
        run()
        walls.append(clock() - t0)
    return walls


def default_bench(partition, groups, *, device, sources: np.ndarray, derived: np.ndarray,
                  hybrid_threshold: float = 1.0, clock=time.perf_counter, cell_costs=None):
    """The real bench, ``Candidate -> CostRecord``: this rank's round
    function at :data:`MEASURE_LEVELS` static levels over the candidate's
    engine, schedule and tile, timed on ``device`` (synchronised on a
    card: the wall covers the device work).  A ``fused_hybrid``
    candidate's cells are chosen as the run chooses them: with the
    calibration ``cell_costs()`` returns when the candidate is timed
    (the planner passes its stage-2 pair, None before it is known or in
    part unmeasured, where the roofline bytes decide).  The JAX package's
    bench always uses the roofline choice, so there stage 3 can time a
    layout the run does not use.  A candidate's layout lives only while
    it is timed: a dense 1×1 block of an R-MAT 16 graph is 17.2 GB, and
    the run builds its own layout after the plan.  Imports the
    distributed module at call time, since that module imports this
    package."""
    from ..core.distributed import (
        distributed_graph_arrays,
        hybrid_cell_choice,
        make_distributed_round_fn,
    )

    omega = torch.zeros(partition.n_pad, dtype=torch.float32, device=device)
    sources = torch.from_numpy(np.asarray(sources, np.int32)).to(device)
    derived = torch.from_numpy(np.asarray(derived, np.int32)).to(device)
    on_card = torch.device(device).type == "cuda"

    def bench(cand: Candidate) -> CostRecord:
        bm, bk = cand.tile if cand.tile is not None else (None, None)
        dense_cells = None
        if cand.engine_kind == "fused_hybrid":
            dense_cells, _ = hybrid_cell_choice(
                partition, bm, bk, threshold=hybrid_threshold,
                measured=None if cell_costs is None else cell_costs())
        round_fn = make_distributed_round_fn(
            partition, groups, num_levels=MEASURE_LEVELS, engine_kind=cand.engine_kind,
            dense_cells=dense_cells, overlap=cand.overlap,
        )
        graph_args = distributed_graph_arrays(
            partition, cand.engine_kind, groups.i, groups.j, device, overlap=cand.overlap,
            tile=cand.tile, dense_cells=dense_cells,
        )

        def run():
            round_fn(graph_args, omega, sources, derived)
            if on_card:
                torch.cuda.synchronize(device)

        walls = measure_walls(run, clock=clock)
        return CostRecord(level_s=min(walls) / (2.0 * MEASURE_LEVELS), levels=MEASURE_LEVELS,
                          walls=tuple(walls))

    return bench


def sample_batch(schedule, fr: int) -> tuple[np.ndarray, np.ndarray]:
    """A representative (sources [fr, s], derived [fr, k, 3]) block for the
    micro-benchmarks: the schedule's first round on every replica lane."""
    r0 = schedule.rounds[0]
    sources = np.tile(np.asarray(r0.sources, np.int32), (fr, 1))
    derived = np.tile(np.asarray(r0.derived, np.int32), (fr, 1, 1))
    return sources, derived


@dataclasses.dataclass
class TunePlan:
    """The measured costs of one run, as the seams read them."""

    mode: str
    graph_key: str
    engine_kind: str
    batch_size: int
    #: the resolved BCSR tile (None for untiled engines)
    tile: tuple[int, int] | None = None
    #: "explicit" | "measured" | "roofline" | "default"
    tile_source: str = "default"
    #: the measured (dense_level_s, sparse_level_s) hybrid calibration; None
    #: when either half is unmeasured (the seam falls back to the roofline)
    cell_costs: tuple[float, float] | None = None
    #: measured per-level seconds per overlap policy (only the policies with
    #: a cache hit or a fresh measurement)
    overlap_level_s: dict = dataclasses.field(default_factory=dict)
    hits: int = 0
    misses: int = 0
    measured: int = 0

    def level_s_for(self, policy: str) -> float | None:
        """The measured per-level cost of the resolved overlap policy: the
        straggler prior's seed."""
        return self.overlap_level_s.get(normalize_overlap(policy))

    def report(self) -> dict:
        """The run's ``autotune[...]`` record (the JAX package's keys)."""
        return {
            "mode": self.mode,
            "graph_key": self.graph_key,
            "tile": list(self.tile) if self.tile else None,
            "tile_source": self.tile_source,
            "overlap_level_s": {k: round(v, 9) for k, v in sorted(self.overlap_level_s.items())},
            "cell_costs_measured": self.cell_costs is not None,
            "hits": self.hits,
            "misses": self.misses,
            "measured": self.measured,
        }


def plan_autotune(
    partition,
    groups=None,
    *,
    engine_kind: str,
    overlap: str,
    batch_size: int,
    tile: tuple[int, int] | None = None,
    mode: str = "measure",
    cache: CostCache | None = None,
    graph=None,
    nnz_tiles: int = 0,
    fr: int = 1,
    device=None,
    sources: np.ndarray | None = None,
    derived: np.ndarray | None = None,
    hybrid_threshold: float = 1.0,
    bench=None,
    clock=time.perf_counter,
    agree_seconds=None,
) -> TunePlan:
    """Resolve the measured costs of a run (see the module docstring).

    ``bench`` replaces the measurement (``Candidate -> CostRecord``; CPU
    tests inject a fake one); by default :func:`default_bench` times real
    round functions on ``groups``' grid, on ``device``.  ``agree_seconds``
    maps a rank's seconds to the number every rank uses (the grid passes
    the all-ranks max); every measured number goes through it before it
    is recorded.
    """
    mode = normalize_autotune(mode)
    cache = cache if cache is not None else CostCache(None)
    gkey = graph_key_for(partition, graph, fr=fr, nnz_tiles=nnz_tiles)
    plan = TunePlan(mode=mode, graph_key=gkey, engine_kind=engine_kind, batch_size=batch_size)
    if mode == "off":
        return plan
    agree = agree_seconds if agree_seconds is not None else float
    _bench = bench

    def get_bench():
        nonlocal _bench
        if _bench is None:
            if groups is None:
                raise ValueError("autotune='measure' needs a grid (or an injected bench) "
                                 "to time candidate configurations")
            if sources is None or derived is None:
                raise ValueError("autotune measurement needs a sample batch")
            _bench = default_bench(partition, groups, device=device, sources=sources,
                                   derived=derived, hybrid_threshold=hybrid_threshold,
                                   clock=clock, cell_costs=lambda: plan.cell_costs)
        return _bench

    def cost_of(cand: Candidate) -> float | None:
        """Measured per-level seconds of ``cand``: a cache hit, else (in
        "measure" mode) a fresh, agreed measurement recorded under its
        keys; None in "cache" mode on a miss (the roofline decides)."""
        ckey = cand.key()
        rec = cache.get(gkey, ckey)
        if rec is not None:
            plan.hits += 1
            return rec.level_s
        plan.misses += 1
        if mode != "measure":
            return None
        raw = get_bench()(cand)
        rec = CostRecord(level_s=agree(raw.level_s), levels=raw.levels,
                         walls=tuple(agree(w) for w in raw.walls))
        cache.put(gkey, ckey, rec)
        plan.measured += 1
        logger.info("autotune measured %s @ %s: %.3es/level (walls %s)", ckey, gkey,
                    rec.level_s, [f"{w:.3e}" for w in rec.walls])
        return rec.level_s

    # stage 1: the BCSR tile (tiled engines, tile not given)
    if tile is not None:
        plan.tile, plan.tile_source = tile, "explicit"
    elif engine_kind in TILED_ENGINES:
        cands = partition.tile_candidates()
        costs = {t: cost_of(Candidate("fused_sparse", "none", batch_size, t)) for t in cands}
        measured = {t: c for t, c in costs.items() if c is not None}
        if measured:
            plan.tile = min(measured, key=measured.get)
            plan.tile_source = "measured"
        else:
            plan.tile = _roofline_tile(partition, batch_size, cands)
            plan.tile_source = "roofline"

    # stage 2: the hybrid's dense / BCSR calibration
    if engine_kind == "fused_hybrid":
        dense_s = cost_of(Candidate("fused", "none", batch_size, None))
        sparse_s = cost_of(Candidate("fused_sparse", "none", batch_size, plan.tile))
        if dense_s is not None and sparse_s is not None:
            plan.cell_costs = (dense_s, sparse_s)

    # stage 3: the overlap policies on the final engine and tile
    policies = list(OVERLAP_POLICIES) if overlap == "auto" else [normalize_overlap(overlap)]
    for policy in policies:
        c = cost_of(Candidate(engine_kind, policy, batch_size, plan.tile))
        if c is not None:
            plan.overlap_level_s[policy] = c
    return plan


def _roofline_tile(partition, batch_size, candidates):
    """The tile pick without measurements: each candidate's compute term
    priced by the roofline, the cheapest taken."""
    from ..core.distributed import level_time_estimates

    def price(t):
        compute_s, _, _ = level_time_estimates(partition, "fused_sparse", batch_size,
                                               bm=t[0], bk=t[1])
        return compute_s

    return min(candidates, key=price) if candidates else None
