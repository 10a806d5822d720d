"""Source-round scheduler (host-side numpy).

Brandes' outer loop is embarrassingly parallel over source vertices; the
scheduler turns the eligible source set into fixed-shape *rounds* (the
unit of dispatch and accumulation):

* every round holds ``batch_size`` explicit sources (padded with -1) and
  up to ``derived_per_round`` 2-degree derived columns (c, a_pos, b_pos);
* a derived vertex's two neighbors must be explicit sources *of the same
  round* (their forward columns feed Alg. 7); the packer keeps triples
  intact and demotes a triple to an explicit source on conflict.

The same graph and arguments give the same rounds as the JAX package's
scheduler, so a schedule can be carried across (:mod:`repro_torch.interop`).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from .. import tracing
from ..graphs.graph import Graph
from ..kernels.level_gemm import COLUMN_TILES
from .heuristics.one_degree import OneDegreeReduction, one_degree_reduce
from .heuristics.two_degree import claim_two_degree

logger = logging.getLogger(__name__)

__all__ = [
    "Round",
    "Schedule",
    "build_schedule",
    "HEURISTICS_MODES",
    "ROOT_ORDERS",
    "COLUMN_TILE",
    "bfs_depths",
    "estimate_eccentricities",
    "validate_batch_size",
    "split_rounds",
    "redeal_rounds",
]

#: The heuristics selector (paper Fig. 12 naming): "h0" none | "h1"
#: 1-degree | "h2" 2-degree DMF | "h3" both; "h1t"/"h3t" run the 1-degree
#: pass to a fixed point (pendant-tree contraction).
HEURISTICS_MODES = ("h0", "h1", "h2", "h3", "h1t", "h3t")

#: explicit-source packing orders: "id" fills rounds in vertex-id order;
#: "eccentricity" sorts by sampled eccentricity descending so that
#: similar-depth roots share a round (a round runs to its deepest root).
ROOT_ORDERS = ("id", "eccentricity")

#: Column padding of the dense level kernels K1–K4: each thread block
#: computes a slab of 64, 128 or 192 columns of the [n, s] product
#: (kernels/level_gemm.py:column_tile picks the tile from s), and the
#: fewest padded columns any pick leaves is s rounded up to the smallest
#: tile, so a batch that is not a multiple of it leaves lanes of the last
#: slab computing zeros.  This takes the place of the TPU's 128-lane MXU
#: width.
COLUMN_TILE = min(COLUMN_TILES)


def validate_batch_size(
    batch_size: int, *, lanes: int = COLUMN_TILE, population: int | None = None
) -> int:
    """Validate the multi-source batch width.

    Rejects ``< 1``; logs a hint when the padded column width wastes more
    than half a kernel column tile, unless ``population`` (the root pool
    actually scheduled) is what keeps the batch narrow.
    """
    batch_size = int(batch_size)
    if batch_size < 1:
        raise ValueError(
            f"batch_size must be >= 1, got {batch_size}: every round needs "
            "at least one explicit source column"
        )
    pad = (-batch_size) % lanes
    if pad > lanes // 2 and (population is None or population > batch_size):
        better = batch_size - (batch_size % lanes) or lanes
        logger.warning(
            "batch_size=%d pads the source dimension to %d (%d idle kernel "
            "columns, more than half a %d-column tile); %d or a multiple of "
            "%d wastes none",
            batch_size, batch_size + pad, pad, lanes, better, lanes,
        )
    return batch_size


def _adjacency_csr(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """``(indptr [n + 1], neighbours)``: the arcs grouped by source."""
    order = np.argsort(graph.src, kind="stable")
    indptr = np.zeros(graph.n + 1, np.int64)
    np.cumsum(np.bincount(graph.src, minlength=graph.n), out=indptr[1:])
    return indptr, np.asarray(graph.dst)[order]


def _bfs_levels(csr: tuple[np.ndarray, np.ndarray], n: int, root: int):
    """BFS from ``root`` over ``csr``: ``(depth [n], visited)`` with depth
    -1 where unreached and ``visited`` the reached vertices.  Each level
    reads only its frontier's arcs, so a search costs its component's
    size, not the graph's: a graph of many small components (an R-MAT
    graph's isolated vertices) is searched component by component in
    linear time."""
    indptr, nbr = csr
    depth = np.full(n, -1, np.int64)
    depth[root] = 0
    frontier = np.array([root], np.int64)
    levels = [frontier]
    d = 0
    while True:
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        offsets = np.repeat(starts - np.cumsum(counts) + counts, counts)
        cand = nbr[offsets + np.arange(total)]
        cand = cand[depth[cand] < 0]
        cand.sort()  # distinct by sort: some numpy versions' np.unique hashes, ~20x slower
        cand = cand[np.concatenate(([True], cand[1:] != cand[:-1]))] if cand.size else cand
        if cand.size == 0:
            break
        d += 1
        depth[cand] = d
        frontier = cand
        levels.append(frontier)
    return depth, np.concatenate(levels)


def bfs_depths(graph: Graph, root: int) -> np.ndarray:
    """Exact BFS depth of every vertex from ``root`` (-1 = unreached)."""
    return _bfs_levels(_adjacency_csr(graph), graph.n, root)[0]


def estimate_eccentricities(
    graph: Graph, num_samples: int = 8, seed: int = 0
) -> np.ndarray:
    """Sampled lower-bound eccentricity per vertex (farthest-first BFS
    landmarks; every connected component gets at least one landmark
    before the ``num_samples`` budget applies)."""
    if graph.n == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    csr = _adjacency_csr(graph)
    ecc = np.zeros(graph.n, np.int64)
    far = np.iinfo(np.int64).max
    mind = np.full(graph.n, far, np.int64)  # min distance to any landmark
    root = int(rng.integers(graph.n))
    taken = 0
    while True:
        depth, seen = _bfs_levels(csr, graph.n, root)
        dists = depth[seen]
        ecc[seen] = np.maximum(ecc[seen], dists)
        ecc[root] = max(ecc[root], int(dists.max()))
        mind[seen] = np.minimum(mind[seen], dists)
        taken += 1
        root = int(np.argmax(mind))
        if mind[root] == far:
            continue  # an uncovered component: keep going past the budget
        if taken >= num_samples or mind[root] == 0:
            return ecc


@dataclasses.dataclass(frozen=True)
class Round:
    sources: np.ndarray  # int32 [batch_size]; -1 = padding
    derived: np.ndarray  # int32 [derived_per_round, 3]; rows (c, a_pos, b_pos); -1 pad


@dataclasses.dataclass(frozen=True)
class Schedule:
    rounds: list[Round]
    batch_size: int
    derived_per_round: int
    num_explicit: int
    num_derived: int
    num_leaf_skipped: int  # 1-degree vertices never traversed
    num_isolated_omega: int  # residual-isolated vertices resolved analytically
    analytic_corrections: np.ndarray  # f64 [k, 2] rows (v, n_comp) resolved w/o traversal
    #: per-round expected traversal depth (max sampled eccentricity over
    #: the round's roots); None unless root_order="eccentricity"
    round_depths: np.ndarray | None = None


def _finish_round(src_list, derived_list, batch_size, derived_per_round) -> Round:
    sources = np.full(batch_size, -1, dtype=np.int32)
    sources[: len(src_list)] = src_list
    derived = np.full((derived_per_round, 3), -1, dtype=np.int32)
    for k, (c, ap, bp) in enumerate(derived_list):
        derived[k] = (c, ap, bp)
    return Round(sources=sources, derived=derived)


def build_schedule(
    graph: Graph,
    batch_size: int = 32,
    heuristics: str = "h0",
    derived_per_round: int | None = None,
    root_order: str = "id",
    ecc_samples: int = 8,
    ecc_seed: int = 0,
    roots: np.ndarray | None = None,
) -> tuple[Schedule, OneDegreeReduction | None, Graph, np.ndarray]:
    """Plan the full BC computation.

    Args:
      graph:      input undirected graph.
      batch_size: explicit sources per round (the multi-source width).
      heuristics: one of :data:`HEURISTICS_MODES`.
      derived_per_round: cap on derived columns per round (default
                  ``batch_size // 2`` — a triple contributes ≥2 sources).
      root_order: one of :data:`ROOT_ORDERS`.
      ecc_samples / ecc_seed: :func:`estimate_eccentricities` budget and
                  landmark seed (read only under "eccentricity").
      roots:      optional explicit root subset (the source-sampling
                  seam); requires ``heuristics="h0"``.

    Returns (schedule, one_degree_result_or_None, residual_graph, omega).
    """
    if heuristics not in HEURISTICS_MODES:
        raise ValueError(
            f"unknown heuristics mode {heuristics!r}; expected one of "
            f"{HEURISTICS_MODES}"
        )
    if root_order not in ROOT_ORDERS:
        raise ValueError(
            f"unknown root_order {root_order!r}; expected one of {ROOT_ORDERS}"
        )
    batch_size = validate_batch_size(
        batch_size, population=None if roots is None else len(roots)
    )
    if roots is not None and heuristics != "h0":
        raise ValueError(
            "a root subset (source sampling) requires heuristics='h0': "
            "the 1-/2-degree analytic corrections are not per-root "
            f"additive, so a sampled schedule under {heuristics!r} could "
            "not be rescaled into an unbiased estimator"
        )
    use_h1 = heuristics in ("h1", "h3", "h1t", "h3t")
    use_h2 = heuristics in ("h2", "h3", "h3t")
    exhaustive = heuristics.endswith("t")
    if derived_per_round is None:
        derived_per_round = max(1, batch_size // 2)

    with tracing.phase("bc.schedule.one_degree"):
        prep = one_degree_reduce(graph, exhaustive=exhaustive) if use_h1 else None
        residual = prep.residual if prep is not None else graph
        omega = prep.omega if prep is not None else np.zeros(graph.n, dtype=np.float64)

    with tracing.phase("bc.schedule.two_degree"):
        res_deg = residual.degrees()
        eligible = res_deg >= 1  # traversal-worthy sources
        if roots is not None:
            root_ids = np.asarray(roots, np.int64)
            if root_ids.size and (root_ids.min() < 0 or root_ids.max() >= graph.n):
                raise ValueError(
                    f"root subset contains out-of-range vertex ids (n = {graph.n})"
                )
            keep = np.zeros(graph.n, bool)
            keep[root_ids] = True
            eligible &= keep
        num_leaf_skipped = int(prep.num_removed) if prep is not None else 0

        # residual-isolated vertices with removed leaves: analytic component
        # size n = 1 + omega (star centers, K2 leaves) — no round needed.
        removed_mask = prep.removed if prep is not None else np.zeros(graph.n, bool)
        iso_omega = np.nonzero((res_deg == 0) & (omega > 0) & ~removed_mask)[0]
        analytic = np.stack(
            [iso_omega, 1 + omega[iso_omega]], axis=1
        ).astype(np.float64) if iso_omega.size else np.zeros((0, 2), np.float64)

        triples: list[tuple[int, int, int]] = []
        if use_h2:
            triples = claim_two_degree(res_deg, residual.adjacency_lists(), eligible)
        derived_set = {c for c, _, _ in triples}

    with tracing.phase("bc.schedule.pack"):
        rounds: list[Round] = []
        cur_src: list[int] = []
        cur_pos: dict[int, int] = {}
        cur_der: list[tuple[int, int, int]] = []
        consumed: set[int] = set()
        demoted: list[int] = []

        def flush():
            nonlocal cur_src, cur_pos, cur_der
            if cur_src or cur_der:
                rounds.append(_finish_round(cur_src, cur_der, batch_size, derived_per_round))
            cur_src, cur_pos, cur_der = [], {}, []

        # 1) place triples (sorted so shared-neighbor triples cluster)
        for c, a, b in sorted(triples, key=lambda t: (t[1], t[2])):
            if batch_size < 2:
                demoted.append(c)  # a triple needs two co-resident sources
                continue
            if a in consumed and a not in cur_pos or b in consumed and b not in cur_pos:
                demoted.append(c)  # neighbor already ran in a closed round
                continue
            need = [v for v in (a, b) if v not in cur_pos]
            if len(cur_src) + len(need) > batch_size or len(cur_der) >= derived_per_round:
                flush()
                need = [v for v in (a, b) if v not in cur_pos]
                if a in consumed or b in consumed:
                    demoted.append(c)
                    continue
            for v in need:
                cur_pos[v] = len(cur_src)
                cur_src.append(v)
                consumed.add(v)
            cur_der.append((c, cur_pos[a], cur_pos[b]))

        # 2) fill with the remaining explicit sources — vertex-id order, or
        # deepest-first under "eccentricity"
        ecc = (
            estimate_eccentricities(residual, num_samples=ecc_samples, seed=ecc_seed)
            if root_order == "eccentricity"
            else None
        )
        explicit_rest = [
            int(v)
            for v in np.nonzero(eligible)[0]
            if v not in consumed and v not in derived_set
        ] + demoted
        if ecc is not None:
            explicit_rest.sort(key=lambda v: (-int(ecc[v]), v))
        for v in explicit_rest:
            if len(cur_src) >= batch_size:
                flush()
            cur_pos[v] = len(cur_src)
            cur_src.append(v)
            consumed.add(v)
        flush()

        num_derived = sum(int((r.derived[:, 0] >= 0).sum()) for r in rounds)
        num_explicit = sum(int((r.sources >= 0).sum()) for r in rounds)
        round_depths = None
        if ecc is not None:
            round_depths = np.array(
                [
                    max(
                        (
                            int(ecc[v])
                            for v in np.concatenate((r.sources, r.derived[:, 0]))
                            if v >= 0
                        ),
                        default=0,
                    )
                    for r in rounds
                ],
                np.int64,
            )
        schedule = Schedule(
            rounds=rounds,
            batch_size=batch_size,
            derived_per_round=derived_per_round,
            num_explicit=num_explicit,
            num_derived=num_derived,
            num_leaf_skipped=num_leaf_skipped,
            num_isolated_omega=int(iso_omega.size),
            analytic_corrections=analytic,
            round_depths=round_depths,
        )
    return schedule, prep, residual, omega


def split_rounds(
    num_rounds: int, fr: int, committed=(), round_costs=None
) -> list[list[int]]:
    """Static per-replica deal of a schedule's round ids (the JAX
    package's, list for list).

    Replica ``r`` receives rounds ``r, r+fr, r+2fr, …``: the lane
    assignment of the static block loop (block ``i`` = rounds
    ``[i·fr, (i+1)·fr)``), so ``straggler="none"`` and the multi-ledger
    policies start from the same deal.  Rounds in ``committed`` (a resumed
    checkpoint's) are left out.

    ``round_costs`` (one expected cost per round, e.g.
    ``Schedule.round_depths`` of an eccentricity-ordered schedule) deals
    by cost instead: the pool sorted costliest first, consecutive
    ``fr``-tuples one per lane — the shape of :func:`redeal_rounds`,
    seeded from the prior instead of the EWMA — so a dispatch block
    co-schedules rounds of similar cost.
    """
    if fr < 1:
        raise ValueError(f"need at least one replica, got fr={fr}")
    done = set(committed)
    if round_costs is None:
        return [[rid for rid in range(r, num_rounds, fr) if rid not in done] for r in range(fr)]
    costs = [float(c) for c in round_costs]
    if len(costs) != num_rounds:
        raise ValueError(f"{num_rounds} rounds but {len(costs)} round costs")
    pool = sorted((rid for rid in range(num_rounds) if rid not in done),
                  key=lambda rid: (-costs[rid], rid))
    queues: list[list[int]] = [[] for _ in range(fr)]
    for i, rid in enumerate(pool):
        queues[i % fr].append(rid)
    return queues


def redeal_rounds(
    queues: list[list[int]], lane_cost: list[float]
) -> tuple[list[list[int]], int]:
    """Re-deal pending rounds across replica queues (straggler recovery;
    the JAX package's, list for list).

    Under replica lockstep a dispatch block costs the deepest of its
    rounds, so the re-deal packs rounds of similar cost into one block:
    every pending round is priced at its current owner's per-round cost
    (the driver's EWMA), the pool is sorted costliest first (round id
    breaks ties) and consecutive ``fr``-tuples are dealt one per lane —
    the straggler's backlog drains into the fastest lanes' queue heads.
    Returns ``(new_queues, moved)``, ``moved`` counting the rounds that
    changed lanes; a pure function, so a re-deal is reproducible across a
    kill-and-resume (and on every rank of a grid).
    """
    fr = len(queues)
    if fr != len(lane_cost):
        raise ValueError(f"{fr} queues but {len(lane_cost)} lane costs")
    owner = {rid: r for r, q in enumerate(queues) for rid in q}
    pool = sorted(owner, key=lambda rid: (-lane_cost[owner[rid]], rid))
    new_queues: list[list[int]] = [[] for _ in range(fr)]
    for i, rid in enumerate(pool):
        new_queues[i % fr].append(rid)
    moved = sum(1 for r, q in enumerate(new_queues) for rid in q if owner[rid] != r)
    return new_queues, moved
