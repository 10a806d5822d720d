"""The driver layer: one round body and one host round loop.

:func:`traversal_round` is the per-round algebra — forward counting,
2-degree column derivation, dependency accumulation, per-round BC and
component-size (n_s) extraction, plus the round's traversal depth —
written against the :class:`repro_torch.core.operators.TraversalOperator`
protocol; with ``integrity != "off"`` it also returns the round's
integrity record (ABFT residual, bc-sum claim).  A weighted operator's
round is :func:`_weighted_round`, the bucket-loop analogue with the same
return contract.

:class:`BCDriver` is the host round loop: it deals the schedule's rounds
in *dispatch blocks* of ``rounds_per_dispatch`` (1 on a single device;
the sub-cluster count ``fr`` on a grid, one round per replica), skips
rounds a :class:`RoundLedger` (or a resumed :class:`BCCheckpoint`) has
committed, ships a block's derived slots only up to its last claimed one
(the rest are padding in every lane, and would widen the backward loop),
adds each block's contribution into an f32 accumulator on the
device, reads the block's n_s and roots back to the host (the 1-degree
corrections need them), and fetches the accumulator as f64 at the end,
summing the replicas onto the checkpoint's f64 seed.  Every block goes
through the recovery ladder of :meth:`BCDriver._dispatch_block`
(transient retry, watchdog, numeric guard, integrity audit, fallback).
``straggler="steal"`` / ``"redeal"`` (:data:`STRAGGLER_POLICIES`) run the
multi-ledger loop instead: one ledger and one round queue per replica,
a per-replica EWMA of the per-round wall, rounds moved between queues
when a replica straggles, speculative tail duplicates settled by a
duplicate vote, commits at drain time under a masked accumulate, and an
elastic re-mesh around a lost replica.  The fault-injection harness
(:mod:`repro_torch.distributed.chaos`) drives every rung of that ladder
through a wrapped ``round_fn``; the grid entry point seeds the EWMA prior
from the autotuner's measured level walls where it has them.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from ..distributed.fault_tolerance import (
    IntegrityError,
    ReplicaLostError,
    RoundLedger,
    is_transient_error,
    plan_elastic_remesh,
    schedule_fingerprint,
)
from .. import tracing
from . import engine
from .heuristics.one_degree import OneDegreeReduction, leaf_correction
from ..kernels.ops import bucket_index
from .heuristics.two_degree import derive_two_degree_columns
from .operators import TraversalOperator
from .scheduler import Schedule, redeal_rounds, split_rounds

__all__ = [
    "BCResult",
    "BCDriver",
    "traversal_round",
    "apply_reduction_corrections",
    "STRAGGLER_POLICIES",
    "normalize_straggler",
    "INTEGRITY_MODES",
    "CHECKSUM_TOL",
    "CLAIM_RTOL",
    "VOTE_RTOL",
    "normalize_integrity",
    "DEFAULT_MAX_RETRIES",
    "DEFAULT_RETRY_BACKOFF_S",
]

logger = logging.getLogger(__name__)

#: Sub-cluster straggler policies of :class:`BCDriver` (the ``--straggler``
#: choices).  ``"none"`` keeps the static deal (one shared ledger).
#: ``"steal"``: work moves only when a replica's queue runs dry — the idle
#: replica pulls the next round from the heaviest backlog, and at the tail
#: it speculatively duplicates the presumed straggler's round instead of
#: running padding (backup tasks; the first commit wins).  ``"redeal"``:
#: when a replica's EWMA per-round wall exceeds ``straggler_factor ×`` the
#: fastest replica's, every pending round is re-dealt so that rounds of
#: similar cost share a dispatch block.
STRAGGLER_POLICIES = ("none", "steal", "redeal")

_EWMA_ALPHA = 0.5  # weight of the newest per-round wall observation

#: Self-healing defaults: re-dispatches allowed per block (transient
#: errors, watchdog trips and quarantined outputs share the budget) and
#: the base of the exponential backoff between transient retries.
DEFAULT_MAX_RETRIES = 2
DEFAULT_RETRY_BACKOFF_S = 0.05

#: Round-integrity modes of :class:`BCDriver`.  ``"off"`` accumulates
#: round outputs unaudited.  ``"audit"``: every round also returns an
#: integrity record — its bc-sum *claim*, computed inside the round — and
#: the driver audits each block on the host: claim vs the recomputed lane
#: sum, BC non-negativity, level and component-size bounds.
#: ``"checksum"`` adds the ABFT ones-checksum lane to every forward and
#: backward product (``operators.*_level_checked``) and carries the max
#: relative column-sum residual in the record: one extra lane a product.
INTEGRITY_MODES = ("off", "audit", "checksum")

#: ABFT residual threshold: healthy f32 sums read ~7.6e-6 relative on the
#: H100 (K3/K4 at n = 65 536); 1e-3 leaves two orders of magnitude of
#: slack for summation order while still catching any corruption that
#: could move BC beyond parity.
CHECKSUM_TOL = 1e-3
#: Relative tolerance of the bc-sum claim audit (in-round claim against
#: the host-recomputed lane sum: two f32 sums in different orders).
CLAIM_RTOL = 1e-4
#: Relative tolerance of the duplicate vote: both lanes ran the same
#: deterministic computation, so any real divergence is corruption.
VOTE_RTOL = 1e-6


def normalize_integrity(mode: str | None) -> str:
    """Validate an integrity mode string (None means "off")."""
    mode = "off" if mode is None else mode
    if mode not in INTEGRITY_MODES:
        raise ValueError(
            f"unknown integrity mode {mode!r}; expected one of {INTEGRITY_MODES}"
        )
    return mode


def normalize_straggler(policy: str | None) -> str:
    """Validate a straggler policy string (None means "none")."""
    policy = "none" if policy is None else policy
    if policy not in STRAGGLER_POLICIES:
        raise ValueError(
            f"unknown straggler policy {policy!r}; expected one of {STRAGGLER_POLICIES}"
        )
    return policy


def traversal_round(
    op: TraversalOperator,
    sources: torch.Tensor,  # i32 [s]; -1 = padding
    derived: torch.Tensor,  # i32 [k, 3] rows (c, a_pos, b_pos); -1 = padding
    omega: torch.Tensor,  # f32 [n_rows] 1-degree weights
    *,
    num_levels: int | None = None,
    integrity: str = "off",
) -> tuple:
    """One BC round against the operator protocol.

    Returns
      bc_local  f32 [n_rows] — this round's BC contribution,
      ns        f32 [s+k]    — per-column component size n_s (§3.4.1),
      roots     i32 [s+k]    — root vertex of every column (-1 padding),
      levels    int          — traversal depth of this round on its own
                grid (``reduce_max_grid``; 0 for an all-padding round).

    With ``integrity != "off"`` (see :data:`INTEGRITY_MODES`) a fifth
    element ``integ`` f32 [2] = ``[err, claim]``: the round's max ABFT
    checksum residual (0 under "audit", where the checked level steps do
    not run) and its own bc-sum claim ``Σ bc_local``, computed before the
    block leaves the round.
    """
    with tracing.span("bc.round"):
        integrity = normalize_integrity(integrity)
        if getattr(op, "weighted", False):
            return _weighted_round(op, sources, derived, omega, num_levels=num_levels,
                                   integrity=integrity)
        checksum = integrity == "checksum"
        row_ids = op.row_ids()

        # ---------------------------------------------------------- forward
        src_onehot = (
            (row_ids[:, None] == sources[None, :]) & (sources[None, :] >= 0)
        ).to(torch.float32)
        fwd = engine.forward_counting(op, src_onehot, num_levels=num_levels, checksum=checksum,
                                      roots=sources)

        # ------------------------------------------- derived 2-degree columns
        sigma_c, depth_c = derive_two_degree_columns(
            fwd.sigma, fwd.depth, derived, row_ids=row_ids
        )
        sigma_all = torch.cat([fwd.sigma, sigma_c], dim=1)
        depth_all = torch.cat([fwd.depth, depth_c], dim=1)
        roots = torch.cat([sources, derived[:, 0]])

        # ---------------------------------------------------------- backward
        # decomposed max: grid first (this replica's own depth, the round's
        # levels), then the replica-lockstep extension for the loop bound (a
        # no-op on every ported schedule); one readback per round
        grid_max = op.reduce_max_grid(depth_all.max())
        with tracing.span("bc.readback"):
            max_depth = int(op.reduce_max_sync(grid_max))
        bwd = engine.backward_accumulation(
            op, sigma_all, depth_all, omega, max_depth, num_levels=num_levels, checksum=checksum,
            roots=roots,
        )
        delta, bwd_err = bwd if checksum else (bwd, None)

        # --------------------------------------------------------- BC + n_s
        mult = torch.where(roots >= 0, op.root_omega(roots, omega) + 1.0, 0.0)
        root_onehot = row_ids[:, None] == roots[None, :]
        bc_local = torch.where(root_onehot, 0.0, delta * mult[None, :]).sum(dim=1)

        # per-column component size  n_s = Σ_{d ≥ 0} (1 + ω)   (paper §3.4.1)
        ns = op.reduce_sum(((depth_all >= 0) * (1.0 + omega)[:, None]).sum(dim=0))
        with tracing.span("bc.readback"):
            levels = int(grid_max) + 1
        if integrity == "off":
            return bc_local, ns, roots, levels
        claim = op.reduce_sum(bc_local.sum())
        if checksum:
            err = op.reduce_max_grid(torch.maximum(fwd.check_err, bwd_err))
        else:
            err = torch.zeros((), dtype=torch.float32, device=bc_local.device)
        integ = torch.stack([err.to(torch.float32), claim.to(torch.float32)])
        return bc_local, ns, roots, levels, integ


def _weighted_round(op, sources, derived, omega, *, num_levels: int | None,
                    integrity: str) -> tuple:
    """One weighted BC round: the bucket-loop analogue of
    :func:`traversal_round`, with the same return contract.  ``levels``
    holds the round's bucket count.  The 2-degree derivation is level-based
    and refused upstream for weighted runs, so ``derived`` is all padding
    and its columns stay inert.  ``num_levels`` has no weighted meaning
    (the bucket loop's trip count depends on the data) and
    ``integrity="checksum"`` is a level-synchronous lane: both raise;
    ``"audit"`` returns the bc-sum claim with a zero residual."""
    if num_levels is not None:
        raise ValueError(
            "num_levels (static trip count) is not supported for weighted "
            "traversal: the bucket loop's trip count is data-dependent"
        )
    if integrity == "checksum":
        raise ValueError(
            "integrity='checksum' (ABFT level checksums) is level-"
            "synchronous and not supported for weighted traversal; use "
            "integrity='audit'"
        )
    row_ids = op.row_ids()
    src_onehot = (
        (row_ids[:, None] == sources[None, :]) & (sources[None, :] >= 0)
    ).to(torch.float32)
    fwd = engine.forward_buckets(op, src_onehot)
    bucket = bucket_index(fwd.dist, op.delta)  # the weighted depth structure
    sigma_c, depth_c = derive_two_degree_columns(fwd.sigma, bucket, derived, row_ids=row_ids)
    bucket_all = torch.cat([bucket, depth_c], dim=1)
    grid_max = op.reduce_max_grid(bucket_all.max())
    # the lockstep bound and the replica's own bucket count, in one readback
    max_bucket, own_max = engine.readback(torch.stack([op.reduce_max_sync(grid_max), grid_max]))
    delta_acc = engine.backward_buckets(op, fwd.sigma, fwd.dist, omega, max_bucket)
    delta_all = torch.cat([delta_acc, torch.zeros_like(sigma_c)], dim=1)

    roots = torch.cat([sources, derived[:, 0]])
    mult = torch.where(roots >= 0, op.root_omega(roots, omega) + 1.0, 0.0)
    root_onehot = row_ids[:, None] == roots[None, :]
    bc_local = torch.where(root_onehot, 0.0, delta_all * mult[None, :]).sum(dim=1)
    ns = op.reduce_sum(((bucket_all >= 0) * (1.0 + omega)[:, None]).sum(dim=0))
    levels = int(own_max) + 1
    if integrity == "off":
        return bc_local, ns, roots, levels
    claim = op.reduce_sum(bc_local.sum())
    integ = torch.stack([torch.zeros_like(claim, dtype=torch.float32), claim.to(torch.float32)])
    return bc_local, ns, roots, levels, integ


def apply_reduction_corrections(
    bc: np.ndarray,
    prep: OneDegreeReduction,
    schedule: Schedule,
    ns_by_root: dict[int, float],
) -> None:
    """Add the analytic BC credits of the 1-degree/tree reduction.

    Every vertex x with removed branches (S(x) > 0) — residual or removed
    interior — gets 2·S·(n_comp−1−S) + 2·P.  n_comp comes from x's own
    round, the isolated-residual analytic size, or (removed vertices) the
    resolved root's size."""
    n_by_root = dict(ns_by_root)
    for v, n_comp in schedule.analytic_corrections:
        n_by_root[int(v)] = float(n_comp)
    S, P = prep.omega, prep.pair_credit
    for x in np.nonzero(S > 0)[0]:
        x = int(x)
        if prep.removed[x]:
            root, analytic_n = prep.resolve_root(x)
            n_comp = analytic_n if analytic_n >= 0 else n_by_root.get(int(root))
        else:
            n_comp = n_by_root.get(x)
        if n_comp is None:
            raise RuntimeError(f"no component size recorded for vertex {x}")
        bc[x] += leaf_correction(S[x], n_comp, P[x])

@dataclasses.dataclass
class BCResult:
    bc: np.ndarray  # float64 [n]
    schedule: Schedule
    rounds_run: int  # rounds this call committed (resumed ones excluded)
    forward_columns: int  # explicit BFS columns actually traversed
    backward_columns: int  # dependency columns (explicit + derived)
    wall_s: float = 0.0  # host wall time of the round loop (ends synced)
    round_levels: list[int] = dataclasses.field(default_factory=list)
    #   traversal depth of every round run, in commit order
    block_times: list[float] | None = None  # seconds of every dispatch
    #   block, synchronised (profile and straggler modes only)
    straggler_stats: dict | None = None  # multi-ledger scheduler telemetry
    #   (straggler != "none" only): per-replica wall / rounds / levels,
    #   rounds stolen and re-dealt, speculative duplicates, idle estimate
    stopped_early: bool = False  # a stop_rule halted dispatch early
    stop_stats: dict | None = None  # the stop rule's own telemetry
    roots_accumulated: int = 0  # root columns (explicit + derived) of
    #   every committed round, including rounds resumed from a checkpoint
    #   — the k in the sampled estimator's N/k
    sampling_stats: dict | None = None  # set when sampling != "off"
    layout_stats: dict | None = None  # 2-D path: footprint, BCSR tiles stored
    recovery_stats: dict | None = None  # self-healing telemetry (always set
    #   by BCDriver): retries, transient_errors, quarantined_blocks,
    #   fallback_recomputes, remesh_events and dead_replicas (replica
    #   losses the multi-ledger loop re-meshed around), resumed_generation
    #   (the BCCheckpoint generation resumed from; None = cold start) and
    #   the "integrity" sub-dict (mode, checksum / audit failures, max
    #   residual, duplicate votes, mismatches and tie-breaker verdicts,
    #   quarantined rounds, watchdog trips / re-dispatches / escalations),
    #   the same record as the JAX package's, so snapshots carry it across.


def _unpack_block(out) -> tuple:
    """A round_fn output as ``(bc, ns, roots, levels, integ)``: a 4-tuple
    gets ``integ = None``, a 3-tuple (no levels) None in both."""
    out = tuple(out)
    return out + (None,) * (5 - len(out))


def _shipped_derived(ders: np.ndarray) -> np.ndarray:
    """The derived slots ``[fr, w, 3]`` a dispatch block ships of its
    ``[fr, k, 3]``: ``w`` is one past the last slot with a root (c ≥ 0) in
    any lane, 0 when no slot has one.  The slots past ``w`` are padding in
    every lane: shipped, they would only widen the backward loop's
    operand.  While tracing is on, the ``fr · (k − w)`` slots left out
    count as ``trimmed_slots``."""
    claimed = np.flatnonzero((ders[:, :, 0] >= 0).any(axis=0))
    w = int(claimed[-1]) + 1 if claimed.size else 0
    if tracing.on():
        tracing.count_trimmed(ders.shape[0] * (ders.shape[1] - w))
    return np.ascontiguousarray(ders[:, :w])


def _host(x) -> np.ndarray:
    """A tensor (any device) or a list of ints as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


class BCDriver:
    """Host round loop (see module docstring).

    ``round_fn(sources i32 [fr, s], derived i32 [fr, w, 3])`` (tensors on
    the run's device, one round per lane, ``fr = rounds_per_dispatch``;
    ``w ≤ k`` the block's derived slots up to its last claimed one, so 0
    on a block whose derived slots are all padding, :func:`_shipped_derived`)
    must return ``(bc_block f32 [fr, ≥n], ns f32 [fr, s+w],
    roots i32 [fr, s+w], levels [fr])`` — per lane what
    :func:`traversal_round` returns — plus ``integ f32 [fr, 2]`` when
    ``integrity != "off"``.  A short last block and committed rounds are
    dealt as all-padding lanes (sources -1), which contribute nothing;
    the ledger commits each round once its block is accumulated.
    ``stop_rule(bc_running f64 [n], blocks_done) -> bool`` is consulted
    after every block; True halts the loop with everything run so far
    kept.  ``profile=True`` synchronises every block and records its
    seconds in ``BCResult.block_times``.  ``max_inflight`` keeps the JAX
    driver's signature and has no effect: a port round reads its depth
    back to the host, so every block has finished before the next is
    dispatched, and the loop reads each block's n_s and roots at once.

    **Durability.**  ``checkpoint`` (a :class:`BCCheckpoint`; not with a
    ``ledger``) seeds the run from its newest intact snapshot — the f64
    raw accumulator, the per-root n_s and the committed rounds — and
    saves one after every ``checkpoint_every`` blocks and at the end.
    Snapshots hold the raw accumulator: before the 1-degree corrections
    and before any N/k rescale, which are re-applied on every finalize.

    **Self-healing** (telemetry in ``BCResult.recovery_stats``, resumed
    from the snapshot): transient round failures are retried in place
    (``max_retries`` re-dispatches a block, exponential backoff from
    ``retry_backoff_s``, slept through ``sleeper``); ``dispatch_deadline_s``
    arms the watchdog on ``clock``; the numeric guard (``numeric_guard``;
    when None it is on with a ``fallback_round_fn``, under a straggler
    policy and under ``profile``, where the loop syncs every block anyway)
    quarantines non-finite blocks; ``integrity`` (:data:`INTEGRITY_MODES`)
    audits every block, a round's depth against ``level_bound`` (default
    n + 1 levels; a weighted caller passes its bucket bound); a block that
    keeps failing is recomputed through ``fallback_round_fn`` when the
    caller passed one.

    **Straggler scheduling.**  ``straggler`` (:data:`STRAGGLER_POLICIES`)
    runs the multi-ledger loop (:meth:`_run_straggler`): it needs
    ``levels`` and a per-replica leading dim ``fr`` on ``bc_block``, keeps
    one ledger per replica (resumed per lane from the checkpoint; an
    external ``ledger`` is refused) and times every block.
    ``straggler_factor`` is the EWMA ratio that flags a straggler;
    ``prior_round_s`` seeds every replica's EWMA before any round
    completes (the grid passes
    :func:`~repro_torch.core.distributed.prior_round_seconds`; symmetric,
    so no re-deal fires on the prior alone); ``round_costs`` (e.g.
    ``Schedule.round_depths``) deals the initial queues by cost
    (:func:`~repro_torch.core.scheduler.split_rounds`).  A
    :class:`ReplicaLostError` — raised by the round_fn, or by the watchdog
    escalation, which names no replica and so suspects the slowest lane —
    marks that replica dead: its ledger merges into a survivor's, its
    backlog is re-dealt, :func:`plan_elastic_remesh` over ``mesh_shape`` /
    ``mesh_axes`` (default ``(fr,)`` / ``("pod",)``; the grid passes
    ``(fr, R, C)`` / ``("pod", "data", "model")``) is logged, and the dead
    lane runs only padding from then on, so shapes stay static.

    **Agreement.**  Block walls and the watchdog's elapsed time are read
    on ``clock`` and passed through ``agree_seconds`` before any decision
    uses them: on a grid every rank runs this loop, and ranks that saw
    different walls would re-deal, steal or trip differently and post
    different collectives.  The grid entry passes the all-ranks max; None
    (one process) takes the number as read.
    """

    def __init__(
        self,
        round_fn: Callable,
        schedule: Schedule,
        *,
        n: int,
        device: torch.device,
        prep: OneDegreeReduction | None = None,
        ledger: RoundLedger | None = None,
        checkpoint=None,
        checkpoint_every: int = 8,
        stop_rule: Callable[[np.ndarray, int], bool] | None = None,
        rounds_per_dispatch: int = 1,
        max_inflight: int = 2,
        profile: bool = False,
        straggler: str = "none",
        straggler_factor: float = 2.0,
        prior_round_s: float | None = None,
        round_costs=None,
        max_retries: int = DEFAULT_MAX_RETRIES,
        retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
        numeric_guard: bool | None = None,
        fallback_round_fn: Callable | None = None,
        mesh_shape: tuple[int, ...] | None = None,
        mesh_axes: tuple[str, ...] | None = None,
        integrity: str = "off",
        dispatch_deadline_s: float | None = None,
        clock: Callable[[], float] | None = None,
        sleeper: Callable[[float], None] | None = None,
        agree_seconds: Callable[[float], float] | None = None,
        level_bound: int | None = None,
    ):
        if dispatch_deadline_s is not None and float(dispatch_deadline_s) <= 0:
            raise ValueError(f"dispatch_deadline_s must be positive, got {dispatch_deadline_s}")
        if checkpoint is not None and ledger is not None:
            raise ValueError("pass either a ledger or a checkpoint, not both")
        self.straggler = normalize_straggler(straggler)
        if self.straggler != "none" and ledger is not None:
            raise ValueError(
                "straggler scheduling keeps one ledger per replica; "
                "pass a checkpoint (or nothing), not an external ledger"
            )
        self.round_fn = round_fn
        self.schedule = schedule
        self.n = n
        self.device = torch.device(device)
        self.prep = prep
        self.stop_rule = stop_rule
        self.fr = max(1, int(rounds_per_dispatch))
        self.max_inflight = max(1, int(max_inflight))
        self.profile = bool(profile)
        self.straggler_factor = float(straggler_factor)
        self.prior_round_s = prior_round_s
        self.round_costs = round_costs
        self.checkpoint = checkpoint
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.fallback_round_fn = fallback_round_fn
        if numeric_guard is None:
            numeric_guard = (fallback_round_fn is not None or self.straggler != "none"
                             or self.profile)
        self.numeric_guard = bool(numeric_guard)
        self.mesh_shape = tuple(mesh_shape) if mesh_shape is not None else (self.fr,)
        self.mesh_axes = tuple(mesh_axes) if mesh_axes is not None else ("pod",)
        self.integrity = normalize_integrity(integrity)
        #: the audit's bound on a round's reported depth: None is the
        #: unweighted n + 1 levels; a weighted caller passes its bucket
        #: bound, since bucket indices scale with max distance / Δ, not n
        self.level_bound = level_bound
        self.dispatch_deadline_s = (
            None if dispatch_deadline_s is None else float(dispatch_deadline_s)
        )
        # injectable time sources: block walls and the watchdog read
        # ``clock``, the retry backoff sleeps through ``sleeper``, so tests
        # drive both with fakes
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleeper if sleeper is not None else time.sleep
        self._agree = agree_seconds if agree_seconds is not None else float
        self._dead_lanes: set[int] = set()
        #: round -> {"owner": digest, "duplicate": digest} of a duplicate
        #: vote that disagreed, until the tie-breaker re-dispatch commits
        self._pending_votes: dict[int, dict] = {}
        self.recovery: dict = {
            "retries": 0,
            "transient_errors": 0,
            "quarantined_blocks": 0,
            "fallback_recomputes": 0,
            "remesh_events": 0,
            "dead_replicas": [],
            "resumed_generation": None,
            "integrity": {
                "mode": self.integrity,
                "checksum_failures": 0,
                "audit_failures": 0,
                "max_checksum_residual": 0.0,
                "votes": 0,
                "vote_mismatches": 0,
                "vote_verdicts": [],
                "quarantined_rounds": 0,
                "watchdog_trips": 0,
                "watchdog_redispatches": 0,
                "watchdog_escalations": 0,
            },
        }
        # the checkpoint's f64 seed: the raw accumulator and n_s it holds
        self._bc0 = np.zeros(n, np.float64)
        self._ns0: dict[int, float] = {}
        self._fingerprint = None
        if checkpoint is not None:
            self._fingerprint = schedule_fingerprint(n, schedule)
        if self.straggler != "none":
            by_lane: list[list[int]] = [[] for _ in range(self.fr)]
            if checkpoint is not None:
                stored = self._load(checkpoint.load_namespaced)
                if len(stored) == self.fr:
                    by_lane = [list(lane) for lane in stored]
                else:  # the replica count changed across the resume: merge
                    by_lane[0] = sorted({rid for lane in stored for rid in lane})
            self.ledgers = [RoundLedger.from_state(lane) for lane in by_lane]
            self.ledger = None
        else:
            if checkpoint is not None:
                ledger = RoundLedger.from_state(self._load(checkpoint.load))
            self.ledger = ledger
            self.ledgers = None
        if checkpoint is not None:
            self._resume_stats(checkpoint)

    def _load(self, load) -> list:
        """Seed the f64 accumulator and n_s from ``load`` (the checkpoint's
        ``load`` or ``load_namespaced``); returns its committed rounds."""
        bc0, ns0, committed = load(self._fingerprint)
        if bc0 is not None:
            self._bc0 = bc0[: self.n]
            self._ns0 = ns0
        return committed

    # ---------------------------------------------------- self-healing
    def _resume_stats(self, checkpoint) -> None:
        """Take the generation resumed from and the recovery counters the
        snapshot carried, so a kill-and-resume keeps its history."""
        gen = getattr(checkpoint, "loaded_generation", None)
        self.recovery["resumed_generation"] = gen
        if gen is not None:
            (logger.warning if gen > 0 else logger.info)(
                "resumed from checkpoint generation %d%s", gen,
                " (newer snapshots were corrupt)" if gen > 0 else "",
            )
        stored = getattr(checkpoint, "loaded_stats", None)
        if not stored:
            return
        for key in ("retries", "transient_errors", "quarantined_blocks",
                    "fallback_recomputes", "remesh_events"):
            self.recovery[key] = int(stored.get(key, 0))
        sint = stored.get("integrity") or {}
        ist = self.recovery["integrity"]
        for key in ist:
            if key == "vote_verdicts":
                ist[key] = list(sint.get(key, []))
            elif key == "max_checksum_residual":
                ist[key] = float(sint.get(key, 0.0))
            elif key != "mode":
                ist[key] = int(sint.get(key, 0))

    def _stats_state(self) -> dict:
        """JSON-serialisable recovery telemetry for the checkpoint."""
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in self.recovery.items() if k not in ("resumed_generation", "integrity")}
        out["integrity"] = {k: (list(v) if isinstance(v, list) else v)
                            for k, v in self.recovery["integrity"].items()}
        return out

    def _integrity_audit(self, out) -> str | None:
        """Audit one block's output; return a failure reason or None.

        In order: the ABFT residual of the integrity record ("checksum"
        mode), the per-lane bc-sum claim against the recomputed lane sum,
        BC non-negativity, the level and component-size bounds.  The
        O(n·s) work stayed on the device; this reads O(fr + s) numbers.
        """
        bc_blk, ns, _, levels, integ = out
        ist = self.recovery["integrity"]
        sums = _lane_sums(bc_blk)
        mn = float(bc_blk.min())
        scale = max(1.0, float(np.abs(sums).max()))
        if integ is not None:
            ig = _host(integ).astype(np.float64).reshape(-1, 2)
            resid = float(ig[:, 0].max())
            ist["max_checksum_residual"] = max(ist["max_checksum_residual"], resid)
            if resid > CHECKSUM_TOL:
                return f"ABFT checksum residual {resid:.3e} exceeds {CHECKSUM_TOL:g}"
            claims = ig[:, 1]
            if claims.shape[0] == sums.shape[0]:
                diff = float(np.abs(claims - sums).max())
                if diff > CLAIM_RTOL * scale:
                    return f"bc-sum claim mismatch: |claim - sum| = {diff:.3e} (scale {scale:.3e})"
        if mn < -CLAIM_RTOL * scale:
            return f"negative BC contribution (min {mn:.3e})"
        if levels is not None:
            lv = _host(levels)
            bound = self.level_bound if self.level_bound is not None else self.n + 1
            if lv.min() < 0 or lv.max() > bound:
                return f"level bound violation (levels {lv.tolist()})"
        ns_max = float(ns.max()) if ns.numel() else 0.0
        if ns_max > self.n * (1.0 + 1e-5) + 1e-6:
            return f"component size {ns_max:.6g} exceeds n = {self.n}"
        return None

    def _escalate(self, fn, attempt: int, what: str, error: Exception):
        """The shared tail of the quarantine ladder: re-dispatch from the
        budget, then the fallback round_fn (a fresh budget), then raise
        ``error``.  Returns the ``(fn, attempt)`` to retry with."""
        if attempt < self.max_retries:
            self.recovery["retries"] += 1
            logger.warning("%s; block quarantined, re-dispatching (%d/%d)",
                           what, attempt + 1, self.max_retries)
            return fn, attempt + 1
        if self.fallback_round_fn is not None and fn is not self.fallback_round_fn:
            self.recovery["fallback_recomputes"] += 1
            logger.warning("%s persists after %d re-dispatches; recomputing via the "
                           "fallback round_fn", what, self.max_retries)
            return self.fallback_round_fn, 0
        raise error

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _block_wall(self, t0: float) -> float:
        """Seconds on ``clock`` since ``t0`` once the device work queued
        so far has finished, agreed over the ranks."""
        self._sync()
        return self._agree(self._clock() - t0)

    def _dispatch_block(self, srcs: torch.Tensor, ders: torch.Tensor) -> tuple:
        """Run ``round_fn`` on one dispatch block with recovery.

        Transient failures (:func:`is_transient_error`) are retried in
        place with exponential backoff, up to ``max_retries`` re-dispatches
        a block.  With ``dispatch_deadline_s`` a dispatch that completes
        only after the deadline (agreed over the ranks) trips the
        watchdog: re-dispatched from the budget, then escalated as
        :class:`ReplicaLostError`, which the multi-ledger loop re-meshes
        around and the static loop propagates.  Under the numeric guard a
        block with non-finite bc/ns is quarantined — never accumulated —
        and re-dispatched; ``integrity != "off"`` audits every block
        (:meth:`_integrity_audit`) on the same ladder.  Past the budget
        the block is recomputed through ``fallback_round_fn`` when one was
        given, else ``FloatingPointError`` / :class:`IntegrityError` is
        raised.  Returns the unpacked 5-tuple.
        """
        fn, attempt = self.round_fn, 0
        left_out = self.schedule.derived_per_round - ders.shape[1]
        while True:
            try:
                t0 = self._clock()
                with tracing.trimming(left_out):
                    out = _unpack_block(fn(srcs, ders))
            except Exception as e:
                if is_transient_error(e) and attempt < self.max_retries:
                    backoff = self.retry_backoff_s * (2.0 ** attempt)
                    self.recovery["transient_errors"] += 1
                    self.recovery["retries"] += 1
                    logger.warning("transient round failure (%s: %s); retry %d/%d after "
                                   "%.3fs backoff", type(e).__name__, e, attempt + 1,
                                   self.max_retries, backoff)
                    self._sleep(backoff)
                    attempt += 1
                    continue
                raise
            if self.dispatch_deadline_s is not None:
                elapsed = self._block_wall(t0)  # the deadline covers the device work
                if elapsed > self.dispatch_deadline_s:
                    ist = self.recovery["integrity"]
                    ist["watchdog_trips"] += 1
                    if attempt < self.max_retries:
                        ist["watchdog_redispatches"] += 1
                        self.recovery["retries"] += 1
                        logger.warning("dispatch watchdog: block took %.3fs > deadline %.3fs; "
                                       "re-dispatching (%d/%d)", elapsed,
                                       self.dispatch_deadline_s, attempt + 1, self.max_retries)
                        attempt += 1
                        continue
                    ist["watchdog_escalations"] += 1
                    raise ReplicaLostError(
                        -1, f"dispatch exceeded its {self.dispatch_deadline_s:.3f}s deadline "
                        f"{attempt + 1} times (last {elapsed:.3f}s); treating a replica as "
                        f"wedged")
            if self.numeric_guard and not bool(
                    torch.isfinite(out[0]).all() & torch.isfinite(out[1]).all()):
                self.recovery["quarantined_blocks"] += 1
                fn, attempt = self._escalate(
                    fn, attempt, "non-finite bc/ns block",
                    FloatingPointError(
                        f"non-finite bc/ns block output persisted through {self.max_retries} "
                        f"re-dispatches" + self._fallback_note()))
                continue
            if self.integrity != "off":
                reason = self._integrity_audit(out)
                if reason is not None:
                    ist = self.recovery["integrity"]
                    ist["checksum_failures" if "checksum" in reason else "audit_failures"] += 1
                    self.recovery["quarantined_blocks"] += 1
                    fn, attempt = self._escalate(
                        fn, attempt, f"integrity audit failed ({reason})",
                        IntegrityError(
                            f"round block failed its integrity audit ({reason}) through "
                            f"{self.max_retries} re-dispatches" + self._fallback_note()))
                    continue
            return out

    def _fallback_note(self) -> str:
        return (" and the fallback round_fn" if self.fallback_round_fn is not None
                else " (no fallback_round_fn supplied)")

    # ------------------------------------------------------------ loop
    def _blocks(self):
        """Yield ``(sources [fr, s], derived [fr, w, 3], live)`` dispatch
        blocks as int32 tensors on the device (``w ≤ k`` the block's
        shipped derived slots, :func:`_shipped_derived`), ``live`` listing the
        ``(lane, round_id)`` pairs that carry an uncommitted round; blocks
        with none are skipped."""
        s = self.schedule.batch_size
        k = self.schedule.derived_per_round
        rounds = self.schedule.rounds
        for start in range(0, len(rounds), self.fr):
            srcs = np.full((self.fr, s), -1, np.int32)
            ders = np.full((self.fr, k, 3), -1, np.int32)
            live = []
            for lane, rnd in enumerate(rounds[start : start + self.fr]):
                rid = start + lane
                if self.ledger is not None and self.ledger.is_committed(rid):
                    continue  # already accumulated by a previous run
                srcs[lane] = rnd.sources
                ders[lane] = rnd.derived
                live.append((lane, rid))
            if live:
                yield (
                    torch.from_numpy(srcs).to(self.device),
                    torch.from_numpy(_shipped_derived(ders)).to(self.device),
                    live,
                )

    def _count_roots(self, rids) -> int:
        """Root columns (explicit + derived) across the given rounds."""
        rounds = self.schedule.rounds
        return sum(
            int((rounds[rid].sources >= 0).sum())
            + int((rounds[rid].derived[:, 0] >= 0).sum())
            for rid in rids
        )

    def _columns(self, rid: int) -> tuple[int, int]:
        """(forward, backward) columns of round ``rid``: its explicit
        sources, and those plus its derived columns."""
        rnd = self.schedule.rounds[rid]
        explicit = int((rnd.sources >= 0).sum())
        return explicit, explicit + int((rnd.derived[:, 0] >= 0).sum())

    def _collect_bc(self, bc_acc: torch.Tensor | None) -> np.ndarray:
        """The checkpoint's f64 seed plus the f32 device accumulator, as
        per-vertex f64 host scores (the replica lanes are additive, paper
        §3.3)."""
        if bc_acc is None:
            return self._bc0.copy()
        with tracing.span("bc.readback"):
            return self._bc0 + bc_acc.cpu().numpy().astype(np.float64).sum(axis=0)[: self.n]

    def _finalize(self, bc_acc, ns_by_root) -> np.ndarray:
        bc = self._collect_bc(bc_acc)
        if self.prep is not None:
            apply_reduction_corrections(bc, self.prep, self.schedule, ns_by_root)
        return bc

    def _stop(self, bc_acc, blocks_done: int, committed: int) -> bool:
        """Consult the stop rule after a block (False without one)."""
        if self.stop_rule is None or not self.stop_rule(self._collect_bc(bc_acc), blocks_done):
            return False
        logger.info("stop rule fired after %d dispatch blocks (%d rounds committed); "
                    "halting dispatch", blocks_done, committed)
        return True

    def run(self) -> BCResult:
        if self.straggler != "none":
            return self._run_straggler()
        return self._run_static()

    def _run_static(self) -> BCResult:
        """The static deal: block ``i`` runs rounds ``[i·fr, (i+1)·fr)``,
        one shared ledger, each block committed once accumulated."""
        bc_acc: torch.Tensor | None = None
        ns_by_root: dict[int, float] = dict(self._ns0)
        # every committed round, the resumed ones included: the snapshot's
        # committed set and the sampled estimator's k count them all
        committed: list[int] = self.ledger.state() if self.checkpoint is not None else []
        round_levels: list[int] = []
        block_times: list[float] | None = [] if self.profile else None
        rounds_run = fwd_cols = bwd_cols = 0
        stopped_early = False
        blocks_done = blocks_since_snapshot = 0
        t_start = time.perf_counter()

        def snapshot():
            # every dispatched block is committed and read back by now, so
            # (bc, ns, committed) is a consistent prefix
            self.checkpoint.save(self._collect_bc(bc_acc), ns_by_root, committed,
                                 self._fingerprint, stats=self._stats_state())

        for sources, derived, live in self._blocks():
            with tracing.span("bc.block"):
                t_blk = self._clock()
                bc_blk, ns, roots, levels, _ = self._dispatch_block(sources, derived)
                if block_times is not None:
                    block_times.append(self._block_wall(t_blk))
                bc_acc = bc_blk if bc_acc is None else bc_acc.add_(bc_blk)
                with tracing.span("bc.readback"):
                    roots_np = roots.cpu().numpy()
                    ns_np = ns.cpu().numpy().astype(np.float64)
                    levels_np = _host(levels)
                for lane, rid in live:
                    for root, nv in zip(roots_np[lane], ns_np[lane]):
                        if root >= 0:
                            ns_by_root[int(root)] = float(nv)
                    # commit once the block's contribution exists: a crash
                    # before this point re-deals the round
                    if self.ledger is not None:
                        self.ledger.try_commit(rid)
                    committed.append(rid)
                    rounds_run += 1
                    round_levels.append(int(levels_np[lane]))
                    fwd, bwd = self._columns(rid)
                    fwd_cols += fwd
                    bwd_cols += bwd
            blocks_done += 1
            blocks_since_snapshot += 1
            if self.checkpoint is not None and blocks_since_snapshot >= self.checkpoint_every:
                snapshot()
                blocks_since_snapshot = 0
            if self._stop(bc_acc, blocks_done, len(committed)):
                stopped_early = True
                break
        if self.checkpoint is not None:
            snapshot()
        bc = self._finalize(bc_acc, ns_by_root)  # the fetch synchronises
        return BCResult(
            bc=bc,
            schedule=self.schedule,
            rounds_run=rounds_run,
            forward_columns=fwd_cols,
            backward_columns=bwd_cols,
            wall_s=time.perf_counter() - t_start,
            round_levels=round_levels,
            block_times=block_times,
            stopped_early=stopped_early,
            stop_stats=getattr(self.stop_rule, "stats", None),
            roots_accumulated=self._count_roots(committed),
            recovery_stats=dict(self.recovery),
        )

    # ------------------------------------------- multi-ledger scheduler
    def _committed_union(self) -> set[int]:
        out: set[int] = set()
        for led in self.ledgers:
            out |= set(led.state())
        return out

    def _try_commit(self, lane: int, rid: int) -> bool:
        """Exactly once across every replica ledger (first commit wins)."""
        if any(led.is_committed(rid) for led in self.ledgers):
            return False
        return self.ledgers[lane].try_commit(rid)

    def _run_straggler(self) -> BCResult:
        """The multi-ledger sub-cluster round loop (steal / redeal), the
        JAX package's decision for decision.

        * one round queue and one :class:`RoundLedger` per replica, seeded
          by :func:`split_rounds` minus whatever any ledger committed;
        * every block is timed (synchronised, agreed over the ranks) and
          its wall attributed to the replicas by their share of the
          block's traversal ``levels`` — under replica lockstep the wall
          is shared, so the depth share is the per-replica signal —
          feeding a per-replica EWMA of per-round seconds;
        * commits happen at drain time, originals before duplicates, and
          the accumulate is masked by the outcome, so a round run on two
          lanes counts once;
        * between blocks the policy moves pending rounds: ``steal`` pulls
          into idle lanes and duplicates the presumed straggler's round at
          the tail; ``redeal`` re-packs every pending round when the EWMA
          ratio crosses ``straggler_factor`` (on its rising edge) or when
          a queue ran dry beside one with two or more rounds;
        * under ``integrity != "off"`` a duplicated round's two lanes vote
          on their bc sums: a mismatch quarantines the round (neither lane
          commits) and re-dispatches it to its owner as the tie-breaker.
        """
        fr = self.fr
        s = self.schedule.batch_size
        k = self.schedule.derived_per_round
        rounds = self.schedule.rounds
        queues = split_rounds(len(rounds), fr, self._committed_union(),
                              round_costs=self.round_costs)

        prior = self.prior_round_s
        ewma: list[float | None] = [None] * fr
        observed = [False] * fr

        def est(r: int) -> float:
            if ewma[r] is not None:
                return ewma[r]
            return prior if prior is not None else 1.0

        bc_acc: torch.Tensor | None = None
        ns_by_root: dict[int, float] = dict(self._ns0)
        round_levels: list[int] = []
        rounds_run = fwd_cols = bwd_cols = 0
        stopped_early = False
        blocks_since_snapshot = 0
        block_times: list[float] = []
        stats = {
            "policy": self.straggler,
            "factor": self.straggler_factor,
            "replicas": fr,
            "rounds_stolen": 0,
            "rounds_redealt": 0,
            "redeal_events": 0,
            "duplicates_dispatched": 0,
            "duplicates_discarded": 0,
            "per_replica_wall_s": [0.0] * fr,
            "per_replica_rounds": [0] * fr,
            "per_replica_levels": [0] * fr,
            "idle_levels": 0,
            "idle_s_est": 0.0,
        }
        was_flagged = False
        t_start = time.perf_counter()

        def flagged() -> bool:
            vals = [ewma[r] for r in range(fr) if observed[r] and r not in self._dead_lanes]
            if len(vals) < 2:
                return False
            lo, hi = min(vals), max(vals)
            return lo > 0.0 and hi > self.straggler_factor * lo

        def on_replica_loss(err, lane_rids, duplicate):
            """Heal a lost replica lane (nothing of the failed block
            landed): move its ledger's commits to a survivor (the
            committed union, hence exactly-once, is unchanged), re-deal its
            backlog, log the elasticity plan, and go on at a smaller
            effective fr (the dead lane runs padding from here on)."""
            dead = int(getattr(err, "replica", -1))
            if dead < 0 or dead >= fr or dead in self._dead_lanes:
                raise err
            self._dead_lanes.add(dead)
            survivors = [r for r in range(fr) if r not in self._dead_lanes]
            if not survivors:
                raise err
            self.recovery["remesh_events"] += 1
            self.recovery["dead_replicas"] = sorted(self._dead_lanes)
            # the failed block's owned rounds go back to the front of a
            # surviving queue (a duplicate's owner requeues its own copy)
            for r in range(fr):
                rid = lane_rids[r]
                if rid is None or duplicate[r]:
                    continue
                if any(led.is_committed(rid) for led in self.ledgers):
                    continue
                queues[r if r in survivors else survivors[0]].insert(0, rid)
            taken = self.ledgers[survivors[0]].merge(self.ledgers[dead])
            orphans = list(queues[dead])
            queues[dead] = []
            for i, rid in enumerate(orphans):
                queues[survivors[i % len(survivors)]].append(rid)
            sub, _ = redeal_rounds([queues[r] for r in survivors], [est(r) for r in survivors])
            for r, q in zip(survivors, sub):
                queues[r] = q
            try:
                total = 1
                for dim in self.mesh_shape:
                    total *= dim
                pod_ax = self.mesh_axes.index("pod") if "pod" in self.mesh_axes else 0
                per_pod = max(1, total // max(1, self.mesh_shape[pod_ax]))
                plan = plan_elastic_remesh(self.mesh_shape, self.mesh_axes,
                                           per_pod * len(self._dead_lanes))
                logger.warning(
                    "replica %d lost: re-mesh %s -> %s (%s); merged %d committed rounds "
                    "into replica %d, re-dealt %d pending", dead, self.mesh_shape, plan.shape,
                    plan.note, taken, survivors[0], len(orphans))
            except ValueError as pe:  # the plan is advice: the loop goes on either way
                logger.warning(
                    "replica %d lost: elastic re-mesh planning failed (%s); continuing on "
                    "%d surviving lanes", dead, pe, len(survivors))

        def snapshot():
            self.checkpoint.save(self._collect_bc(bc_acc), ns_by_root,
                                 [led.state() for led in self.ledgers], self._fingerprint,
                                 stats=self._stats_state())

        while any(queues):
            alive = [r for r in range(fr) if r not in self._dead_lanes]
            # ---------------------------------------- policy: move work
            if self.straggler == "redeal":
                lengths = [len(queues[r]) for r in alive]
                fire = flagged()
                tail_gap = min(lengths) == 0 and max(lengths) >= 2
                if (fire and not was_flagged) or tail_gap:
                    sub, moved = redeal_rounds([queues[r] for r in alive],
                                               [est(r) for r in alive])
                    for r, q in zip(alive, sub):
                        queues[r] = q
                    if moved:
                        stats["rounds_redealt"] += moved
                        stats["redeal_events"] += 1
                        logger.info("straggler redeal: moved %d pending rounds (EWMA s/round: "
                                    "%s)", moved,
                                    [None if ewma[r] is None else round(ewma[r], 6)
                                     for r in alive])
                was_flagged = fire

            # ----------------------------------------------- form block
            lane_rids: list[int | None] = [
                queues[r].pop(0) if r not in self._dead_lanes and queues[r] else None
                for r in range(fr)
            ]
            duplicate = [False] * fr
            if self.straggler == "steal":
                # idle lanes pull from the heaviest remaining backlog
                for r in sorted(alive, key=est):
                    if lane_rids[r] is not None:
                        continue
                    donors = [d for d in alive if queues[d]]
                    if not donors:
                        continue
                    donor = max(donors, key=lambda d: len(queues[d]) * est(d))
                    lane_rids[r] = queues[donor].pop(0)
                    stats["rounds_stolen"] += 1
                # the tail: lanes still idle back up the presumed
                # straggler's round instead of running padding
                working = [r for r in alive if lane_rids[r] is not None]
                idle = [r for r in alive if lane_rids[r] is None]
                if working and idle:
                    slowest = max(working, key=est)
                    for r in idle:
                        lane_rids[r] = lane_rids[slowest]
                        duplicate[r] = True
                        stats["duplicates_dispatched"] += 1
            if all(rid is None for rid in lane_rids):
                continue

            srcs = np.full((fr, s), -1, np.int32)
            ders = np.full((fr, k, 3), -1, np.int32)
            for r, rid in enumerate(lane_rids):
                if rid is not None:
                    srcs[r] = rounds[rid].sources
                    ders[r] = rounds[rid].derived

            # ------------------------------------- dispatch + observe
            t_blk = self._clock()
            try:
                out = self._dispatch_block(
                    torch.from_numpy(srcs).to(self.device),
                    torch.from_numpy(_shipped_derived(ders)).to(self.device))
            except ReplicaLostError as e:
                if int(getattr(e, "replica", -1)) < 0:
                    # the watchdog escalated without knowing which lane
                    # hung: suspect the slowest live lane by EWMA
                    cands = [r for r in alive if lane_rids[r] is not None] or alive
                    suspect = max(cands, key=est)
                    e = ReplicaLostError(
                        suspect, f"{e}; suspecting replica {suspect} (slowest EWMA among the "
                        f"dispatched lanes)")
                on_replica_loss(e, lane_rids, duplicate)
                continue
            bc_blk, ns_dev, roots_dev, levels_dev, _ = out
            if levels_dev is None:
                raise ValueError("straggler scheduling needs a round_fn returning "
                                 "(bc, ns, roots, levels); got a 3-tuple")
            wall = self._block_wall(t_blk)
            block_times.append(wall)
            if bc_blk.shape[0] != fr:
                raise ValueError(f"straggler scheduling needs a per-replica bc block "
                                 f"(leading dim {fr}); got shape {tuple(bc_blk.shape)}")
            levels_np = _host(levels_dev).astype(np.int64)
            # duplicate lanes ran work they will discard: no wall share and
            # no EWMA update (the round's cost belongs to its owner lane,
            # which is in this block too)
            own = [r for r in range(fr) if lane_rids[r] is not None and not duplicate[r]]
            lv_total = int(levels_np[own].sum())
            lv_max = int(levels_np[own].max()) if own else 0
            for r in own:
                share = levels_np[r] / lv_total if lv_total > 0 else 1.0 / len(own)
                obs = wall * float(share)
                if ewma[r] is None and prior is None:
                    ewma[r] = obs
                else:
                    ewma[r] = _EWMA_ALPHA * obs + (1.0 - _EWMA_ALPHA) * est(r)
                observed[r] = True
                stats["per_replica_wall_s"][r] += obs
                stats["per_replica_levels"][r] += int(levels_np[r])
                stats["idle_levels"] += lv_max - int(levels_np[r])
            if lv_max > 0 and own:
                idle_frac = sum(lv_max - int(levels_np[r]) for r in own) / (len(own) * lv_max)
                stats["idle_s_est"] += wall * idle_frac

            # ----------------------- the duplicate vote (the steal tail)
            # a duplicated round ran the same deterministic computation on
            # two lanes; digests that differ mean one lane is silently
            # corrupt, so neither copy commits: the round is quarantined
            # and re-dispatched to its owner as the tie-breaker
            quarantined: set[int] = set()
            lane_sums = None
            if self.integrity != "off" and (any(duplicate) or self._pending_votes):
                lane_sums = _lane_sums(bc_blk)
            if lane_sums is not None and any(duplicate):
                ist = self.recovery["integrity"]
                for r in range(fr):
                    if not duplicate[r]:
                        continue
                    rid = lane_rids[r]
                    owner = next(o for o in range(fr)
                                 if lane_rids[o] == rid and not duplicate[o])
                    ist["votes"] += 1
                    if not _votes_agree(lane_sums[r], lane_sums[owner]):
                        ist["vote_mismatches"] += 1
                        if rid in quarantined:
                            continue  # already requeued by another copy
                        ist["quarantined_rounds"] += 1
                        quarantined.add(rid)
                        self._pending_votes[rid] = {"owner": float(lane_sums[owner]),
                                                    "duplicate": float(lane_sums[r])}
                        queues[owner].insert(0, rid)
                        logger.warning(
                            "duplicate-vote mismatch on round %d (owner lane %d sum %.6g vs "
                            "duplicate lane %d sum %.6g); round quarantined, re-dispatching as "
                            "tie-breaker", rid, owner, lane_sums[owner], r, lane_sums[r])

            # -------------------------- drain: commit or discard, then add
            # originals commit before their duplicates, so a backup copy
            # never out-commits the lane that owns the round
            mask = np.zeros(fr, np.float32)
            roots_np = roots_dev.cpu().numpy()
            ns_np = ns_dev.cpu().numpy().astype(np.float64)
            for r in sorted(range(fr), key=lambda r: duplicate[r]):
                rid = lane_rids[r]
                if rid is None or rid in quarantined:
                    continue
                if self._try_commit(r, rid):
                    mask[r] = 1.0
                    rounds_run += 1
                    stats["per_replica_rounds"][r] += 1
                    round_levels.append(int(levels_np[r]))
                    fwd, bwd = self._columns(rid)
                    fwd_cols += fwd
                    bwd_cols += bwd
                    for root, nv in zip(roots_np[r], ns_np[r]):
                        if root >= 0:
                            ns_by_root[int(root)] = float(nv)
                    pend = self._pending_votes.pop(rid, None)
                    if pend is not None and lane_sums is not None:
                        # the tie-breaker's verdict: which original lane
                        # agreed with this clean recompute
                        tie = float(lane_sums[r])
                        matched = ("owner" if _votes_agree(tie, pend["owner"])
                                   else "duplicate" if _votes_agree(tie, pend["duplicate"])
                                   else "neither")
                        self.recovery["integrity"]["vote_verdicts"].append(
                            {"round": int(rid), "matched": matched})
                        logger.warning("duplicate-vote tie-breaker for round %d: the %s lane "
                                       "was correct", rid, matched)
                elif duplicate[r]:
                    stats["duplicates_discarded"] += 1
            contrib = bc_blk * torch.from_numpy(mask).to(bc_blk.device)[:, None]
            bc_acc = contrib if bc_acc is None else bc_acc.add_(contrib)

            blocks_since_snapshot += 1
            if self.checkpoint is not None and blocks_since_snapshot >= self.checkpoint_every:
                snapshot()
                blocks_since_snapshot = 0
            # commits of this block are settled: halting here leaves a
            # clean committed prefix for the checkpoint
            if self._stop(bc_acc, len(block_times), rounds_run):
                stopped_early = True
                break

        if self.checkpoint is not None:
            snapshot()
        bc = self._finalize(bc_acc, ns_by_root)
        wall_s = time.perf_counter() - t_start
        logger.info(
            "straggler=%s: %d rounds, %d stolen, %d re-dealt (%d events), %d/%d duplicates "
            "discarded, idle ≈ %.3fs of %.3fs wall", self.straggler, rounds_run,
            stats["rounds_stolen"], stats["rounds_redealt"], stats["redeal_events"],
            stats["duplicates_discarded"], stats["duplicates_dispatched"],
            stats["idle_s_est"], wall_s)
        return BCResult(
            bc=bc,
            schedule=self.schedule,
            rounds_run=rounds_run,
            forward_columns=fwd_cols,
            backward_columns=bwd_cols,
            wall_s=wall_s,
            round_levels=round_levels,
            block_times=block_times,
            straggler_stats=stats,
            stopped_early=stopped_early,
            stop_stats=getattr(self.stop_rule, "stats", None),
            roots_accumulated=self._count_roots(sorted(self._committed_union())),
            recovery_stats=dict(self.recovery),
        )


def _lane_sums(bc_blk: torch.Tensor) -> np.ndarray:
    """Per-lane f64 sums of a [fr, ...] block: the claim audit's and the
    duplicate vote's digests."""
    return bc_blk.reshape(bc_blk.shape[0], -1).double().sum(dim=1).cpu().numpy()


def _votes_agree(a: float, b: float) -> bool:
    return abs(a - b) <= VOTE_RTOL * max(1.0, abs(a), abs(b))
