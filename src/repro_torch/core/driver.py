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
committed, adds each block's contribution into an f32 accumulator on the
device, reads the block's n_s and roots back to the host (the 1-degree
corrections need them), and fetches the accumulator as f64 at the end,
summing the replicas onto the checkpoint's f64 seed.  Every block goes
through the recovery ladder of :meth:`BCDriver._dispatch_block`
(transient retry, watchdog, numeric guard, integrity audit, fallback).
The multi-ledger straggler loop, its duplicate vote and re-meshing are
ROADMAP Queue 1 item 8.
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
    schedule_fingerprint,
)
from . import engine
from .heuristics.one_degree import OneDegreeReduction, leaf_correction
from ..kernels.ops import bucket_index
from .heuristics.two_degree import derive_two_degree_columns
from .operators import TraversalOperator
from .scheduler import Schedule

__all__ = [
    "BCResult",
    "BCDriver",
    "traversal_round",
    "apply_reduction_corrections",
    "INTEGRITY_MODES",
    "CHECKSUM_TOL",
    "CLAIM_RTOL",
    "normalize_integrity",
    "DEFAULT_MAX_RETRIES",
    "DEFAULT_RETRY_BACKOFF_S",
]

logger = logging.getLogger(__name__)

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

#: ABFT residual threshold: healthy f32 sums land around 1e-7 relative;
#: 1e-3 leaves orders of magnitude of slack for summation order while
#: still catching any corruption that could move BC beyond parity.
CHECKSUM_TOL = 1e-3
#: Relative tolerance of the bc-sum claim audit (in-round claim against
#: the host-recomputed lane sum: two f32 sums in different orders).
CLAIM_RTOL = 1e-4


def normalize_integrity(mode: str | None) -> str:
    """Validate an integrity mode string (None means "off")."""
    mode = "off" if mode is None else mode
    if mode not in INTEGRITY_MODES:
        raise ValueError(
            f"unknown integrity mode {mode!r}; expected one of {INTEGRITY_MODES}"
        )
    return mode


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
    fwd = engine.forward_counting(op, src_onehot, num_levels=num_levels, checksum=checksum)

    # ------------------------------------------- derived 2-degree columns
    sigma_c, depth_c = derive_two_degree_columns(
        fwd.sigma, fwd.depth, derived, row_ids=row_ids
    )
    sigma_all = torch.cat([fwd.sigma, sigma_c], dim=1)
    depth_all = torch.cat([fwd.depth, depth_c], dim=1)

    # ---------------------------------------------------------- backward
    # decomposed max: grid first (this replica's own depth, the round's
    # levels), then the replica-lockstep extension for the loop bound (a
    # no-op on every ported schedule); one readback per round
    grid_max = op.reduce_max_grid(depth_all.max())
    max_depth = int(op.reduce_max_sync(grid_max))
    bwd = engine.backward_accumulation(
        op, sigma_all, depth_all, omega, max_depth, num_levels=num_levels, checksum=checksum
    )
    delta, bwd_err = bwd if checksum else (bwd, None)

    # --------------------------------------------------------- BC + n_s
    roots = torch.cat([sources, derived[:, 0]])
    mult = torch.where(roots >= 0, op.root_omega(roots, omega) + 1.0, 0.0)
    root_onehot = row_ids[:, None] == roots[None, :]
    bc_local = torch.where(root_onehot, 0.0, delta * mult[None, :]).sum(dim=1)

    # per-column component size  n_s = Σ_{d ≥ 0} (1 + ω)   (paper §3.4.1)
    ns = op.reduce_sum(((depth_all >= 0) * (1.0 + omega)[:, None]).sum(dim=0))
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
    #   traversal depth of every round run, in dispatch order
    stopped_early: bool = False  # a stop_rule halted dispatch early
    stop_stats: dict | None = None  # the stop rule's own telemetry
    roots_accumulated: int = 0  # root columns (explicit + derived) of
    #   every committed round, including rounds resumed from a checkpoint
    #   — the k in the sampled estimator's N/k
    sampling_stats: dict | None = None  # set when sampling != "off"
    layout_stats: dict | None = None  # 2-D path: footprint, BCSR tiles stored
    recovery_stats: dict | None = None  # self-healing telemetry (always set
    #   by BCDriver): retries, transient_errors, quarantined_blocks,
    #   fallback_recomputes, resumed_generation (the BCCheckpoint
    #   generation resumed from; None = cold start) and the "integrity"
    #   sub-dict (mode, checksum / audit failures, max residual, watchdog
    #   trips / re-dispatches / escalations).  The JAX package's remesh
    #   and vote keys are kept (always 0 here) so snapshots carry the
    #   same record in both packages.


def _unpack_block(out) -> tuple:
    """A round_fn output as ``(bc, ns, roots, levels, integ)`` (a 4-tuple
    gets ``integ = None``)."""
    return tuple(out) if len(out) == 5 else tuple(out) + (None,)


def _host(x) -> np.ndarray:
    """A tensor (any device) or a list of ints as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


class BCDriver:
    """Host round loop (see module docstring).

    ``round_fn(sources i32 [fr, s], derived i32 [fr, k, 3])`` (tensors on
    the run's device, one round per lane, ``fr = rounds_per_dispatch``)
    must return ``(bc_block f32 [fr, ≥n], ns f32 [fr, s+k],
    roots i32 [fr, s+k], levels [fr])`` — per lane what
    :func:`traversal_round` returns — plus ``integ f32 [fr, 2]`` when
    ``integrity != "off"``.  A short last block and committed rounds are
    dealt as all-padding lanes (sources -1), which contribute nothing;
    the ledger commits each round once its block is accumulated.
    ``stop_rule(bc_running f64 [n], blocks_done) -> bool`` is consulted
    after every block; True halts the loop with everything run so far
    kept.

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
    arms the watchdog on ``clock``; the numeric guard (``numeric_guard``,
    on by default only with a ``fallback_round_fn``) quarantines
    non-finite blocks; ``integrity`` (:data:`INTEGRITY_MODES`) audits
    every block, a round's depth against ``level_bound`` (default n + 1
    levels; a weighted caller passes its bucket bound); a block that keeps
    failing is recomputed through
    ``fallback_round_fn`` when the caller passed one.
    ``straggler`` keeps the JAX driver's signature; anything but "none"
    raises until ROADMAP Queue 1 item 8 ports the multi-ledger loop.
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
        straggler: str = "none",
        max_retries: int = DEFAULT_MAX_RETRIES,
        retry_backoff_s: float = DEFAULT_RETRY_BACKOFF_S,
        numeric_guard: bool | None = None,
        fallback_round_fn: Callable | None = None,
        integrity: str = "off",
        dispatch_deadline_s: float | None = None,
        clock: Callable[[], float] | None = None,
        sleeper: Callable[[float], None] | None = None,
        level_bound: int | None = None,
    ):
        if straggler != "none":
            raise NotImplementedError(
                f"BCDriver(straggler={straggler!r}) is not ported yet (ROADMAP Queue 1 item 8: "
                f"the multi-ledger loop)"
            )
        if dispatch_deadline_s is not None and float(dispatch_deadline_s) <= 0:
            raise ValueError(f"dispatch_deadline_s must be positive, got {dispatch_deadline_s}")
        if checkpoint is not None and ledger is not None:
            raise ValueError("pass either a ledger or a checkpoint, not both")
        self.round_fn = round_fn
        self.schedule = schedule
        self.n = n
        self.device = torch.device(device)
        self.prep = prep
        self.stop_rule = stop_rule
        self.fr = max(1, int(rounds_per_dispatch))
        self.checkpoint = checkpoint
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.fallback_round_fn = fallback_round_fn
        self.numeric_guard = (
            fallback_round_fn is not None if numeric_guard is None else bool(numeric_guard)
        )
        self.integrity = normalize_integrity(integrity)
        #: the audit's bound on a round's reported depth: None is the
        #: unweighted n + 1 levels; a weighted caller passes its bucket
        #: bound, since bucket indices scale with max distance / Δ, not n
        self.level_bound = level_bound
        self.dispatch_deadline_s = (
            None if dispatch_deadline_s is None else float(dispatch_deadline_s)
        )
        # injectable time sources: the watchdog measures a dispatch through
        # ``clock`` and the retry backoff sleeps through ``sleeper``, so
        # tests drive both with fakes
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleeper if sleeper is not None else time.sleep
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
            bc0, ns0, committed = checkpoint.load(self._fingerprint)
            if bc0 is not None:
                self._bc0 = bc0[:n]
                self._ns0 = ns0
            ledger = RoundLedger.from_state(committed)
            self._resume_stats(checkpoint)
        self.ledger = ledger

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
        lanes = bc_blk.reshape(bc_blk.shape[0], -1)
        sums = lanes.double().sum(dim=1).cpu().numpy()
        mn = float(lanes.min())
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

    def _dispatch_block(self, srcs: torch.Tensor, ders: torch.Tensor) -> tuple:
        """Run ``round_fn`` on one dispatch block with recovery.

        Transient failures (:func:`is_transient_error`) are retried in
        place with exponential backoff, up to ``max_retries`` re-dispatches
        a block.  With ``dispatch_deadline_s`` a dispatch that completes
        only after the deadline trips the watchdog: re-dispatched from the
        budget, then escalated as :class:`ReplicaLostError` (a single loop
        has no spare lane to absorb it).  Under the numeric guard a block
        with non-finite bc/ns is quarantined — never accumulated — and
        re-dispatched; ``integrity != "off"`` audits every block
        (:meth:`_integrity_audit`) on the same ladder.  Past the budget
        the block is recomputed through ``fallback_round_fn`` when one was
        given, else ``FloatingPointError`` / :class:`IntegrityError` is
        raised.  Returns the unpacked 5-tuple.
        """
        fn, attempt = self.round_fn, 0
        while True:
            try:
                t0 = self._clock()
                out = _unpack_block(fn(srcs, ders))
                if self.dispatch_deadline_s is not None and self.device.type == "cuda":
                    # the deadline covers the device work of the call
                    torch.cuda.synchronize(self.device)
                elapsed = self._clock() - t0
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
            if self.dispatch_deadline_s is not None and elapsed > self.dispatch_deadline_s:
                ist = self.recovery["integrity"]
                ist["watchdog_trips"] += 1
                if attempt < self.max_retries:
                    ist["watchdog_redispatches"] += 1
                    self.recovery["retries"] += 1
                    logger.warning("dispatch watchdog: block took %.3fs > deadline %.3fs; "
                                   "re-dispatching (%d/%d)", elapsed, self.dispatch_deadline_s,
                                   attempt + 1, self.max_retries)
                    attempt += 1
                    continue
                ist["watchdog_escalations"] += 1
                raise ReplicaLostError(
                    -1, f"dispatch exceeded its {self.dispatch_deadline_s:.3f}s deadline "
                    f"{attempt + 1} times (last {elapsed:.3f}s); treating a replica as wedged")
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
        """Yield ``(sources [fr, s], derived [fr, k, 3], live)`` dispatch
        blocks as int32 tensors on the device, ``live`` listing the
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
                    torch.from_numpy(ders).to(self.device),
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

    def _collect_bc(self, bc_acc: torch.Tensor | None) -> np.ndarray:
        """The checkpoint's f64 seed plus the f32 device accumulator, as
        per-vertex f64 host scores (the replica lanes are additive, paper
        §3.3)."""
        if bc_acc is None:
            return self._bc0.copy()
        return self._bc0 + bc_acc.cpu().numpy().astype(np.float64).sum(axis=0)[: self.n]

    def _finalize(self, bc_acc, ns_by_root) -> np.ndarray:
        bc = self._collect_bc(bc_acc)
        if self.prep is not None:
            apply_reduction_corrections(bc, self.prep, self.schedule, ns_by_root)
        return bc

    def run(self) -> BCResult:
        bc_acc: torch.Tensor | None = None
        ns_by_root: dict[int, float] = dict(self._ns0)
        # every committed round, the resumed ones included: the snapshot's
        # committed set and the sampled estimator's k count them all
        committed: list[int] = self.ledger.state() if self.checkpoint is not None else []
        round_levels: list[int] = []
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
            bc_blk, ns, roots, levels, _ = self._dispatch_block(sources, derived)
            bc_acc = bc_blk if bc_acc is None else bc_acc.add_(bc_blk)
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
                rnd = self.schedule.rounds[rid]
                fwd_cols += int((rnd.sources >= 0).sum())
                bwd_cols += int((rnd.sources >= 0).sum() + (rnd.derived[:, 0] >= 0).sum())
            blocks_done += 1
            blocks_since_snapshot += 1
            if self.checkpoint is not None and blocks_since_snapshot >= self.checkpoint_every:
                snapshot()
                blocks_since_snapshot = 0
            if self.stop_rule is not None and self.stop_rule(
                self._collect_bc(bc_acc), blocks_done
            ):
                stopped_early = True
                logger.info(
                    "stop rule fired after %d dispatch blocks (%d rounds committed); "
                    "halting dispatch", blocks_done, len(committed),
                )
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
            stopped_early=stopped_early,
            stop_stats=getattr(self.stop_rule, "stats", None),
            roots_accumulated=self._count_roots(committed),
            recovery_stats=dict(self.recovery),
        )
