"""The driver layer: one round body and one host round loop.

:func:`traversal_round` is the per-round algebra — forward counting,
2-degree column derivation, dependency accumulation, per-round BC and
component-size (n_s) extraction, plus the round's traversal depth —
written against the :class:`repro_torch.core.operators.TraversalOperator`
protocol.

:class:`BCDriver` is the host round loop: it deals the schedule's rounds
in *dispatch blocks* of ``rounds_per_dispatch`` (1 on a single device;
the sub-cluster count ``fr`` on a grid, one round per replica), skips
rounds a :class:`RoundLedger` has committed, adds each block's
contribution into an f32 accumulator on the device, reads the block's n_s
and roots back to the host (the 1-degree corrections need them), and
fetches the accumulator once at the end as f64, summing the replicas.
Straggler scheduling, chaos, integrity audits, the watchdog and durable
checkpoints belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from ..distributed.fault_tolerance import RoundLedger
from . import engine
from .heuristics.one_degree import OneDegreeReduction, leaf_correction
from .heuristics.two_degree import derive_two_degree_columns
from .operators import TraversalOperator
from .scheduler import Schedule

__all__ = ["BCResult", "BCDriver", "traversal_round", "apply_reduction_corrections"]

logger = logging.getLogger(__name__)


def traversal_round(
    op: TraversalOperator,
    sources: torch.Tensor,  # i32 [s]; -1 = padding
    derived: torch.Tensor,  # i32 [k, 3] rows (c, a_pos, b_pos); -1 = padding
    omega: torch.Tensor,  # f32 [n_rows] 1-degree weights
    *,
    num_levels: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One BC round against the operator protocol.

    Returns
      bc_local  f32 [n_rows] — this round's BC contribution,
      ns        f32 [s+k]    — per-column component size n_s (§3.4.1),
      roots     i32 [s+k]    — root vertex of every column (-1 padding),
      levels    int          — traversal depth of this round on its own
                grid (``reduce_max_grid``; 0 for an all-padding round).
    """
    row_ids = op.row_ids()

    # ---------------------------------------------------------- forward
    src_onehot = (
        (row_ids[:, None] == sources[None, :]) & (sources[None, :] >= 0)
    ).to(torch.float32)
    fwd = engine.forward_counting(op, src_onehot, num_levels=num_levels)

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
    delta = engine.backward_accumulation(
        op, sigma_all, depth_all, omega, max_depth, num_levels=num_levels
    )

    # --------------------------------------------------------- BC + n_s
    roots = torch.cat([sources, derived[:, 0]])
    mult = torch.where(roots >= 0, op.root_omega(roots, omega) + 1.0, 0.0)
    root_onehot = row_ids[:, None] == roots[None, :]
    bc_local = torch.where(root_onehot, 0.0, delta * mult[None, :]).sum(dim=1)

    # per-column component size  n_s = Σ_{d ≥ 0} (1 + ω)   (paper §3.4.1)
    ns = op.reduce_sum(((depth_all >= 0) * (1.0 + omega)[:, None]).sum(dim=0))
    return bc_local, ns, roots, int(grid_max) + 1


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
    rounds_run: int
    forward_columns: int  # explicit BFS columns actually traversed
    backward_columns: int  # dependency columns (explicit + derived)
    wall_s: float = 0.0  # host wall time of the round loop (ends synced)
    round_levels: list[int] = dataclasses.field(default_factory=list)
    #   traversal depth of every round run, in dispatch order
    stopped_early: bool = False  # a stop_rule halted dispatch early
    stop_stats: dict | None = None  # the stop rule's own telemetry
    roots_accumulated: int = 0  # root columns (explicit + derived) of
    #   every committed round — the k in the sampled estimator's N/k
    sampling_stats: dict | None = None  # set when sampling != "off"


class BCDriver:
    """Host round loop (see module docstring).

    ``round_fn(sources i32 [fr, s], derived i32 [fr, k, 3])`` (tensors on
    the run's device, one round per lane, ``fr = rounds_per_dispatch``)
    must return ``(bc_block f32 [fr, ≥n], ns f32 [fr, s+k],
    roots i32 [fr, s+k], levels [fr])`` — per lane what
    :func:`traversal_round` returns.  A short last block and rounds the
    ``ledger`` has committed are dealt as all-padding lanes (sources -1),
    which contribute nothing and report 0 levels; the ledger commits each
    round once its block is accumulated.  ``stop_rule(bc_running f64 [n],
    blocks_done) -> bool`` is consulted after every block; True halts the
    loop with everything run so far kept.  ``checkpoint``,
    ``straggler``, ``integrity`` and ``dispatch_deadline_s`` (the
    watchdog) keep the JAX driver's signature and raise
    ``NotImplementedError`` until their slices are ported.
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
        stop_rule: Callable[[np.ndarray, int], bool] | None = None,
        rounds_per_dispatch: int = 1,
        checkpoint=None,
        straggler: str = "none",
        integrity: str = "off",
        dispatch_deadline_s: float | None = None,
    ):
        for name, value, default in (
            ("checkpoint", checkpoint, None),
            ("straggler", straggler, "none"),
            ("integrity", integrity, "off"),
            ("dispatch_deadline_s", dispatch_deadline_s, None),
        ):
            if value != default:
                raise NotImplementedError(
                    f"BCDriver({name}=...) is not ported yet (ROADMAP Queue 1)"
                )
        self.round_fn = round_fn
        self.schedule = schedule
        self.n = n
        self.device = torch.device(device)
        self.prep = prep
        self.ledger = ledger
        self.stop_rule = stop_rule
        self.fr = max(1, int(rounds_per_dispatch))

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
        """The f32 device accumulator as per-vertex f64 host scores (the
        replica lanes are additive, paper §3.3)."""
        if bc_acc is None:
            return np.zeros(self.n, np.float64)
        return bc_acc.cpu().numpy().astype(np.float64).sum(axis=0)[: self.n]

    def _finalize(self, bc_acc, ns_by_root) -> np.ndarray:
        bc = self._collect_bc(bc_acc)
        if self.prep is not None:
            apply_reduction_corrections(bc, self.prep, self.schedule, ns_by_root)
        return bc

    def run(self) -> BCResult:
        return self._run_static()

    def _run_static(self) -> BCResult:
        bc_acc: torch.Tensor | None = None
        ns_by_root: dict[int, float] = {}
        committed: list[int] = []
        round_levels: list[int] = []
        fwd_cols = bwd_cols = 0
        stopped_early = False
        blocks_done = 0
        t_start = time.perf_counter()
        for sources, derived, live in self._blocks():
            bc_blk, ns, roots, levels = self.round_fn(sources, derived)
            bc_acc = bc_blk if bc_acc is None else bc_acc.add_(bc_blk)
            roots_np = roots.cpu().numpy()
            ns_np = ns.cpu().numpy().astype(np.float64)
            for lane, rid in live:
                for root, nv in zip(roots_np[lane], ns_np[lane]):
                    if root >= 0:
                        ns_by_root[int(root)] = float(nv)
                if self.ledger is not None:
                    self.ledger.try_commit(rid)
                committed.append(rid)
                round_levels.append(int(levels[lane]))
                rnd = self.schedule.rounds[rid]
                fwd_cols += int((rnd.sources >= 0).sum())
                bwd_cols += int((rnd.sources >= 0).sum() + (rnd.derived[:, 0] >= 0).sum())
            blocks_done += 1
            if self.stop_rule is not None and self.stop_rule(
                self._collect_bc(bc_acc), blocks_done
            ):
                stopped_early = True
                logger.info(
                    "stop rule fired after %d dispatch blocks (%d rounds committed); "
                    "halting dispatch", blocks_done, len(committed),
                )
                break
        bc = self._finalize(bc_acc, ns_by_root)  # the fetch synchronises
        return BCResult(
            bc=bc,
            schedule=self.schedule,
            rounds_run=len(committed),
            forward_columns=fwd_cols,
            backward_columns=bwd_cols,
            wall_s=time.perf_counter() - t_start,
            round_levels=round_levels,
            stopped_early=stopped_early,
            stop_stats=getattr(self.stop_rule, "stats", None),
            roots_accumulated=self._count_roots(committed),
        )
