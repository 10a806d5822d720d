"""Rank-side case runner for tests/test_torch_straggler_grid.py: the
multi-ledger straggler loop and the grid's recovery knobs on a spawned
2×2×2 gloo grid.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require.  Each case reports what the rank's driver ended with: the BC,
the straggler and recovery telemetry, its per-lane ledgers and the knobs
the grid entry built it with.
"""
from __future__ import annotations

import time

from repro_torch.core import distributed as pdist
from repro_torch.core.distributed import distributed_betweenness_centrality

#: the knobs read back from the rank's driver
KNOBS = ("straggler", "straggler_factor", "prior_round_s", "max_retries", "retry_backoff_s",
         "numeric_guard", "dispatch_deadline_s", "mesh_shape", "mesh_axes", "fr")


class SkewedClock:
    """A clock that runs ``speed`` times as fast as the host's, and jumps
    ``jump`` seconds ahead from its ``at``-th reading on: every rank of a
    grid reads a different time."""

    def __init__(self, speed: float, jump: float = 0.0, at: int | None = None):
        self.speed, self.jump, self.at, self.calls = speed, jump, at, 0

    def __call__(self) -> float:
        t = time.monotonic() * self.speed
        if self.at is not None and self.calls >= self.at:
            t += self.jump
        self.calls += 1
        return t


def _clock(groups, spec):
    """``("speed",)``: rank r's clock runs 1 + 3r times as fast;
    ``("jump", rank, at)``: that rank's clock jumps 100 s at reading
    ``at``, the others run true."""
    if spec is None:
        return None
    if spec[0] == "speed":
        return SkewedClock(1.0 + 3.0 * groups.rank)
    _, rank, at = spec
    return SkewedClock(1.0, 100.0 if groups.rank == rank else 0.0, at)


def _bc(groups, graph, kwargs, clock_spec=None):
    drivers, plain = [], pdist.BCDriver

    class Recorded(plain):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            drivers.append(self)

    pdist.BCDriver = Recorded
    try:
        res = distributed_betweenness_centrality(graph, groups, device="cpu", full_result=True,
                                                 clock=_clock(groups, clock_spec), **kwargs)
    finally:
        pdist.BCDriver = plain
    drv = drivers[0]
    return {"bc": res.bc, "rounds_run": res.rounds_run, "round_levels": res.round_levels,
            "stats": res.straggler_stats, "recovery": res.recovery_stats,
            "blocks": len(res.block_times or ()), "overlap": res.layout_stats["overlap"],
            "ledgers": None if drv.ledgers is None else [led.state() for led in drv.ledgers],
            "knobs": {k: getattr(drv, k) for k in KNOBS}}


def run_cases(groups, cases):
    """``cases``: list of ``(name, graph, kwargs, clock_spec)``; returns
    ``{name: result}`` on every rank."""
    return {name: _bc(groups, graph, kw, spec) for name, graph, kw, spec in cases}
