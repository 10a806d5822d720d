"""Rank-side case runner for tests/test_torch_chaos.py: the chaos harness on
spawned gloo grids.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require.  A case that ends in an exception (a simulated crash, a replica
loss on a grid without replicas) reports its type and message, and the
rank goes on with the next case: its process group must still work.
"""
from __future__ import annotations

from repro_torch.core.distributed import distributed_betweenness_centrality
from repro_torch.distributed.chaos import ChaosCrash


class FakeClock:
    """Time advances only when something sleeps through it (the stall, the
    retry backoff): only an injected stall can pass a deadline."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def _bc(groups, graph, kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("fake_clock", False):
        clock = FakeClock()
        kwargs.update(clock=clock, sleeper=clock.sleep)
    try:
        res = distributed_betweenness_centrality(graph, groups, device="cpu", full_result=True,
                                                 **kwargs)
    except (ChaosCrash, RuntimeError) as e:  # ChaosCrash is a BaseException
        return {"error": type(e).__name__, "message": str(e)}
    lay = res.layout_stats
    return {"bc": res.bc, "recovery": res.recovery_stats, "rounds_run": res.rounds_run,
            "num_rounds": len(res.schedule.rounds), "report": lay.get("autotune")}


def run_cases(groups, cases):
    """``cases``: list of ``(name, graph, kwargs)``; ``kwargs`` go to
    :func:`distributed_betweenness_centrality` (``fake_clock=True`` gives
    the rank its own :class:`FakeClock` as clock and sleeper).  Returns
    ``{name: result}`` on every rank."""
    return {name: _bc(groups, graph, kw) for name, graph, kw in cases}
