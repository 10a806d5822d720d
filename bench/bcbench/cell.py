"""What a path module (``bench/paths/<name>.py``) hands the harness, the
schedule every path builds through the program, and the benchmark's
counter of the level steps the program dispatches."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

__all__ = ["Cell", "LevelSteps", "program_schedule"]

#: the operator methods each of which is one level step of the engine's
#: loops (``core/engine.py`` calls one of them a level)
LEVEL_METHODS = ("forward_level", "backward_level", "forward_level_checked",
                 "backward_level_checked")


def program_schedule(cfg: dict, graph):
    """``(build_schedule's four results, plan)`` for the configuration, as
    ``core/bc.py:betweenness_centrality`` plans them: under a
    ``"sampling"`` of the configuration, the program's own fixed sample of
    its eligible roots (``serving/sampling.py:plan_sampling``) first, and
    that ``SamplePlan``, whose rescale the window's answer goes through;
    the plan is None for an exact run."""
    from repro_torch.core.scheduler import build_schedule
    from repro_torch.serving.sampling import eligible_roots, plan_sampling

    plan = None
    sampling = cfg.get("sampling")
    if sampling is not None:
        plan = plan_sampling(eligible_roots(graph), sampling["mode"], sample_k=sampling["k"],
                             seed=sampling["seed"])
    return build_schedule(graph, batch_size=cfg["batch_size"], heuristics=cfg["heuristics"],
                          roots=None if plan is None else plan.roots), plan


class LevelSteps:
    """Counts the calls of the program's level steps on an operator
    instance, or on an operator class whose instances the program builds
    inside its round function.  :meth:`detach` puts the methods back."""

    def __init__(self):
        self.count = 0
        self._undo: list[Callable[[], None]] = []

    def attach(self, target) -> "LevelSteps":
        for name in LEVEL_METHODS:
            orig = getattr(target, name)
            had_own = name in vars(target)
            previous = vars(target).get(name)

            @functools.wraps(orig)
            def counted(*args, _orig=orig, **kwargs):
                self.count += 1
                return _orig(*args, **kwargs)

            setattr(target, name, counted)
            self._undo.append(
                (lambda t=target, n=name, p=previous: setattr(t, n, p)) if had_own
                else (lambda t=target, n=name: delattr(t, n)))
        return self

    def detach(self) -> None:
        while self._undo:
            self._undo.pop()()


@dataclasses.dataclass
class Cell:
    """One configuration built on the device, ready for the round loop.

    ``round_fn(sources i32 [1, s], derived i32 [1, k, 3])`` is the
    program's round function as ``BCDriver`` takes it, one round a
    dispatch; ``schedule`` the program's schedule of every round;
    ``steps`` counts the level steps the operator dispatches; ``info``
    the sizes the path set up (for its tests); ``close`` frees what the
    path set up (a process group, the counter); ``plan`` the program's
    ``SamplePlan`` of a sampled configuration (:func:`program_schedule`),
    None when the run is exact."""

    round_fn: Callable
    schedule: object
    steps: LevelSteps
    info: dict = dataclasses.field(default_factory=dict)
    close: Callable[[], None] = lambda: None
    plan: object = None
