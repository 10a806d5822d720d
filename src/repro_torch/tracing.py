"""Spans and counters inside the BC round loop, for a profiler's trace.

Tracing is on exactly while a ``torch.profiler`` records; there is no
other switch.  Every hook checks :func:`on` first and, when it is off,
does nothing else: it enters no ``record_function``, allocates nothing,
launches no kernel and reads nothing back.  When it is on, each span is a
``torch.profiler.record_function``, so it sits in the same trace as the
device's activities, on their clock, and every idle gap of the device
falls inside the spans the host had open.

Spans:

* ``bc.block``: one dispatch block of ``BCDriver``'s static loop, from
  the dispatch to the block's accumulation and commit;
* ``bc.round``: one ``traversal_round``;
* ``bc.level.forward`` / ``bc.level.backward``: one level step of the
  engine's loops (the operator call and the liveness readback);
* ``bc.readback``: a device-to-host read of the round loop;
* ``bc.collective.<kind>``: ``all_gather``, ``reduce_scatter``,
  ``all_reduce`` and ``ring_hop`` of ``distributed/groups.py``;
* ``bc.schedule.one_degree`` / ``.two_degree`` / ``.pack``: the phases of
  ``build_schedule``, and ``bc.sample.plan``: ``plan_sampling``'s draw of
  a fixed sample of roots.  These keep their host seconds whether tracing
  is on or not (:func:`seconds`): set-up runs before a profiler starts.

Counters, recorded only while on (:func:`counts`): ``level_steps``,
``empty_level_steps`` (steps in which no column can change),
``live_columns`` (column-steps that can change their column: forward step
ℓ for a column with a vertex at depth ℓ, backward step ℓ for one with a
vertex at depth ℓ + 1), ``operand_columns`` (the columns the steps
ran, live or not) and ``padded_columns`` (those of them whose column has
no root: an unfilled source slot in the forward loop, an unfilled source
or derived slot in the backward loop), and ``trimmed_slots``, the derived
slots ``BCDriver`` left out of its dispatch blocks (those past a block's
last claimed slot, in every lane).  The column counts keep the schedule's
width: a backward step counts the slots its block left out (:func:`trimming`)
as padded operand columns, though it does not run them, so the trim shows
in ``trimmed_slots`` and leaves ``padding_column_pct`` and
``live_column_pct`` as the schedule has them.  They start from zero at the
first record under a profiler session after :func:`on` last saw no
profiler running.

Run BC under ``torch.profiler.profile`` and call :func:`counts` and
:func:`seconds` afterwards; ``bench/metrics/`` reads them.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["on", "span", "phase", "count_levels", "count_trimmed", "trimming", "counts",
           "seconds"]

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()

#: whether the last :func:`on` saw no profiler running: the next record
#: under a profiler then starts the counters from zero
_saw_off = True
_steps = {"level_steps": 0, "empty_level_steps": 0, "operand_columns": 0, "trimmed_slots": 0}
#: the live and the padded columns: i64 0-d on the round's device once counted
_live: torch.Tensor | int = 0
_padded: torch.Tensor | int = 0
#: the derived slots of each lane that the running dispatch block left out
_trimmed_lane = 0
_seconds: dict[str, float] = {}


def on() -> bool:
    """Whether a profiler records now (the one check every hook makes)."""
    global _saw_off, _live, _padded
    if _profiler_enabled():
        if _saw_off:
            _saw_off = False
            _steps.update(dict.fromkeys(_steps, 0))
            _live = _padded = 0
        return True
    _saw_off = True
    return False


def span(name: str):
    """``record_function(name)`` while on, else a shared null context."""
    return torch.profiler.record_function(name) if on() else _OFF


@contextlib.contextmanager
def phase(name: str):
    """A set-up span whose host seconds :func:`seconds` keeps, on or off."""
    t = time.perf_counter()
    with span(name):
        yield
    _seconds[name] = time.perf_counter() - t


def count_levels(steps: int, live_steps: int, depth: torch.Tensor, shift: int,
                 roots: torch.Tensor | None = None) -> None:
    """Count one loop's ``steps`` level steps over the columns of
    ``depth`` (i32 [rows, columns]), of which ``live_steps`` (from the
    host ints the loop holds) can change a column.  A column whose deepest
    vertex is at D is live in min(D − shift, steps) of them (none if
    negative): ``shift`` 0 for the forward loop, 1 for the backward.
    ``roots`` (i32 [columns]) holds each column's root, −1 where it has
    none: such a column is padded in every step (None: no column is).  The
    backward loop (the one over the derived columns) also counts the
    derived slots its dispatch block left out (:func:`trimming`) as padded
    operand columns.  Only while :func:`on`; the live and padded columns
    are summed on the device."""
    global _live, _padded
    left_out = _trimmed_lane if shift else 0
    _steps["level_steps"] += steps
    _steps["empty_level_steps"] += steps - min(max(live_steps, 0), steps)
    _steps["operand_columns"] += steps * (depth.shape[1] + left_out)
    if steps and depth.numel():
        _live = _live + (depth.amax(dim=0) - shift).clamp(0, steps).sum()
    if steps and roots is not None:
        _padded = _padded + ((roots < 0).sum() + left_out) * steps


def count_trimmed(slots: int) -> None:
    """Count ``slots`` derived slots a dispatch block did not ship.  Only
    while :func:`on`."""
    _steps["trimmed_slots"] += slots


@contextlib.contextmanager
def trimming(slots: int):
    """While a dispatch block runs that left ``slots`` derived slots out of
    each lane: :func:`count_levels` counts them in its backward steps."""
    global _trimmed_lane
    _trimmed_lane = slots
    try:
        yield
    finally:
        _trimmed_lane = 0


def counts() -> dict[str, int]:
    """The counters of the latest profiler session ({} if none recorded),
    with a synchronisation each for the live and padded columns."""
    on()
    if not _steps["level_steps"]:
        return {}
    return dict(_steps, live_columns=int(_live), padded_columns=int(_padded))


def seconds() -> dict[str, float]:
    """Host seconds of the latest call of each :func:`phase`, by name."""
    return dict(_seconds)
