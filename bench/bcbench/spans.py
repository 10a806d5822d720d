"""What the program's own tracing (``repro_torch/tracing.py``) recorded in
a run: its counters and set-up seconds, and the traced window's idle gaps
split by the program span the host had open as each gap began.  A program
without that module, or a trace without its spans, gives nothing to read."""
from __future__ import annotations

from .trace import Trace, idle_gaps

__all__ = ["SYNC", "COLLECTIVE", "HOST", "gap_seconds", "gap_ms_per_round", "program_counts",
           "program_seconds"]

#: the kinds of program span a gap can open in: a device-to-host read, a
#: collective, any other ``bc.*`` span (the host's own work)
SYNC, COLLECTIVE, HOST = "sync", "collective", "host"


def _kind(name: str) -> str:
    if name == "bc.readback":
        return SYNC
    return COLLECTIVE if name.startswith("bc.collective.") else HOST


def gap_seconds(trace: Trace) -> dict[str, float] | None:
    """Idle seconds of the window by the kind of the innermost ``bc.*``
    span open at each gap's start (a gap outside every such span counts
    in none); None without device activity or program spans."""
    spans = sorted(((s, e, name) for name, s, e in trace.host if name.startswith("bc.")),
                   key=lambda x: (x[0], -x[1]))
    if not spans or not trace.device or trace.window_s <= 0:
        return None
    out = {SYNC: 0.0, COLLECTIVE: 0.0, HOST: 0.0}
    # the spans open at a time, outermost first: they nest on the host
    # thread, so the last one still open is the innermost
    stack: list[tuple[float, float, str]] = []
    i = 0
    for start, end in idle_gaps([(s, e) for _, s, e in trace.device], 0.0, trace.window_s):
        while i < len(spans) and spans[i][0] <= start:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < start:
            stack.pop()
        if stack:
            out[_kind(stack[-1][2])] += end - start
    return out


def gap_ms_per_round(ctx, kind: str) -> float | None:
    """Idle milliseconds of the traced window a completed round, over the
    gaps that open inside a program span of ``kind``."""
    if ctx.trace is None or not ctx.rounds:
        return None
    gaps = gap_seconds(ctx.trace)
    return None if gaps is None else 1e3 * gaps[kind] / len(ctx.rounds)


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:  # a program from before its tracing module
        return None
    return tracing


def program_counts() -> dict[str, int]:
    """``tracing.counts()`` of the program's latest profiled window."""
    tracing = _tracing()
    return {} if tracing is None else tracing.counts()


def program_seconds() -> dict[str, float]:
    """``tracing.seconds()``: the latest host seconds of each set-up phase."""
    tracing = _tracing()
    return {} if tracing is None else tracing.seconds()
