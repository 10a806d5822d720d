"""The reduction of a profiler trace of the window to device intervals.

Busy time is the *union* of the device's activity intervals (kernels,
copies, fills) inside the window, not their sum: an NCCL kernel that
overlaps a compute kernel on another stream is counted once.  Idle gaps
are the holes in that union; each is named by the innermost host event
(an ``aten`` op, a runtime call or one of the benchmark's own spans)
that was running at its middle, or else by the one that ended last
before it.

A collective's device work is what the host ops ``nccl:*`` launched: on
a one-member group NCCL copies instead of running a kernel of its own,
so the device activities are matched to those ops, or any op inside
them, besides any kernel named ``nccl``.  The match is the profiler's
own: a device activity's linked correlation id is the id of the
framework op (an ``aten`` op, a ``record_function`` span, an ``nccl:*``
op) that launched it.  The CUDA runtime calls carry ids of another
counter, which can equal an unrelated op's, so they take no part.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

__all__ = ["Trace", "union_seconds", "idle_gaps", "from_profiler", "WINDOW_SPAN"]

#: the benchmark's span around the window; it marks the window's ends
WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Trace:
    """Intervals in seconds from the window's start."""

    window_s: float
    device: list[tuple[str, float, float]]  # (kernel / copy name, start, end)
    host: list[tuple[str, float, float]]  # (host op or span name, start, end)
    collective: list[tuple[str, float, float]] = dataclasses.field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device], 0.0, self.window_s)

    def top_ops(self, count: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            total[name] += max(0.0, min(e, self.window_s) - max(s, 0.0))
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:count]]

    def top_gaps(self, count: int = 10) -> list[list]:
        gaps = idle_gaps([(s, e) for _, s, e in self.device], 0.0, self.window_s)
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((s + e) / 2), e - s] for s, e in gaps[:count]]

    @property
    def collective_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.collective], 0.0, self.window_s)

    def host_at(self, t: float) -> str:
        """The innermost host event running at ``t``, else "after" the one
        that ended last before it ("host" if none)."""
        best, best_len = None, float("inf")
        last, last_end = "host", float("-inf")
        for name, s, e in self.host:
            if name == WINDOW_SPAN:
                continue
            if s <= t <= e and e - s < best_len:
                best, best_len = name, e - s
            elif last_end < e < t:
                last, last_end = f"after {name}", e
        return best if best is not None else last


def _merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in _merged(intervals, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def from_profiler(prof) -> Trace:
    """The window's intervals from a finished ``torch.profiler.profile``
    whose trace holds one :data:`WINDOW_SPAN` host span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() == DeviceType.CPU]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} window spans, expected 1")
    t0 = spans[0].start_ns()
    t1 = t0 + spans[0].duration_ns()
    device, host, dev_links, host_ids = [], [], [], []
    for e in events:
        s = (e.start_ns() - t0) * 1e-9
        rec = (e.name(), s, s + e.duration_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            # a user annotation on the device timeline (nccl:all_gather)
            # repeats the time of the kernels it encloses
            if not e.is_user_annotation():
                device.append(rec)
                dev_links.append(e.linked_correlation_id())
        elif e.device_type() == DeviceType.CPU:
            host.append(rec)
            # a runtime call links to its framework op; only the latter's
            # id is what device activities link to
            host_ids.append(e.correlation_id() if e.linked_correlation_id() == 0 else 0)
    return Trace(window_s=(t1 - t0) * 1e-9, device=device, host=host,
                 collective=_collective(device, dev_links, host, host_ids))


def _collective(device, dev_links, host, host_ids) -> list[tuple[str, float, float]]:
    """The device activities of collectives (see the module docstring)."""
    spans = sorted((s, e) for name, s, e in host if name.startswith("nccl:"))
    starts = [a for a, _ in spans]
    inside = set()
    for (name, s, e), cid in zip(host, host_ids):
        i = bisect.bisect_right(starts, s) - 1
        if cid and i >= 0 and e <= spans[i][1]:
            inside.add(cid)
    return [rec for rec, link in zip(device, dev_links)
            if (link and link in inside) or "nccl" in rec[0].lower()]
