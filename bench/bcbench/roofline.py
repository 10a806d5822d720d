"""The yardstick's peaks and the work a BC level step needs.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3) at its full
700 W: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32 outside the
tensor cores (the level steps are f32-exact and use none).

The work of one level step is what its inputs need, whatever implements
it: the residual graph's arcs read once as int32 pairs, one f32 state of
the step's columns read once and written once, and one multiply-add per
arc and column.  A round of depth D (``levels`` = D + 1) needs D forward
levels over its explicit columns and D − 1 backward levels over all of
them; the levels a static bound adds beyond that need nothing.
"""
from __future__ import annotations

__all__ = ["PEAKS", "level_seconds", "round_bound_seconds"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}


def _peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for device {kind!r}; add it to PEAKS")
    return PEAKS[kind]


def level_seconds(arcs: int, n: int, columns: int, kind: str) -> float:
    """The least time of one level step over ``columns`` columns."""
    peaks = _peaks(kind)
    nbytes = 8 * arcs + 2 * 4 * n * columns
    flop = 2 * arcs * columns
    return max(nbytes / peaks["bytes_per_s"], flop / peaks["f32_flop_per_s"])


def round_bound_seconds(levels: int, explicit: int, columns: int, arcs: int, n: int,
                        kind: str) -> float:
    """The least time of a round of ``levels`` (depth + 1) with ``explicit``
    forward and ``columns`` backward columns."""
    depth = max(0, levels - 1)
    return (depth * level_seconds(arcs, n, explicit, kind)
            + max(0, depth - 1) * level_seconds(arcs, n, columns, kind))

