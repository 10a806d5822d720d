"""Byte model of the 2-D engines: what each engine stores and streams per
device, the per-cell dense/BCSR choice and the memory guard's footprint;
the level-time model of ``overlap="auto"`` over a :class:`HardwareSpec`
(H100 data-sheet rates).  The card's capacity reaches the guard as an
input.  :func:`sampled_run_seconds` prices a sampled run from a measured
block wall.  :class:`WorkCounter` counts a run's FLOP, bytes and
collectives, which :func:`roofline_terms` prices."""
from .counter import WorkCounter
from .model import (
    H100,
    TILE_OVERHEAD_BYTES,
    HardwareSpec,
    RooflineTerms,
    auto_overlap_policy,
    overlap_step_time,
    adjacency_stream_bytes,
    cell_kernel_choice,
    device_hbm_footprint,
    exchange_operands,
    link_bytes,
    ring_latency_s,
    ring_steps,
    roofline_terms,
    sampled_run_seconds,
    sparse_tile_bytes,
)

__all__ = [
    "HardwareSpec",
    "H100",
    "RooflineTerms",
    "roofline_terms",
    "link_bytes",
    "ring_steps",
    "ring_latency_s",
    "WorkCounter",
    "overlap_step_time",
    "auto_overlap_policy",
    "TILE_OVERHEAD_BYTES",
    "sparse_tile_bytes",
    "cell_kernel_choice",
    "exchange_operands",
    "adjacency_stream_bytes",
    "device_hbm_footprint",
    "sampled_run_seconds",
]
