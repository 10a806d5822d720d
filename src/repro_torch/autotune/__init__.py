"""Measured-cost autotuning: a persistent cost cache and a planner of
micro-benchmarks.

It puts measurements in place of the roofline's guesses at the four
choice seams of the 2-D path (the hybrid per-cell kernel choice,
``overlap="auto"``, the straggler EWMA prior and the BCSR tile pick):
:mod:`repro_torch.autotune.cache` holds the key schema and the file,
:mod:`repro_torch.autotune.measure` the measure-once planner.
"""
from .cache import (
    AUTOTUNE_MODES,
    CostCache,
    CostRecord,
    as_cache,
    config_key,
    graph_key,
    graph_key_for,
    normalize_autotune,
)
from .measure import (
    MEASURE_LEVELS,
    Candidate,
    TunePlan,
    default_bench,
    measure_walls,
    plan_autotune,
    sample_batch,
)

__all__ = [
    "AUTOTUNE_MODES",
    "Candidate",
    "CostCache",
    "CostRecord",
    "MEASURE_LEVELS",
    "TunePlan",
    "as_cache",
    "config_key",
    "default_bench",
    "graph_key",
    "graph_key_for",
    "measure_walls",
    "normalize_autotune",
    "plan_autotune",
    "sample_batch",
]
