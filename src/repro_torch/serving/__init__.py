"""Approximate-BC serving: source sampling, adaptive stopping and the
versioned snapshot store behind ``launch/serve_bc.py``.

``sampling`` owns the estimator plan (seeded nested root subsets, the
N/k rescale contract, rank-stability metrics and the ``BCDriver``
``stop_rule`` implementations); ``store`` owns the atomic
generation-swapped :class:`BCSnapshotStore` that serves top-k and
per-vertex queries while a background refresher refines the estimate.
numpy and threading only.
"""
from .sampling import (
    RANK_METHODS,
    SAMPLING_MODES,
    AdaptiveStopRule,
    BlockBudgetStop,
    SamplePlan,
    eligible_roots,
    normalize_sampling,
    plan_sampling,
    rank_stability,
    resolve_sample_size,
    top_k_indices,
)
from .store import BCSnapshot, BCSnapshotStore

__all__ = [
    "RANK_METHODS",
    "SAMPLING_MODES",
    "AdaptiveStopRule",
    "BlockBudgetStop",
    "SamplePlan",
    "eligible_roots",
    "normalize_sampling",
    "plan_sampling",
    "rank_stability",
    "resolve_sample_size",
    "top_k_indices",
    "BCSnapshot",
    "BCSnapshotStore",
]
