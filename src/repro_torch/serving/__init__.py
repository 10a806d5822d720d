"""Source sampling (the plan side; the serving front end is not ported yet)."""
from .sampling import (
    SAMPLING_MODES,
    SamplePlan,
    eligible_roots,
    normalize_sampling,
    plan_sampling,
    resolve_sample_size,
)

__all__ = [
    "SAMPLING_MODES",
    "SamplePlan",
    "eligible_roots",
    "normalize_sampling",
    "plan_sampling",
    "resolve_sample_size",
]
