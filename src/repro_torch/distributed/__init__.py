"""Round accounting, the round snapshot, elasticity planning and the
process groups of the 2-D decomposed grid."""
from .fault_tolerance import (
    BCCheckpoint,
    MeshPlan,
    RoundLedger,
    StragglerPolicy,
    plan_elastic_remesh,
    schedule_fingerprint,
)
from .groups import GridGroups, device_for_rank, run_gloo

__all__ = [
    "RoundLedger", "BCCheckpoint", "schedule_fingerprint", "MeshPlan", "plan_elastic_remesh",
    "StragglerPolicy", "GridGroups", "device_for_rank", "run_gloo",
]
