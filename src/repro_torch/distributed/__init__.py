"""Round accounting, the round snapshot and the process groups of the 2-D
decomposed grid."""
from .fault_tolerance import BCCheckpoint, RoundLedger, schedule_fingerprint
from .groups import GridGroups, device_for_rank, run_gloo

__all__ = [
    "RoundLedger", "BCCheckpoint", "schedule_fingerprint", "GridGroups", "device_for_rank",
    "run_gloo",
]
