"""Round accounting and the process groups of the 2-D decomposed grid."""
from .fault_tolerance import RoundLedger
from .groups import GridGroups, device_for_rank, run_gloo

__all__ = ["RoundLedger", "GridGroups", "device_for_rank", "run_gloo"]
