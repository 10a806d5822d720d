"""Round accounting (the 2-D distributed engine is not ported yet)."""
from .fault_tolerance import RoundLedger

__all__ = ["RoundLedger"]
