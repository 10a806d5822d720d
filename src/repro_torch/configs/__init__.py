"""Architecture configs of the port; importing this package populates the
registry (only ``dlrm-rm2`` so far)."""
from . import dlrm_rm2  # noqa: F401
from .base import DLRM_SHAPES, DLRMArch, DLRMShape
from .registry import ArchBundle, get_arch, list_archs

__all__ = ["ArchBundle", "get_arch", "list_archs", "DLRMArch", "DLRMShape", "DLRM_SHAPES"]
