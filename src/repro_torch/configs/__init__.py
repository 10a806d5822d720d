"""Architecture configs of the port; importing this package populates the
registry (``bc-rmat`` and ``dlrm-rm2`` so far)."""
from . import bc_rmat, dlrm_rm2  # noqa: F401
from .base import BC_SHAPES, DLRM_SHAPES, BCArch, BCShape, DLRMArch, DLRMShape
from .registry import ArchBundle, get_arch, list_archs

__all__ = ["ArchBundle", "get_arch", "list_archs", "DLRMArch", "DLRMShape", "DLRM_SHAPES",
           "BCArch", "BCShape", "BC_SHAPES"]
