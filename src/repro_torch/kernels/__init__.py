"""Hand-written Hopper kernels of the port and their plain versions.

  ops.py              checked public wrappers + launch counters
  ref.py              plain PyTorch versions (the semantics)
  frontier_spmm.py    K1 launcher (csrc/frontier_spmm.cu), K3 (csrc/partial_spmm.cu)
  dependency_spmm.py  K2 launcher (csrc/dependency_spmm.cu), K4 (csrc/partial_spmm.cu)
  _build.py           nvcc build at first use + ctypes loading

Importing this package builds nothing and needs no card.
"""
from .ops import (
    LAUNCHES,
    dependency_spmm,
    dependency_spmm_partial,
    frontier_spmm,
    frontier_spmm_partial,
    reset_launches,
)

__all__ = [
    "frontier_spmm",
    "dependency_spmm",
    "frontier_spmm_partial",
    "dependency_spmm_partial",
    "LAUNCHES",
    "reset_launches",
]
