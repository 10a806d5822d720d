"""Hand-written Hopper kernels of the port and their plain versions.

  ops.py              checked public wrappers + launch counters
  ref.py              plain PyTorch versions (the semantics)
  frontier_spmm.py    K1 launcher (csrc/frontier_spmm.cu), K3 (csrc/partial_spmm.cu)
  dependency_spmm.py  K2 launcher (csrc/dependency_spmm.cu), K4 (csrc/partial_spmm.cu)
  level_gemm.py       K1–K4's launch layout: column tile, operand scratch, copy path
  blocked_spmm.py     K5/K6 launchers (csrc/sparse_spmm.cu) and the tiles'
                      nonzero index the kernels read
  segment_bag.py      K7 launcher (csrc/segment_bag.cu), the DLRM EmbeddingBag
  arc_product.py      the arc product's launcher (csrc/arc_product.cu) and the
                      work list it reads
  _build.py           nvcc build at first use + ctypes loading

Importing this package builds nothing and needs no card.
"""
from .ops import (
    LAUNCHES,
    arc_product,
    checksum_append,
    checksum_residual,
    dependency_spmm,
    dependency_spmm_partial,
    dependency_spmm_sparse,
    frontier_spmm,
    frontier_spmm_partial,
    frontier_spmm_sparse,
    reset_launches,
    segment_bag,
)

__all__ = [
    "frontier_spmm",
    "dependency_spmm",
    "frontier_spmm_partial",
    "dependency_spmm_partial",
    "frontier_spmm_sparse",
    "dependency_spmm_sparse",
    "segment_bag",
    "arc_product",
    "checksum_append",
    "checksum_residual",
    "LAUNCHES",
    "reset_launches",
]
