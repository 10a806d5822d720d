"""Config dataclasses and shape specs of the architectures the port runs.

A copy of the DLRM and BC parts of the JAX package's ``configs/base.py``
(``DLRMArch``, ``DLRMShape``, ``DLRM_SHAPES``; ``BCArch``, ``BCShape``,
``BC_SHAPES``), field for field, so that one (arch × shape) pair names
the same workload in both packages.  The other families (LM, GNN) are
not ported yet.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DLRMArch", "DLRMShape", "DLRM_SHAPES", "BCArch", "BCShape", "BC_SHAPES"]


@dataclasses.dataclass(frozen=True)
class DLRMArch:
    name: str
    n_dense: int
    n_sparse: int
    embed_dim: int
    bot_mlp: tuple[int, ...]
    top_mlp: tuple[int, ...]
    interaction: str = "dot"
    rows_per_table: int = 10_000_000
    hot_size: int = 1  # multi-hot pooling factor (EmbeddingBag L)

    @property
    def family(self) -> str:
        return "recsys"


@dataclasses.dataclass(frozen=True)
class DLRMShape:
    name: str
    kind: str  # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


DLRM_SHAPES = (
    DLRMShape("train_batch", "train", 65_536),
    DLRMShape("serve_p99", "serve", 512),
    DLRMShape("serve_bulk", "serve", 262_144),
    DLRMShape("retrieval_cand", "retrieval", 1, n_candidates=1_000_000),
)


@dataclasses.dataclass(frozen=True)
class BCArch:
    """The paper's own workload: MGBC on an R-MAT graph."""

    name: str
    scale: int
    edge_factor: int
    batch_size: int = 16  # concurrent sources per round
    heuristics: str = "h3"
    max_levels: int = 24  # static level bound of the cell's round

    @property
    def family(self) -> str:
        return "bc"


@dataclasses.dataclass(frozen=True)
class BCShape:
    name: str
    scale: int
    edge_factor: int


BC_SHAPES = (
    BCShape("rmat_s23_ef16", 23, 16),
    BCShape("rmat_s25_ef16", 25, 16),
)
