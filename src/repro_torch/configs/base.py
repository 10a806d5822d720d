"""Config dataclasses and shape specs of the architectures the port runs.

A copy of the DLRM part of the JAX package's ``configs/base.py``
(``DLRMArch``, ``DLRMShape``, ``DLRM_SHAPES``), field for field, so that
one (arch × shape) pair names the same workload in both packages.  The
other families (LM, GNN) are not ported yet.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DLRMArch", "DLRMShape", "DLRM_SHAPES"]


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
