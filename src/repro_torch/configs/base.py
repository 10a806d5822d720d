"""Config dataclasses and shape specs of the architectures the port runs.

A copy of the JAX package's ``configs/base.py`` (``MoESpec``, ``LMArch``,
``LMShape``, ``LM_SHAPES``; ``GNNArch``, ``GNNShape``, ``GNN_SHAPES``;
``DLRMArch``, ``DLRMShape``, ``DLRM_SHAPES``; ``BCArch``, ``BCShape``,
``BC_SHAPES``), field for field and default for default, so that one
(arch × shape) pair names the same workload in both packages.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MoESpec", "LMArch", "LMShape", "LM_SHAPES", "GNNArch", "GNNShape", "GNN_SHAPES",
           "DLRMArch", "DLRMShape", "DLRM_SHAPES", "BCArch", "BCShape", "BC_SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMArch:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # dense-FFN hidden (ignored when moe is set)
    vocab: int
    activation: str = "silu"  # "silu"=SwiGLU, "gelu"=GeGLU
    moe: MoESpec | None = None
    rope_theta: float = 1e4
    optimizer: str = "adamw"  # "adamw" | "adafactor" (memory plan)
    remat: bool = True
    attn_window: int | None = None
    q_chunk: int = 512
    loss_chunk: int = 512  # sequence chunking of the CE loss

    @property
    def family(self) -> str:
        return "lm"


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = (
    LMShape("train_4k", "train", 4096, 256),
    LMShape("prefill_32k", "prefill", 32768, 32),
    LMShape("decode_32k", "decode", 32768, 128),
    LMShape("long_500k", "decode", 524288, 1),
)


@dataclasses.dataclass(frozen=True)
class GNNArch:
    name: str
    kind: str  # "graphcast" | "gat" | "gin" | "meshgraphnet"
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregator: str = "sum"  # "sum" | "attn" | "mean"
    mlp_layers: int = 2
    learnable_eps: bool = False  # GIN-ε
    mesh_refinement: int = 6  # graphcast multimesh level (metadata)
    n_vars: int = 227  # graphcast in/out channels

    @property
    def family(self) -> str:
        return "gnn"


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str  # "full_graph" | "minibatch" | "batched_graphs"
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 47
    batch_nodes: int = 0  # minibatch target count
    fanout: tuple[int, ...] = ()
    n_graphs: int = 0  # batched_graphs


GNN_SHAPES = (
    GNNShape("full_graph_sm", "full_graph", 2_708, 10_556, 1_433, n_classes=7),
    GNNShape(
        "minibatch_lg",
        "minibatch",
        232_965,
        114_615_892,
        602,
        n_classes=41,
        batch_nodes=1_024,
        fanout=(15, 10),
    ),
    GNNShape("ogb_products", "full_graph", 2_449_029, 61_859_140, 100, n_classes=47),
    GNNShape("molecule", "batched_graphs", 30, 64, 64, n_classes=2, n_graphs=128),
)


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
