"""GAT (arXiv:1710.10903; paper tier): 2 layers, 8 hidden x 8 heads,
attention aggregation — the Cora configuration."""
from .base import GNN_SHAPES, GNNArch
from .registry import register

ARCH = GNNArch(
    name="gat-cora",
    kind="gat",
    n_layers=2,
    d_hidden=8,
    n_heads=8,
    aggregator="attn",
)

register(ARCH, GNN_SHAPES)
