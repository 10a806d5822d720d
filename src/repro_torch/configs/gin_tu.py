"""GIN (arXiv:1810.00826; paper tier): 5 layers, d_hidden=64, sum
aggregator, learnable epsilon — the TU-datasets configuration."""
from .base import GNN_SHAPES, GNNArch
from .registry import register

ARCH = GNNArch(
    name="gin-tu",
    kind="gin",
    n_layers=5,
    d_hidden=64,
    aggregator="sum",
    learnable_eps=True,
)

register(ARCH, GNN_SHAPES)
