"""MeshGraphNet (arXiv:2010.03409; unverified tier): 15 message-passing
layers, d_hidden=128, sum aggregator, 2-layer MLPs, residual edge+node
updates."""
from .base import GNN_SHAPES, GNNArch
from .registry import register

ARCH = GNNArch(
    name="meshgraphnet",
    kind="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    aggregator="sum",
    mlp_layers=2,
)

register(ARCH, GNN_SHAPES)
