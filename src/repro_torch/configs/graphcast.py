"""GraphCast-class mesh GNN (arXiv:2212.12794; unverified tier).

Encoder-processor-decoder on the icosahedral multimesh: 16 processor
layers, d_hidden=512, sum aggregation, 227 surface/atmo variables.
mesh_refinement=6 is metadata for the dataset generator.
"""
from .base import GNN_SHAPES, GNNArch
from .registry import register

ARCH = GNNArch(
    name="graphcast",
    kind="graphcast",
    n_layers=16,
    d_hidden=512,
    aggregator="sum",
    mesh_refinement=6,
    n_vars=227,
)

register(ARCH, GNN_SHAPES)
