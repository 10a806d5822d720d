"""Synthetic input streams of the port (numpy, no device), the GNN graph
batches and neighbour sampler, and the host prefetcher."""
from .graphs import full_graph_batch, minibatch_batch, molecule_batch, synth_features, to_2d_batch
from .pipeline import Prefetcher
from .recsys import ClickLogStream
from .sampler import NeighborSampler, SampledBlock, block_budget
from .tokens import TokenStream

__all__ = ["ClickLogStream", "TokenStream", "Prefetcher", "NeighborSampler", "SampledBlock",
           "block_budget", "synth_features", "full_graph_batch", "molecule_batch",
           "minibatch_batch", "to_2d_batch"]
