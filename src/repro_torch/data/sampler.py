"""Layer-wise fanout neighbor sampler (GraphSAGE-style), host side.

``minibatch_lg`` needs a *real* sampler: given target vertices, sample
``fanout[0]`` neighbors of each, then ``fanout[1]`` of those, etc., and
emit a fixed-shape block (padded with sentinel nodes/edges) matching the
tensor shapes the GNN train step takes.

Duplicates are kept (standard with-replacement sampling) so the shapes
are static: block node count = T·(1 + f0 + f0·f1 + ...) exactly.

The JAX package's ``data/sampler.py``: the same seed draws the same
blocks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graphs.graph import Graph

__all__ = ["SampledBlock", "NeighborSampler", "block_budget"]


def block_budget(batch_nodes: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """(n_nodes, n_edges) of the fixed-shape sampled block."""
    nodes = batch_nodes
    edges = 0
    frontier = batch_nodes
    for f in fanout:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    return nodes, edges


@dataclasses.dataclass
class SampledBlock:
    node_ids: np.ndarray  # i32 [n_nodes] global ids (may repeat)
    node_feat_rows: np.ndarray  # = node_ids (feature gather happens outside)
    edge_src: np.ndarray  # i32 [n_edges] local indices into node_ids
    edge_dst: np.ndarray  # i32 [n_edges]
    target_idx: np.ndarray  # i32 [batch] local indices of the targets


class NeighborSampler:
    def __init__(self, graph: Graph, fanout: tuple[int, ...], seed: int = 0):
        self.fanout = tuple(fanout)
        self.rng = np.random.default_rng(seed)
        self.row_ptr, self.col = graph.csr()
        self.n = graph.n
        self.deg = (self.row_ptr[1:] - self.row_ptr[:-1]).astype(np.int64)

    def _sample_neighbors(self, vertices: np.ndarray, k: int) -> np.ndarray:
        """[V] -> [V, k] sampled neighbor ids (self-loop for isolated)."""
        deg = self.deg[vertices]
        r = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(vertices), k))
        idx = self.row_ptr[vertices][:, None] + r
        out = self.col[np.minimum(idx, len(self.col) - 1)]
        # isolated vertices self-loop (keeps shapes static, adds no info)
        out = np.where(deg[:, None] > 0, out, vertices[:, None])
        return out.astype(np.int32)

    def sample(self, targets: np.ndarray) -> SampledBlock:
        targets = np.asarray(targets, np.int32)
        nodes = [targets]
        srcs, dsts = [], []
        frontier = targets
        offset = 0
        for f in self.fanout:
            nbrs = self._sample_neighbors(frontier, f)  # [V, f]
            new_offset = offset + len(frontier)
            dst_local = np.repeat(np.arange(offset, new_offset, dtype=np.int32), f)
            src_local = np.arange(
                new_offset, new_offset + nbrs.size, dtype=np.int32
            )
            nodes.append(nbrs.reshape(-1))
            # message flows neighbor -> center
            srcs.append(src_local)
            dsts.append(dst_local)
            frontier = nbrs.reshape(-1)
            offset = new_offset
        node_ids = np.concatenate(nodes)
        return SampledBlock(
            node_ids=node_ids,
            node_feat_rows=node_ids,
            edge_src=np.concatenate(srcs),
            edge_dst=np.concatenate(dsts),
            target_idx=np.arange(len(targets), dtype=np.int32),
        )
