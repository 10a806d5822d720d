"""Graph batch construction matching the GNN cell tensor formats.

Pads nodes/edges to the shape of the step, using the sentinel
conventions of models/gnn.py (edge endpoints = n_nodes index into the
sentinel row).  The JAX package's ``data/graphs.py``, draw for draw: the
same seeds give the same numpy arrays, bit for bit, and ``to_2d_batch``
deals the arcs with this package's ``partition_arcs_2d``.
"""
from __future__ import annotations

import numpy as np

from ..configs.base import GNNArch
from ..graphs.graph import Graph
from ..graphs.partition import partition_arcs_2d
from .sampler import NeighborSampler

__all__ = ["full_graph_batch", "molecule_batch", "minibatch_batch", "synth_features",
           "to_2d_batch"]


def synth_features(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


def _pad_edges(src, dst, n_edges_pad, sentinel):
    pad = n_edges_pad - len(src)
    if pad < 0:
        raise ValueError(f"edge budget too small: {len(src)} > {n_edges_pad}")
    src = np.concatenate([src, np.full(pad, sentinel, np.int32)])
    dst = np.concatenate([dst, np.full(pad, sentinel, np.int32)])
    return src, dst


def full_graph_batch(
    cfg: GNNArch,
    graph: Graph,
    n_nodes_pad: int,
    n_edges_pad: int,
    d_feat: int,
    d_out: int,
    n_classes: int,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    feat = np.zeros((n_nodes_pad, d_feat), np.float32)
    feat[: graph.n] = synth_features(graph.n, d_feat, seed)
    src, dst = _pad_edges(
        graph.src.astype(np.int32), graph.dst.astype(np.int32), n_edges_pad, n_nodes_pad
    )
    batch = {"node_feat": feat, "edge_src": src, "edge_dst": dst}
    if cfg.kind in ("graphcast", "meshgraphnet"):
        batch["target"] = rng.standard_normal((n_nodes_pad, d_out)).astype(np.float32)
        mask = np.zeros(n_nodes_pad, np.float32)
        mask[: graph.n] = 1.0
        batch["label_mask"] = mask
        if cfg.kind == "meshgraphnet":
            batch["edge_feat"] = rng.standard_normal((n_edges_pad, d_feat)).astype(
                np.float32
            )
    else:
        labels = rng.integers(0, n_classes, size=n_nodes_pad).astype(np.int32)
        mask = np.zeros(n_nodes_pad, np.float32)
        mask[: graph.n] = 1.0
        batch["labels"] = labels
        batch["label_mask"] = mask
    return batch


def molecule_batch(
    cfg: GNNArch,
    n_graphs: int,
    nodes_per: int,
    edges_per: int,
    n_nodes_pad: int,
    n_edges_pad: int,
    d_feat: int,
    d_out: int,
    n_classes: int,
    seed: int = 0,
) -> dict:
    """Batched small graphs as one disjoint union (segment-pooled)."""
    rng = np.random.default_rng(seed)
    srcs, dsts, gids = [], [], []
    for g in range(n_graphs):
        off = g * nodes_per
        u = rng.integers(0, nodes_per, size=edges_per // 2)
        v = rng.integers(0, nodes_per, size=edges_per // 2)
        srcs.append(np.concatenate([u, v]) + off)
        dsts.append(np.concatenate([v, u]) + off)
        gids.append(np.full(nodes_per, g, np.int32))
    n_used = n_graphs * nodes_per
    feat = np.zeros((n_nodes_pad, d_feat), np.float32)
    feat[:n_used] = synth_features(n_used, d_feat, seed)
    src, dst = _pad_edges(
        np.concatenate(srcs).astype(np.int32),
        np.concatenate(dsts).astype(np.int32),
        n_edges_pad,
        n_nodes_pad,
    )
    gid = np.concatenate(gids + [np.zeros(n_nodes_pad - n_used, np.int32)])
    mask = np.zeros(n_nodes_pad, np.float32)
    mask[:n_used] = 1.0
    return {
        "node_feat": feat,
        "edge_src": src,
        "edge_dst": dst,
        "graph_ids": gid,
        "labels": rng.integers(0, n_classes, size=n_graphs).astype(np.int32),
        "label_mask": mask,
    }


def minibatch_batch(
    cfg: GNNArch,
    graph: Graph,
    features: np.ndarray,
    sampler: NeighborSampler,
    targets: np.ndarray,
    n_nodes_pad: int,
    n_edges_pad: int,
    n_classes: int,
    labels: np.ndarray | None = None,
    seed: int = 0,
) -> dict:
    block = sampler.sample(targets)
    n_blk = len(block.node_ids)
    d_feat = features.shape[1]
    feat = np.zeros((n_nodes_pad, d_feat), np.float32)
    feat[:n_blk] = features[block.node_ids]
    src, dst = _pad_edges(block.edge_src, block.edge_dst, n_edges_pad, n_nodes_pad)
    rng = np.random.default_rng(seed)
    lab = (
        labels[targets]
        if labels is not None
        else rng.integers(0, n_classes, size=len(targets))
    ).astype(np.int32)
    return {
        "node_feat": feat,
        "edge_src": src,
        "edge_dst": dst,
        "labels": lab,
        "target_idx": block.target_idx,
    }


def to_2d_batch(batch: dict, n_true_pad: int, R: int, C: int, max_arcs: int | None = None) -> dict:
    """Convert a flat GNN batch (models/gnn.py format) into the 2-D
    chunk layout consumed by models/gnn2d.py.

    Node arrays stay in vertex order (the chunk layout is the identity
    on contiguous vertex ranges); arcs are re-dealt by the paper's 2-D
    rule, and per-arc payloads follow via ``arc_perm``.
    """
    n_nodes = batch["node_feat"].shape[0]
    chunk = -(-n_nodes // (R * C))
    n_pad = R * C * chunk
    src, dst = batch["edge_src"], batch["edge_dst"]
    real = (src < n_nodes) & (dst < n_nodes)  # drop flat-format sentinels
    part = partition_arcs_2d(
        src[real].astype(np.int64), dst[real].astype(np.int64), n_pad, R, C,
        max_arcs=max_arcs,
    )

    def pad_nodes(a, fill=0):
        if a.shape[0] == n_pad:
            return a
        widths = [(0, n_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    out = {
        "node_feat": pad_nodes(batch["node_feat"]),
        "src_local": part.src_local,
        "dst_local": part.dst_local,
    }
    if "target" in batch:
        out["target"] = pad_nodes(batch["target"])
        out["label_mask"] = pad_nodes(
            batch.get("label_mask", np.ones(n_nodes, np.float32))
        )
    if "edge_feat" in batch:
        ef = batch["edge_feat"][real]
        d = ef.shape[1]
        gathered = np.zeros((part.R, part.C, part.src_local.shape[2], d), np.float32)
        valid = part.arc_perm >= 0
        gathered[valid] = ef[part.arc_perm[valid]]
        out["edge_feat"] = gathered
    if "graph_ids" in batch:
        out["graph_ids"] = pad_nodes(batch["graph_ids"], fill=0)
        out["labels"] = batch["labels"]
        out["label_mask"] = pad_nodes(batch["label_mask"])
    elif "labels" in batch and "target" not in batch:
        if "target_idx" in batch:  # minibatch: scatter labels to targets
            labels_full = np.full(n_pad, 0, np.int32)
            mask = np.zeros(n_pad, np.float32)
            labels_full[batch["target_idx"]] = batch["labels"]
            mask[batch["target_idx"]] = 1.0
            out["labels"] = labels_full
            out["label_mask"] = mask
        else:
            out["labels"] = pad_nodes(batch["labels"])
            out["label_mask"] = pad_nodes(batch["label_mask"])
    return out
