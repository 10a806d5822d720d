"""Graph neural networks on the segment-sum message-passing substrate.

The JAX package's ``models/gnn.py`` in torch.  All four GNN archs
(graphcast, gat-cora, gin-tu, meshgraphnet) share one edge-list
substrate: messages are gathered from ``x[src]``, optionally combined
with edge features, and summed into ``dst`` (``index_add``; the GAT
softmax also takes a per-destination max, ``scatter_reduce("amax")``).
The reference's ``constrain`` calls are JAX mesh hints and have no
counterpart here; the 2-D decomposed path is :mod:`.gnn2d`.

Parameters are a flat dict ``{name: tensor}`` holding the reference's
tree under dotted names (``enc_w``, ``dec_b``, ``layers.w1``, …): the
encoder / decoder weights [in, out], every layer leaf stacked on a
leading L axis (``layers.w1`` [L, d, d]), so an optimizer steps the
reference's leaves (``interop.gnn_params_from_jax`` /
``gnn_params_to_jax`` carry them across).  Each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward keeps a layer's input, not its gathered ``[E, d]`` messages.

Input batch format (tensors; see data/graphs.py):
  node_feat [N, d_feat] f32   edge_src/edge_dst [E] int (sentinel N = pad)
  full_graph:     labels [N] int, label_mask [N] f32
  minibatch:      labels [T] int, target_idx [T] int
  batched_graphs: graph_ids [N] int, labels [G] int, label_mask [N] f32
  regression (graphcast/meshgraphnet): target [N, d_out] f32
Index tensors may be int32 or int64 (``index_select`` / ``index_add``
take either).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import GNNArch
from .layers import dense_init_

__all__ = ["output_dim", "hidden_dim", "param_specs", "n_params", "init_params", "gnn_forward",
           "gnn_loss", "segment_sum", "segment_max"]

Params = dict[str, torch.Tensor]


def output_dim(cfg: GNNArch, shape) -> int:
    if cfg.kind in ("graphcast", "meshgraphnet"):
        return cfg.n_vars if cfg.kind == "graphcast" else 3
    return shape.n_classes


def hidden_dim(cfg: GNNArch) -> int:
    """The node state's width: H·d_hidden for GAT, d_hidden otherwise."""
    return cfg.d_hidden * (cfg.n_heads if cfg.kind == "gat" else 1)


def param_specs(cfg: GNNArch, d_feat: int, d_out: int) -> dict[str, tuple[tuple[int, ...], int | None]]:
    """name -> (shape, fan-in axis of its init; None for a zero leaf), in
    the reference's order; every leaf f32."""
    d, L = hidden_dim(cfg), cfg.n_layers
    specs = {"enc_w": ((d_feat, d), -2), "enc_b": ((d,), None),
             "dec_w": ((d, d_out), -2), "dec_b": ((d_out,), None)}
    if cfg.kind == "gat":
        dh, H = cfg.d_hidden, cfg.n_heads
        layers = {"w": ((L, d, H, dh), -2), "a_src": ((L, H, dh), -1),
                  "a_dst": ((L, H, dh), -1)}
    elif cfg.kind == "gin":
        layers = {"eps": ((L,), None), "w1": ((L, d, d), -2), "b1": ((L, d), None),
                  "w2": ((L, d, d), -2), "b2": ((L, d), None)}
    elif cfg.kind == "meshgraphnet":
        specs["edge_enc_w"] = ((d_feat, d), -2)  # edge features same width
        specs["edge_enc_b"] = ((d,), None)
        layers = {"we1": ((L, 3 * d, d), -2), "be1": ((L, d), None),
                  "we2": ((L, d, d), -2), "be2": ((L, d), None),
                  "wn1": ((L, 2 * d, d), -2), "bn1": ((L, d), None),
                  "wn2": ((L, d, d), -2), "bn2": ((L, d), None)}
    else:  # graphcast: interaction-network processor (node messages)
        layers = {"wm1": ((L, 2 * d, d), -2), "bm1": ((L, d), None),
                  "wm2": ((L, d, d), -2), "bm2": ((L, d), None),
                  "wu1": ((L, 2 * d, d), -2), "bu1": ((L, d), None),
                  "wu2": ((L, d, d), -2), "bu2": ((L, d), None)}
    specs.update({f"layers.{k}": v for k, v in layers.items()})
    return specs


def n_params(cfg: GNNArch, d_feat: int, d_out: int) -> int:
    return sum(math.prod(shape) for shape, _ in param_specs(cfg, d_feat, d_out).values())


def init_params(cfg: GNNArch, d_feat: int, d_out: int, generator: torch.Generator) -> Params:
    """The parameters on ``generator``'s device, leaves requiring grad,
    drawn as the reference draws them from other random numbers: each
    weight fan-in truncated normal over its spec's axis, biases and GIN's
    ε zero."""
    params = {}
    for name, (shape, in_axis) in param_specs(cfg, d_feat, d_out).items():
        t = torch.zeros(shape, dtype=torch.float32, device=generator.device)
        if in_axis is not None:
            dense_init_(t, generator, in_axis=in_axis)
        params[name] = t.requires_grad_(True)
    return params


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, n):
        ctx.save_for_backward(idx)
        return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, idx, x)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return grad.index_select(0, idx), None, None


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...]: row s the sum of the rows of ``x`` whose ``idx`` is s
    (``index_add``: atomic on the card).  Its backward gathers the
    cotangent's rows and keeps only ``idx``: autograd's own ``index_add``
    keeps its [E, ...] source alive into the backward (for its shape), a
    second message block beside the backward's own at ogb_products."""
    return _SegmentSum.apply(x, idx, n)


def segment_max(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...]: row s the max of the rows of ``x`` whose ``idx`` is s,
    −inf for an empty segment (``jax.ops.segment_max``)."""
    index = idx.long().view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return x.new_full((n,) + tuple(x.shape[1:]), -math.inf).scatter_reduce(
        0, index, x, "amax", include_self=False)


def pad_row(z: torch.Tensor) -> torch.Tensor:
    """``z`` with a zero sentinel row appended."""
    return torch.cat([z, z.new_zeros((1,) + tuple(z.shape[1:]))])


def layer_views(params: Params) -> list[dict[str, torch.Tensor]]:
    """Layer l's leaves ``{name: leaf[l]}``, one ``unbind`` a stacked leaf
    (its gradient is stacked once by the unbind's backward)."""
    names = [k for k in params if k.startswith("layers.")]
    per_leaf = [params[k].unbind(0) for k in names]
    return [{k[len("layers."):]: v for k, v in zip(names, layer)} for layer in zip(*per_leaf)]


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` when autograd records
    (the reference's ``jax.checkpoint``), plainly otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def mlp2(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """relu(x @ w1 + b1) @ w2 + b2."""
    return F.relu(x @ w1 + b1) @ w2 + b2


def gin_update(lp: dict, h: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    z = (1.0 + lp["eps"]) * h + agg
    z = F.relu(z @ lp["w1"] + lp["b1"])
    return F.relu(z @ lp["w2"] + lp["b2"])


def node_update(cfg: GNNArch, lp: dict, h: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    """meshgraphnet / graphcast: h + MLP([h, agg])."""
    cat = torch.cat([h, agg], dim=-1)
    if cfg.kind == "meshgraphnet":
        return h + mlp2(cat, lp["wn1"], lp["bn1"], lp["wn2"], lp["bn2"])
    return h + mlp2(cat, lp["wu1"], lp["bu1"], lp["wu2"], lp["bu2"])


def gat_project(cfg: GNNArch, lp: dict, h: torch.Tensor) -> torch.Tensor:
    """h @ w: [N, d] -> [N, H, dh]."""
    w = lp["w"]
    return (h @ w.reshape(w.shape[0], -1)).view(h.shape[0], cfg.n_heads, cfg.d_hidden)


def attn_logits(hw_src, hw_dst, lp, src, dst) -> torch.Tensor:
    """leaky_relu(a_src·hw[src] + a_dst·hw[dst], 0.2) [E, H]; the dot
    products taken per node, then gathered (the same sums per row)."""
    e_src = (hw_src * lp["a_src"]).sum(-1).index_select(0, src)
    e_dst = (hw_dst * lp["a_dst"]).sum(-1).index_select(0, dst)
    return F.leaky_relu(e_src + e_dst, 0.2)


def gnn_forward(cfg: GNNArch, params: Params, batch: dict) -> torch.Tensor:
    """Returns per-node outputs [N, d_out]."""
    x = batch["node_feat"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0] + 1  # +1 sentinel row for padding arcs
    h = torch.tanh(x @ params["enc_w"] + params["enc_b"])
    layers = layer_views(params)

    if cfg.kind == "gat":
        def layer(h, lp):
            hp = pad_row(gat_project(cfg, lp, h))  # [N+1, H, dh]
            logit = attn_logits(hp, hp, lp, src, dst)  # [E, H]
            # segment softmax over incoming edges of dst; shift-invariant,
            # so the max is a constant for autograd
            mx = segment_max(logit.detach(), dst, n)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            ex = torch.exp(logit - mx.index_select(0, dst))
            denom = segment_sum(ex, dst, n)
            alpha = ex / torch.clamp_min(denom.index_select(0, dst), 1e-9)
            msgs = hp.index_select(0, src) * alpha[..., None]  # [E, H, dh]
            agg = segment_sum(msgs, dst, n)[:-1]  # [N, H, dh]
            return F.elu(agg.reshape(h.shape[0], -1))

        for lp in layers:
            h = remat(layer, h, lp)
    elif cfg.kind == "gin":
        def layer(h, lp):
            agg = segment_sum(pad_row(h).index_select(0, src), dst, n)[:-1]
            return gin_update(lp, h, agg)

        for lp in layers:
            h = remat(layer, h, lp)
    elif cfg.kind == "meshgraphnet":
        e = torch.tanh(batch["edge_feat"] @ params["edge_enc_w"] + params["edge_enc_b"])

        def layer(h, e, lp):
            hp = pad_row(h)
            cat = torch.cat([e, hp.index_select(0, src), hp.index_select(0, dst)], dim=-1)
            e = e + mlp2(cat, lp["we1"], lp["be1"], lp["we2"], lp["be2"])  # residual edges
            agg = segment_sum(e, dst, n)[:-1]
            return node_update(cfg, lp, h, agg), e

        for lp in layers:
            h, e = remat(layer, h, e, lp)
    else:  # graphcast
        def layer(h, lp):
            hp = pad_row(h)
            cat = torch.cat([hp.index_select(0, src), hp.index_select(0, dst)], dim=-1)
            m = mlp2(cat, lp["wm1"], lp["bm1"], lp["wm2"], lp["bm2"])
            agg = segment_sum(m, dst, n)[:-1]
            return node_update(cfg, lp, h, agg)

        for lp in layers:
            h = remat(layer, h, lp)
    return h @ params["dec_w"] + params["dec_b"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp(logits) − logits[label], per row (f32)."""
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def gnn_loss(cfg: GNNArch, params: Params, batch: dict, shape_kind: str):
    """(loss f32 0-d, {"mse"} or {"ce"}), the reference's ``gnn_loss``."""
    out = gnn_forward(cfg, params, batch)  # [N, d_out]
    node_mask = batch.get("label_mask")
    if cfg.kind in ("graphcast", "meshgraphnet"):
        err = (out - batch["target"]).float()
        if node_mask is not None:
            sse = torch.sum(err.square() * node_mask[:, None])
            cnt = torch.clamp_min(node_mask.sum() * out.shape[1], 1.0)
            loss = sse / cnt
        else:
            loss = err.square().mean()
        return loss, {"mse": loss}
    if shape_kind == "batched_graphs":
        n_graphs = batch["labels"].shape[0]
        masked = out * node_mask[:, None] if node_mask is not None else out
        logits = segment_sum(masked, batch["graph_ids"], n_graphs).float()
        labels = batch["labels"]
        mask = torch.ones(n_graphs, dtype=torch.float32, device=out.device)
    elif shape_kind == "minibatch":
        logits = out.index_select(0, batch["target_idx"]).float()
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=out.device)
    else:  # full_graph
        logits = out.float()
        labels = batch["labels"]
        mask = batch["label_mask"]
    loss = torch.sum(cross_entropy(logits, labels) * mask) / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"ce": loss}
