"""2-D distributed GNN message passing — MGBC's decomposition applied to
GNN training, on a :class:`~repro_torch.distributed.GridGroups` grid.

The JAX package's ``models/gnn2d.py``, one process per device instead of
``shard_map``.  One message-passing layer has the communication
structure of the paper's traversal level:

  expand:   all_gather(h chunks, column group) → h[cols_j]
            all_gather(h chunks, row group)    → h[rows_i]
            (the second gather feeds messages that read the
            *destination* features — BC's frontier only needed sources)
  local:    per-arc message MLP + local segment sum
  fold:     reduce_scatter(partials, row group) → owner chunks

Names: the JAX ``row_axis`` ("data", size R) gathers over i at fixed j —
the port's ``groups.column`` — and yields cols_j; its ``col_axis``
("model", size C) gathers, maxes, sums and folds over j at fixed i —
``groups.row``; its psum over both axes is ``groups.grid``.  Device
(i, j) owns vertex chunk ``j·R + i``.  Arc arrays come from
``graphs/partition.partition_arcs_2d`` (``data/graphs.to_2d_batch``): the
destination sentinel is ``C·chunk`` (row ``n_acc − 1`` of the partial,
dropped before the fold); padding arcs gather source row 0, and in GAT
get logit −inf.

Gradients (``distributed.groups``): the expand and the fold are each
other's transpose; GAT's softmax denominator, summed over the row group,
has a summed backward; its max is taken on detached values (the softmax
is shift-invariant).  The loss's sums over the grid hand each rank its
own cotangent and the replicated parameters' gradients are summed over
the grid, so ``loss.backward()`` on every rank leaves every rank the flat
path's gradient.  With ``gather_dtype`` / ``fold_dtype`` the expand /
fold payloads are cast before the collective and back after, and the
backward moves the same dtype.  Each layer runs under
``torch.utils.checkpoint``; its recompute repeats the forward's
collectives, in the same order on every rank.

Per-rank batch (:func:`gnn2d_local_batch` of the global 2-D batch):
  node_feat [chunk, d_feat]; src_local / dst_local [max_arcs];
  edge_feat [max_arcs, d_feat] (meshgraphnet);
  target [chunk, d_out] + label_mask [chunk] (regression);
  graph_ids [chunk] + labels [n_graphs] + label_mask (batched_graphs);
  labels [chunk] + label_mask [chunk] (full_graph / minibatch).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import GNNArch
from ..distributed.groups import (
    GridGroups,
    all_gather_grad,
    all_reduce,
    reduce_scatter_grad,
    replicated,
    sum_loss,
    sum_shared,
)
from .gnn import (
    attn_logits,
    cross_entropy,
    gat_project,
    gin_update,
    layer_views,
    mlp2,
    node_update,
    pad_row,
    remat,
    segment_max,
    segment_sum,
)

__all__ = ["make_gnn2d_loss_fn", "gnn2d_batch_specs", "gnn2d_local_batch"]


def _cast_collective(fn, z: torch.Tensor, group, dtype) -> torch.Tensor:
    """``fn(z, group)``, its payload cast to ``dtype`` (None: as is) and
    the result cast back to ``z``'s dtype."""
    if dtype is None or z.dtype == dtype:
        return fn(z, group)
    return fn(z.to(dtype), group).to(z.dtype)


def make_gnn2d_loss_fn(
    cfg: GNNArch,
    groups: GridGroups,
    shape_kind: str,
    chunk: int,
    max_arcs: int,
    n_graphs: int = 0,
    gather_dtype: torch.dtype | None = None,
    fold_dtype: torch.dtype | None = None,
):
    """Builds ``loss_fn(params, batch)`` for this rank of the grid: the
    loss f32 0-d, equal on every rank; ``batch`` is the rank's part (see
    the module docstring).  Every rank of the grid calls it together."""
    C = groups.C
    n_acc = C * chunk + 1  # + sentinel row
    col, row = groups.column, groups.row

    def gather(z, group):
        """Expand collective; a low-precision payload halves its bytes."""
        return _cast_collective(all_gather_grad, z, group, gather_dtype)

    def check(batch):
        for key in ("src_local", "dst_local"):
            if tuple(batch[key].shape) != (max_arcs,):
                raise ValueError(f"{key} must be [{max_arcs}], got {tuple(batch[key].shape)}")
        if batch["node_feat"].shape[0] != chunk:
            raise ValueError(f"node_feat must hold the chunk of {chunk} rows, "
                             f"got {batch['node_feat'].shape[0]}")

    def mp(h, e_loc, lp, src_l, dst_l, valid):
        if cfg.kind == "gat":
            H, dh = cfg.n_heads, cfg.d_hidden
            hw_own = gat_project(cfg, lp, h)  # [chunk, H, dh]
            hwc = pad_row(gather(hw_own, col))
            hwr = gather(hw_own, row)
            logit = attn_logits(hwc, hwr, lp, src_l, torch.clamp_max(dst_l, C * chunk - 1))
            logit = torch.where(valid[:, None], logit, -torch.inf)  # [A, H]
            # segment softmax: stats summed across the row group; the
            # cross-device max is a constant for autograd
            mx = all_reduce(segment_max(logit.detach(), dst_l, n_acc), dist.ReduceOp.MAX, row)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            ex = torch.where(valid[:, None], torch.exp(logit - mx.index_select(0, dst_l)), 0.0)
            denom = sum_shared(segment_sum(ex, dst_l, n_acc), row)
            alpha = ex / torch.clamp_min(denom.index_select(0, dst_l), 1e-9)
            msgs = hwc.index_select(0, src_l) * alpha[..., None]  # [A, H, dh]
            partial = segment_sum(msgs, dst_l, n_acc)
            folded = reduce_scatter_grad(partial[: C * chunk].reshape(C * chunk, H * dh), row)
            return F.elu(folded), e_loc

        hc = pad_row(gather(h, col))  # [R*chunk + 1, d]
        if cfg.kind == "gin":
            partial, e2 = segment_sum(hc.index_select(0, src_l), dst_l, n_acc), e_loc
        else:
            h_dst = gather(h, row).index_select(0, torch.clamp_max(dst_l, C * chunk - 1))
            h_src = hc.index_select(0, src_l)
            keep = valid[:, None].to(h.dtype)
            if cfg.kind == "meshgraphnet":
                cat = torch.cat([e_loc, h_src, h_dst], dim=-1)
                e2 = e_loc + mlp2(cat, lp["we1"], lp["be1"], lp["we2"], lp["be2"]) * keep
                partial = segment_sum(e2, dst_l, n_acc)
            else:  # graphcast
                cat = torch.cat([h_src, h_dst], dim=-1)
                m = mlp2(cat, lp["wm1"], lp["bm1"], lp["wm2"], lp["bm2"]) * keep
                partial = segment_sum(m, dst_l, n_acc)
                e2 = e_loc
        agg = _cast_collective(reduce_scatter_grad, partial[: C * chunk], row, fold_dtype)
        if cfg.kind == "gin":
            return gin_update(lp, h, agg), e2
        return node_update(cfg, lp, h, agg), e2

    def loss_fn(params, batch):
        check(batch)
        params = {k: replicated(v, groups.grid) for k, v in params.items()}
        src_l, dst_l = batch["src_local"], batch["dst_local"]
        valid = dst_l < C * chunk
        h = torch.tanh(batch["node_feat"] @ params["enc_w"] + params["enc_b"])
        e_loc = None
        if cfg.kind == "meshgraphnet":
            e_loc = torch.tanh(batch["edge_feat"] @ params["edge_enc_w"] + params["edge_enc_b"])
        for lp in layer_views(params):
            h, e_loc = remat(mp, h, e_loc, lp, src_l, dst_l, valid)
        out = h @ params["dec_w"] + params["dec_b"]  # [chunk, d_out]

        grid = groups.grid
        if cfg.kind in ("graphcast", "meshgraphnet"):
            err = (out - batch["target"]).float()
            mask = batch["label_mask"][:, None]
            sse = sum_loss(torch.sum(err.square() * mask), grid)
            cnt = sum_loss(torch.sum(mask) * out.shape[1], grid)
            return sse / torch.clamp_min(cnt, 1.0)
        if shape_kind == "batched_graphs":
            masked = out * batch["label_mask"][:, None]
            pooled = segment_sum(masked, batch["graph_ids"], n_graphs)
            logits = sum_loss(pooled, grid).float()  # [G, d_out]
            return torch.mean(cross_entropy(logits, batch["labels"]))
        # full_graph / minibatch via label_mask
        mask = batch["label_mask"]
        ce = cross_entropy(out.float(), torch.clamp_min(batch["labels"], 0))
        num = sum_loss(torch.sum(ce * mask), grid)
        den = sum_loss(torch.sum(mask), grid)
        return num / torch.clamp_min(den, 1.0)

    return loss_fn


def gnn2d_batch_specs(cfg: GNNArch, shape_kind, n_pad, R, C, max_arcs, d_feat, d_out,
                      n_graphs=0) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each array of the global 2-D batch (the
    reference's ShapeDtypeStruct tree)."""
    specs = {
        "node_feat": ((n_pad, d_feat), torch.float32),
        "src_local": ((R, C, max_arcs), torch.int32),
        "dst_local": ((R, C, max_arcs), torch.int32),
    }
    if cfg.kind in ("graphcast", "meshgraphnet"):
        specs["target"] = ((n_pad, d_out), torch.float32)
        specs["label_mask"] = ((n_pad,), torch.float32)
        if cfg.kind == "meshgraphnet":
            specs["edge_feat"] = ((R, C, max_arcs, d_feat), torch.float32)
    elif shape_kind == "batched_graphs":
        specs["graph_ids"] = ((n_pad,), torch.int32)
        specs["labels"] = ((n_graphs,), torch.int32)
        specs["label_mask"] = ((n_pad,), torch.float32)
    else:
        specs["labels"] = ((n_pad,), torch.int32)
        specs["label_mask"] = ((n_pad,), torch.float32)
    return specs


def gnn2d_local_batch(batch: dict, groups: GridGroups, device) -> dict[str, torch.Tensor]:
    """This rank's part of a global 2-D batch (``data/graphs.to_2d_batch``,
    numpy arrays or tensors) as tensors on ``device``: node arrays' chunk
    ``j·R + i``, arc arrays' cell (i, j), a batched shape's graph labels
    whole; index arrays as they come (int32)."""
    R, C, i, j = groups.R, groups.C, groups.i, groups.j
    n_pad = batch["node_feat"].shape[0]
    chunk = n_pad // (R * C)
    lo = (j * R + i) * chunk
    out = {}
    for key, value in batch.items():
        if key in ("src_local", "dst_local", "edge_feat"):
            part = value[i, j]
        elif key == "labels" and "graph_ids" in batch:
            part = value
        else:
            part = value[lo:lo + chunk]
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out[key] = part.to(device)
    return out
