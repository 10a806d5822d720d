"""DLRM (Naumov et al., arXiv:1906.00091) — the RM2-class recommender.

The port of the JAX package's ``models/dlrm.py``.  The embedding lookup
is the hot path: the ``[F, V, D]`` tables are read as one flat
``[F·V, D]`` table (a view, no copy), each (example, field) pair is one
bag, and the bags go through :func:`repro_torch.kernels.ops.segment_bag`
— the hand-written K7 on the card, its plain version on the CPU — which
is differentiable in the tables (``ops.SegmentBag``: K7 forward, an
order-fixed sum backward), so the model trains as the JAX package's does
(its ``dlrm_loss`` trains through XLA's gather).  The model runs on one
device: the JAX package's row sharding of the tables over a mesh has no
counterpart yet.

Batch format (numpy or tensors):
  dense  f32 [B, n_dense]       sparse i32 [B, n_sparse, hot] (-1 = pad)
  loss:      labels f32 [B]
  retrieval: candidates f32 [n_candidates, embed_dim]
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import DLRMArch
from ..kernels import ops
from .layers import dense_init_

__all__ = ["DLRM", "embedding_bag_lookup", "interaction_dims", "dlrm_loss", "retrieval_scores"]


def interaction_dims(cfg: DLRMArch) -> int:
    """Width of the top MLP's input: the pairwise dots of the F+1 feature
    vectors plus the bottom output."""
    f = cfg.n_sparse + 1  # sparse fields + bottom output
    return f * (f - 1) // 2 + cfg.embed_dim


def _mlp(dims: tuple[int, ...], device: torch.device, generator: torch.Generator) -> nn.ModuleList:
    layers = nn.ModuleList()
    for a, b in zip(dims[:-1], dims[1:]):
        lin = nn.utils.skip_init(nn.Linear, a, b, device=device)
        dense_init_(lin.weight, generator, in_axis=1)
        with torch.no_grad():
            lin.bias.zero_()
        layers.append(lin)
    return layers


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor, final_act: bool) -> torch.Tensor:
    for i, lin in enumerate(layers):
        x = lin(x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def embedding_bag_lookup(tables: torch.Tensor, sparse_idx: torch.Tensor) -> torch.Tensor:
    """tables [F, V, D], sparse_idx i32 [B, F, L] (−1 pad; ids below V)
    -> f32 [B, F, D]: one K7 launch over the B·F bags of the flat table."""
    b, f, bag_len = sparse_idx.shape
    v, d = tables.shape[1], tables.shape[2]
    flat_table = tables.view(f * v, d)  # F·V < 2^31: the flat ids stay i32
    offs = (torch.arange(f, dtype=torch.int32, device=sparse_idx.device) * v)[None, :, None]
    flat_idx = torch.where(sparse_idx >= 0, sparse_idx + offs, -1)
    bags = flat_idx.reshape(b * f, bag_len)
    return ops.segment_bag(flat_table, bags).view(b, f, d)


class DLRM(nn.Module):
    """Bottom MLP → embedding bags → pairwise dot interaction → top MLP.

    Parameters are created on ``device`` from ``generator`` (which lies on
    that device): the tables as N(0, 1/D) filled in place, one table at a
    time, the MLP weights by :func:`dense_init_`, the biases zero.  State
    keys: ``tables`` [F, V, D], ``bot.{i}.weight`` / ``.bias``,
    ``top.{i}.weight`` / ``.bias`` (``nn.Linear`` layout, [out, in])."""

    def __init__(self, cfg: DLRMArch, *, device: torch.device | str,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
        self.tables = nn.Parameter(torch.empty((f, v, d), device=device))
        with torch.no_grad():
            for table in self.tables:  # one table at a time: 671 M elements at RM2
                table.normal_(0.0, d**-0.5, generator=generator)
        self.bot = _mlp((cfg.n_dense,) + cfg.bot_mlp, device, generator)
        self.top = _mlp((interaction_dims(cfg),) + cfg.top_mlp, device, generator)
        iu, ju = torch.triu_indices(f + 1, f + 1, 1, device=device)  # row-major, as jnp's
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)

    def forward(self, dense: torch.Tensor, sparse_idx: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logit [B], feature vectors [B, F+1, D])."""
        bot = _mlp_apply(self.bot, dense, final_act=True)  # [B, D]
        emb = embedding_bag_lookup(self.tables, sparse_idx)
        feats = torch.cat([bot[:, None, :], emb], dim=1)  # [B, F+1, D]
        dots = torch.bmm(feats, feats.transpose(1, 2))  # pairwise dot interaction
        z = torch.cat([bot, dots[:, self._iu, self._ju]], dim=-1)  # upper triangle
        logit = _mlp_apply(self.top, z, final_act=False)
        return logit[:, 0], feats


def dlrm_loss(model: DLRM, batch: dict) -> tuple[torch.Tensor, dict]:
    """Mean binary cross-entropy of the logits against ``labels``, in the
    reference's stable form; differentiable in every parameter."""
    logit, _ = model(batch["dense"], batch["sparse"])
    labels = batch["labels"]
    loss = torch.mean(
        torch.clamp(logit, min=0.0) - logit * labels + torch.log1p(torch.exp(-logit.abs()))
    )
    return loss, {"bce": loss}


def retrieval_scores(model: DLRM, batch: dict, top_k: int = 100
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score each query against the ``candidates`` item embeddings (one
    batched product): user vector = bottom output + pooled sparse
    embeddings.  Returns (scores [B, top_k], candidate ids [B, top_k])."""
    _, feats = model(batch["dense"], batch["sparse"])
    user = feats.sum(dim=1)  # [B, D]
    scores = user @ batch["candidates"].T  # [B, Nc]
    return torch.topk(scores, top_k)
