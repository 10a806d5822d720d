"""Cell programs of the port: (arch × shape) -> a callable.

The counterpart of the JAX package's ``launch/steps.py``: the LMs
(``_build_lm_cell`` there), the GNNs (``_build_gnn_cell``), DLRM
(``_build_dlrm_cell``) and the paper's own BC workload
(``_build_bc_cell``); :func:`build_cell` dispatches on the arch.

An LM cell owns its ``TransformerLM`` on the device (drawn from a seeded
generator there, or passed in) and a callable, as the JAX cell's:

  prefill    fn(batch) -> (logits f32 [B, V_padded], cache), batch
             {"tokens": i32 [B, S]}; the cache k / v bf16 [L, B, S, K, hd]
  decode     fn(cache, batch) -> (logits, cache), batch {"tokens": i32
             [B], "pos": int}; the cache [L, B, S, K, hd] (``empty_cache``)
             is updated in place

  train      fn(batch) -> {"loss", "ce", "aux"} f32 0-d, after one step of
             ``make_optimizer(cfg.optimizer)`` (lr 1e-4, as the JAX cell)
             taken in place on a trainable model: ``lm_loss``, its
             backward, the step, the gradients set to None; batch
             {"tokens": i32 [B, S]}

The train cell's state is exposed in the JAX package's layout
(``LMCell.train_state`` / ``load_train_state``: the model's stacked
leaves and the optimizer's state tensors themselves), so a checkpoint
written through ``checkpoint.CheckpointManager`` resumes in either
package.

Its ``static_meta`` (``n_params``, ``model_flops``, ``tokens``,
``analytic_bytes_global``) is the JAX cell's, computed from the shapes
alone (:func:`lm_static_meta`): ``device="meta"`` builds a cell with the
meta and nothing else, for an arch no card holds.

A DLRM cell owns its model, created on the device from a seeded
generator, and a callable that takes one batch of numpy arrays (or
tensors), moves it to the device and returns the outputs there:

  train      -> {"loss", "bce"} f32 0-d, after one AdamW step (lr 1e-3,
                as the JAX cell) taken in place: K7 forward, its
                order-fixed gradient, the dense update of every table
  serve      -> sigmoid(logit) f32 [B]
  retrieval  -> (scores [B, 100], candidate ids [B, 100])

The train cell's state, parameters and optimizer, is exposed in the JAX
package's layout (``DLRMCell.train_state`` / ``load_train_state``), so a
checkpoint written through ``checkpoint.CheckpointManager`` resumes in
either package.  ``static_meta`` holds ``n_params`` and ``model_flops``,
computed as the JAX cell computes them.

A BC cell is one distributed MGBC round of the shape's R-MAT graph on a
caller's :class:`~repro_torch.distributed.GridGroups` grid, on the
``sparse`` engine (the JAX cell's engine): the graph made on the host
from a seed, its residual under the arch's heuristics, the schedule and
the 2-D partition, the rank's arc arrays and ω on the device.  Its
callable runs one round on inputs sources i32 [fr, s] and derived i32
[fr, k, 3] (the JAX cell's ``args_specs``).  The JAX cell only lowers the
round on placeholder arrays; this one runs it.  ``static_meta`` is
computed from the shapes and the grid alone (:func:`bc_static_meta`), so
a shape no card holds still has its meta.

A GNN cell is one train step of the shape's graph on a caller's grid,
through the 2-D decomposed message passing (``models/gnn2d.py``, the JAX
cell's path): the graph made on the host from a seed at the shape's vertex and arc
counts (``graphs.sized_rmat_graph``, skewed degrees, for GAT and GIN;
``graphs.sized_mesh_graph``, bounded degrees, for the mesh GNNs
graphcast and meshgraphnet, whose unnormalised sums over 15–16 layers
overflow f32 at an R-MAT hub — the reference's arithmetic; the molecule
shape's disjoint union; the minibatch shape's sampled block),
its flat batch (``data/graphs.py``) dealt onto the grid by
``to_2d_batch``, the rank's part and the parameters on the device, and
``adamw(1e-3)`` over them.  Its callable takes one step (the rank's
part of a 2-D batch, the cell's own by default) and returns the loss.
``static_meta`` (``n_params``, ``model_flops``, ``n_nodes``,
``n_edges``) is the JAX cell's, from the shapes alone
(:func:`gnn_static_meta`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from ..autotune import AUTOTUNE_MODES, CostCache, graph_key
from ..checkpoint.checkpointer import DEFAULT_GENERATIONS
from ..configs.base import BCArch, BCShape, DLRMArch, DLRMShape, GNNArch, LMArch
from ..configs.registry import ArchBundle
from ..core.distributed import distributed_graph_arrays, make_distributed_round_fn
from ..core.driver import DEFAULT_MAX_RETRIES, DEFAULT_RETRY_BACKOFF_S
from ..core.scheduler import Schedule, build_schedule
from ..device import resolve_device
from ..distributed.chaos import FAULT_KINDS
from ..data.graphs import full_graph_batch, minibatch_batch, molecule_batch, synth_features, to_2d_batch
from ..data.sampler import NeighborSampler
from ..distributed.groups import GridGroups, device_for_rank
from ..graphs.generators import rmat_graph, sized_mesh_graph, sized_rmat_graph
from ..graphs.graph import Graph
from ..graphs.partition import TwoDPartition, default_tile_dim, partition_2d
from ..interop import (
    assign_jax_layout,
    dlrm_params_to_jax,
    lm_optimizer_state_from_jax,
    lm_optimizer_state_to_jax,
    lm_params_to_jax,
    optimizer_state_from_jax,
    optimizer_state_to_jax,
)
from ..models import gnn as gnn_mod
from ..models import transformer as tf
from ..models.dlrm import DLRM, dlrm_loss, interaction_dims, retrieval_scores
from ..models.gnn2d import gnn2d_local_batch, make_gnn2d_loss_fn
from ..optim import adafactor, adamw
from ..roofline.model import device_hbm_footprint

__all__ = ["LMCell", "build_lm_cell", "lm_model_flops", "lm_analytic_bytes", "lm_static_meta",
           "DLRMCell", "build_dlrm_cell", "dlrm_model_flops", "dlrm_n_params", "pad_mult",
           "make_optimizer",
           "RETRIEVAL_TOP_K", "BCCell", "build_bc_cell", "bc_static_meta", "GNNCell",
           "build_gnn_cell", "gnn_cell_batch", "gnn_workload", "gnn_static_meta", "gnn_layout",
           "build_cell"]

RETRIEVAL_TOP_K = 100
DEV_MULT = 512  # the JAX cells pad the candidate count to this multiple


def pad_mult(x: int, m: int = DEV_MULT) -> int:
    """``x`` rounded up to a multiple of ``m`` (the retrieval candidates)."""
    return x + (-x) % m


# --------------------------------------------------------------------- LM
def lm_model_flops(cfg: LMArch, tokens: int) -> float:
    """6·N_active·D (MoE counts routed experts only), the JAX package's."""
    d, hhd, khd = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    per_layer = 2 * d * hhd + 2 * d * khd + hhd * d  # qkv + o
    if cfg.moe is None:
        per_layer += 3 * d * cfg.d_ff
    else:
        per_layer += 3 * d * cfg.moe.d_ff * cfg.moe.top_k
    n_active = cfg.n_layers * per_layer + cfg.vocab * d  # + embedding/head
    return 6.0 * n_active * tokens


def _leaf_shapes(cfg: LMArch) -> list[tuple[tuple[int, ...], torch.dtype]]:
    specs = tf.param_specs(cfg)
    return [specs["embed"], specs["ln_f"], *specs["layers"].values()]


def _params_bytes(cfg: LMArch) -> float:
    return float(sum(math.prod(shape) * dt.itemsize for shape, dt in _leaf_shapes(cfg)))


def _opt_state_bytes(cfg: LMArch) -> float:
    """Bytes of the optimizer state as the reference's ``opt_state_specs``
    lays it out: an i32 step, then f32 μ and ν of every leaf (AdamW), or
    Adafactor's f32 row statistics (the shape without its last dim) and
    column statistics (without its last but one; [1] for a vector), a
    vector keeping a full second moment."""
    leaves = [shape for shape, _ in _leaf_shapes(cfg)]
    if cfg.optimizer == "adafactor":
        f32 = sum(math.prod(s[:-1] if len(s) >= 2 else s)
                  + math.prod(s[:-2] + s[-1:] if len(s) >= 2 else (1,)) for s in leaves)
    else:
        f32 = 2 * sum(math.prod(s) for s in leaves)
    return float(4 + 4 * f32)


def lm_analytic_bytes(cfg: LMArch, shape) -> float:
    """The JAX package's analytic global HBM bytes of an LM cell
    (``_lm_analytic_bytes``), the same expression in the same order, so
    the float is equal.  Train: params, grads and the optimizer state,
    the bf16 residual carries of every layer, the per-layer transient of
    the remat backward (dense or MoE) and one loss chunk's f32 logits.
    Prefill / decode: params + cache (+ the cache written and the
    per-layer score chunk at prefill)."""
    pb = _params_bytes(cfg)
    d = cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        carries = cfg.n_layers * tokens * d * 2  # bf16 residual stack
        if cfg.moe is None:
            trans = tokens * (2 * cfg.d_ff + 4 * d) * 2
        else:
            m = cfg.moe
            cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
            trans = (
                m.num_experts * cap * (d + 2 * m.d_ff) * 2  # buf + h
                + tokens * m.top_k * (d * 2 + 4 * m.num_experts)  # rows + router
            )
        logits = shape.global_batch * cfg.loss_chunk * tf.padded_vocab(cfg) * 4
        grads = pb
        return pb + grads + _opt_state_bytes(cfg) + carries + trans + logits
    cache = 2 * cfg.n_layers * shape.global_batch * shape.seq_len * (
        cfg.n_kv_heads * cfg.head_dim
    ) * 2
    if shape.kind == "decode":
        return pb + cache + 2 * shape.global_batch * cfg.n_heads * shape.seq_len * 4
    tokens = shape.global_batch * shape.seq_len
    scores = shape.global_batch * cfg.n_heads * cfg.q_chunk * shape.seq_len * 4
    return pb + 2 * cache + tokens * d * 2 * 2 + scores


def lm_static_meta(cfg: LMArch, shape) -> dict:
    """The JAX LM cell's ``static_meta`` of a train, prefill or decode
    shape, from the shapes alone (nothing allocated)."""
    if shape.kind == "train":  # forward and backward: the reference's 3x
        tokens = shape.global_batch * shape.seq_len
        flops = 3 * lm_model_flops(cfg, tokens)
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops = lm_model_flops(cfg, tokens)
    elif shape.kind == "decode":  # one new token per sequence: 2·N_active a token
        tokens = shape.global_batch
        flops = 2.0 * lm_model_flops(cfg, tokens) / 6.0
    else:
        raise ValueError(f"unknown LM shape kind {shape.kind!r}")
    return {"n_params": tf.n_params(cfg), "model_flops": flops, "tokens": tokens,
            "analytic_bytes_global": lm_analytic_bytes(cfg, shape)}


@dataclasses.dataclass
class LMCell:
    name: str
    fn: Callable | None  # None for a meta-only cell
    model: tf.TransformerLM | None
    static_meta: dict
    shape: object = None
    optimizer: torch.optim.Optimizer | None = None  #: the train cell's

    def empty_cache(self) -> dict[str, torch.Tensor]:
        """A zero cache for the decode shape: k and v bf16 [L, B, S, K, hd]."""
        if self.model is None or self.shape.kind != "decode":
            raise ValueError(f"{self.name} is not a runnable decode cell")
        return self.model.empty_cache(self.shape.global_batch, self.shape.seq_len)

    def _check_train(self) -> None:
        if self.optimizer is None:
            raise ValueError(f"{self.name} is not a train cell: it has no train state")

    def train_state(self) -> dict:
        """``{"params": ..., "opt": ...}`` in the JAX package's layout and
        keys (``interop.lm_params_to_jax``, ``lm_optimizer_state_to_jax``):
        the live tensors themselves (the step a fresh i32 0-d tensor), which
        a ``Checkpointer`` copies to the host when it saves."""
        self._check_train()
        return {"params": lm_params_to_jax(self.model),
                "opt": lm_optimizer_state_to_jax(self.optimizer, self.model)}

    def load_train_state(self, state: dict) -> None:
        """Copy a train state in the JAX package's layout (numpy arrays or
        tensors, e.g. a restored checkpoint) into the model and the
        optimizer, in place."""
        self._check_train()
        assign_jax_layout(lm_params_to_jax(self.model), state["params"])
        lm_optimizer_state_from_jax(self.optimizer, self.model, state["opt"])


def build_lm_cell(bundle: ArchBundle, shape_name: str, device=None, seed: int = 0,
                  model: tf.TransformerLM | None = None, lr: float = 1e-4) -> LMCell:
    """The ``train``, ``prefill`` or ``decode`` cell of an LM arch on one
    device (``device=None``: the card, raising without one; ``"meta"``:
    the meta alone, no model).  The model is drawn on the device from
    ``seed`` (trainable for the train shape), unless ``model`` (built for
    the same arch on the same device) is passed, so that cells of several
    shapes share one copy of the weights; a frozen one is refused for the
    train shape.  The train cell's optimizer is
    ``make_optimizer(cfg.optimizer)`` at ``lr`` (the JAX cell's 1e-4),
    its state zero.  A cell of fewer sequences is a bundle of
    ``dataclasses.replace(shape, global_batch=...)``."""
    cfg, shape = bundle.arch, bundle.shapes[shape_name]
    if not isinstance(cfg, LMArch):
        raise TypeError(f"not an LM arch: {type(cfg).__name__}")
    meta = lm_static_meta(cfg, shape)
    name = f"{cfg.name}:{shape.name}"
    if device is not None and torch.device(device).type == "meta":
        return LMCell(name=name, fn=None, model=None, static_meta=meta, shape=shape)
    dev = resolve_device(device)
    train = shape.kind == "train"
    if model is None:
        model = tf.TransformerLM(cfg, device=dev, trainable=train,
                                 generator=torch.Generator(device=dev).manual_seed(seed))
    elif model.cfg != cfg or model.device.type != dev.type or dev.index not in (
            None, model.device.index):
        raise ValueError(f"the model was built for {model.cfg.name} on {model.device}, "
                         f"not {cfg.name} on {dev}")
    elif train and not model.trainable:
        raise ValueError(f"{name}: the model is frozen (a serving model); the train cell "
                         f"needs one built with trainable=True")
    b, s = shape.global_batch, shape.seq_len

    def tokens_of(batch: dict, want: tuple[int, ...]) -> torch.Tensor:
        t = torch.as_tensor(batch["tokens"], device=dev)
        if tuple(t.shape) != want or t.dtype != torch.int32:
            raise ValueError(f"{name}: tokens must be torch.int32 {want}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        return t

    optimizer = None
    if train:
        optimizer = make_optimizer(cfg.optimizer, model.parameters(), lr)

        def fn(batch):
            loss, metrics = tf.lm_loss(model, tokens_of(batch, (b, s)))
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
    elif shape.kind == "prefill":
        def fn(batch):
            return model.prefill(tokens_of(batch, (b, s)))
    else:
        def fn(cache, batch):
            if tuple(cache["k"].shape[1:3]) != (b, s):
                raise ValueError(f"{name}: the cache must hold [{b}, {s}] positions, got "
                                 f"{tuple(cache['k'].shape[1:3])}")
            return model.decode_step(cache, tokens_of(batch, (b,)), int(batch["pos"]))
    return LMCell(name=name, fn=fn, model=model, static_meta=meta, shape=shape,
                  optimizer=optimizer)


# ------------------------------------------------------------------- DLRM
def _pairs(dims: tuple[int, ...]):
    return zip(dims[:-1], dims[1:])


def dlrm_n_params(cfg: DLRMArch) -> int:
    """Parameter count (tables, MLP weights and biases), from the shapes."""
    n = cfg.n_sparse * cfg.rows_per_table * cfg.embed_dim
    for dims in ((cfg.n_dense,) + cfg.bot_mlp, (interaction_dims(cfg),) + cfg.top_mlp):
        n += sum(a * b + b for a, b in _pairs(dims))
    return n


def dlrm_model_flops(cfg: DLRMArch, shape: DLRMShape) -> float:
    """MLP + interaction FLOP of one cell call (3× for a train step, plus
    the candidate scoring for retrieval), as the JAX cell's ``static_meta``."""
    f = cfg.n_sparse + 1
    per_example = sum(2 * a * b for a, b in _pairs((cfg.n_dense,) + cfg.bot_mlp))
    per_example += 2 * f * f * cfg.embed_dim
    per_example += sum(2 * a * b for a, b in _pairs((interaction_dims(cfg),) + cfg.top_mlp))
    b = shape.batch
    if shape.kind == "train":
        return 3.0 * b * per_example
    if shape.kind == "retrieval":
        return b * per_example + 2.0 * b * shape.n_candidates * cfg.embed_dim
    return 1.0 * b * per_example


def make_optimizer(name: str, params, lr=1e-4) -> torch.optim.Optimizer:
    """The JAX cells' ``_make_optimizer``: Adafactor for ``"adafactor"``,
    else AdamW, over ``params``."""
    return adafactor(params, lr) if name == "adafactor" else adamw(params, lr)


@dataclasses.dataclass
class DLRMCell:
    name: str
    fn: Callable  # batch dict -> outputs on the device
    model: DLRM
    static_meta: dict
    optimizer: torch.optim.Optimizer | None = None  #: the train cell's

    def _named(self) -> dict:
        if self.optimizer is None:
            raise ValueError(f"{self.name} is not a train cell: it has no train state")
        return dict(self.model.named_parameters())

    def train_state(self) -> dict:
        """``{"params": ..., "opt": ...}`` in the JAX package's layout and
        keys (``interop.dlrm_params_to_jax``, ``optimizer_state_to_jax``):
        views of the live state (the step a fresh i32 0-d tensor), which a
        ``Checkpointer`` copies to the host when it saves."""
        named = self._named()
        return {"params": dlrm_params_to_jax(named),
                "opt": optimizer_state_to_jax(self.optimizer, named)}

    def load_train_state(self, state: dict) -> None:
        """Copy a train state in the JAX package's layout (numpy arrays or
        tensors, e.g. a restored checkpoint) into the model and the
        optimizer, in place."""
        named = self._named()
        assign_jax_layout(dlrm_params_to_jax(named), state["params"])
        optimizer_state_from_jax(self.optimizer, named, state["opt"])


def build_dlrm_cell(bundle: ArchBundle, shape_name: str, device=None, seed: int = 0,
                    model: DLRM | None = None) -> DLRMCell:
    """The ``train``, ``serve`` or ``retrieval`` cell of a DLRM arch on
    one device (``device=None``: the card, raising without one).  The
    model's parameters are created on the device from a generator there
    seeded with ``seed``, unless ``model`` (built for the same arch on the
    same device) is passed: cells of several shapes then share one set of
    tables, as one server holds one copy.  A serve or retrieval cell that
    builds its model freezes it (no autograd state on the tables; its
    callable runs under ``inference_mode``); the train cell's model is
    trainable, with ``adamw(1e-3)`` over it, its state zero.  Train
    batches carry ``labels`` f32 [B]; retrieval batches ``candidates``
    [Nc', D], Nc' the shape's candidate count padded to a multiple of
    512.  A cell with fewer rows per table is a bundle of
    ``dataclasses.replace(arch, rows_per_table=...)``."""
    cfg, shape = bundle.arch, bundle.shapes[shape_name]
    if not isinstance(cfg, DLRMArch):
        raise TypeError(f"not a DLRM arch: {type(cfg).__name__}")
    if shape.kind not in ("train", "serve", "retrieval"):
        raise ValueError(f"unknown DLRM shape kind {shape.kind!r}")
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = DLRM(cfg, device=dev, generator=gen)
        if shape.kind != "train":
            model.requires_grad_(False)
    else:
        here = model.tables.device
        if model.cfg != cfg or here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"the model was built for {model.cfg.name} on {here}, "
                             f"not {cfg.name} on {dev}")
    model.train(shape.kind == "train")
    b = shape.batch
    want = {"dense": ((b, cfg.n_dense), torch.float32),
            "sparse": ((b, cfg.n_sparse, cfg.hot_size), torch.int32)}
    if shape.kind == "train":
        want["labels"] = ((b,), torch.float32)
    if shape.kind == "retrieval":
        want["candidates"] = ((pad_mult(shape.n_candidates), cfg.embed_dim), torch.float32)

    def to_device(batch: dict) -> dict:
        out = {}
        for key, (shp, dtype) in want.items():
            t = torch.as_tensor(batch[key], device=dev)
            if tuple(t.shape) != shp or t.dtype != dtype:
                raise ValueError(f"{cfg.name}:{shape.name}: {key} must be {dtype} {shp}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            out[key] = t
        return out

    optimizer = None
    if shape.kind == "train":
        optimizer = make_optimizer("adamw", model.parameters(), 1e-3)

        def fn(batch):
            loss, metrics = dlrm_loss(model, to_device(batch))
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
    elif shape.kind == "retrieval":
        @torch.inference_mode()
        def fn(batch):
            return retrieval_scores(model, to_device(batch), top_k=RETRIEVAL_TOP_K)
    else:
        @torch.inference_mode()
        def fn(batch):
            batch = to_device(batch)
            logit, _ = model(batch["dense"], batch["sparse"])
            return torch.sigmoid(logit)

    return DLRMCell(
        name=f"{cfg.name}:{shape.name}",
        fn=fn,
        model=model,
        static_meta={"n_params": dlrm_n_params(cfg), "model_flops": dlrm_model_flops(cfg, shape)},
        optimizer=optimizer,
    )


# -------------------------------------------------------------------- GNN
def gnn_workload(shape) -> tuple[int, int]:
    """(nodes, arcs) of one step of a GNN shape: the sampled block's for a
    minibatch shape, all the graphs' for a batched one."""
    if shape.kind == "minibatch":
        t = shape.batch_nodes
        n_nodes, n_edges, frontier = t, 0, t
        for f in shape.fanout:
            n_edges += frontier * f
            frontier *= f
            n_nodes += frontier
    else:
        n_nodes = shape.n_nodes * (shape.n_graphs or 1)
        n_edges = shape.n_edges * (shape.n_graphs or 1)
    return n_nodes, n_edges


def gnn_layout(shape, R: int, C: int) -> tuple[int, int]:
    """(chunk, max_arcs) of a GNN shape on an R × C grid, the JAX cell's:
    ceil(nodes / p) and 1.5 · arcs / p + 8 arc slots (imbalance headroom)
    rounded up to a multiple of 8."""
    n_nodes, n_edges = gnn_workload(shape)
    p = R * C
    max_arcs = int(1.5 * n_edges / p) + 8
    return -(-n_nodes // p), max_arcs + (-max_arcs) % 8


def gnn_static_meta(cfg: GNNArch, shape) -> dict:
    """The JAX GNN cell's ``static_meta``, from the shapes alone: the
    parameter count and the model FLOP of a step — a message MLP (2d→d,
    d→d) per arc and an update MLP per node a layer, plus the encoder,
    3× for forward and backward (GIN has no message MLP: the count is the
    reference's, not GIN's work)."""
    d_out = gnn_mod.output_dim(cfg, shape)
    n_nodes, n_edges = gnn_workload(shape)
    d = gnn_mod.hidden_dim(cfg)
    per_layer = 2 * n_edges * (2 * d) * d + 2 * n_edges * d * d
    per_layer += 2 * n_nodes * (2 * d) * d + 2 * n_nodes * d * d
    return {
        "n_params": gnn_mod.n_params(cfg, shape.d_feat, d_out),
        "model_flops": 3.0 * (cfg.n_layers * per_layer + 2 * n_nodes * shape.d_feat * d),
        "n_nodes": n_nodes,
        "n_edges": n_edges,
    }


@dataclasses.dataclass
class GNNCell:
    """One GNN train step of a shape on a grid: ``fn(batch=None)`` takes an
    AdamW step on the rank's part of a 2-D batch (the cell's own when
    None) and returns ``{"loss": f32 0-d}``, the loss before the step.
    Without a grid (meta only) everything but the meta is None."""

    name: str
    fn: Callable | None
    static_meta: dict
    params: dict | None = None  #: {dotted name: tensor}, models/gnn.py's layout
    optimizer: torch.optim.Optimizer | None = None
    batch: dict | None = None  #: the rank's part of the cell's 2-D batch, on the device
    loss_fn: Callable | None = None  #: loss_fn(params, batch), make_gnn2d_loss_fn's
    chunk: int = 0
    max_arcs: int = 0
    setup: dict = dataclasses.field(default_factory=dict)  #: host seconds and sizes


#: the GNN kinds that pass messages on meshes (bounded degree): their cells'
#: graphs are ``sized_mesh_graph``, the others' ``sized_rmat_graph``
MESH_KINDS = ("graphcast", "meshgraphnet")


def gnn_cell_batch(cfg: GNNArch, shape, seed: int = 0, setup: dict | None = None) -> dict:
    """The GNN cell's flat batch of ``shape`` (models/gnn.py's format,
    numpy, padded to :func:`gnn_workload`) from ``seed``; ``setup``, when
    given, takes the host seconds and the graph's sizes."""
    setup = {} if setup is None else setup
    n_nodes, n_edges = gnn_workload(shape)
    d_out = gnn_mod.output_dim(cfg, shape)
    t = time.perf_counter()
    if shape.kind == "batched_graphs":
        batch = molecule_batch(cfg, shape.n_graphs, shape.n_nodes, shape.n_edges, n_nodes,
                               n_edges, shape.d_feat, d_out, shape.n_classes, seed=seed)
        setup["graph_s"] = 0.0
        setup["batch_s"] = time.perf_counter() - t
        return batch
    make = sized_mesh_graph if cfg.kind in MESH_KINDS else sized_rmat_graph
    graph = make(shape.n_nodes, shape.n_edges, seed=seed)
    setup["graph_s"] = time.perf_counter() - t
    setup["graph_n"], setup["graph_arcs"] = graph.n, graph.num_arcs
    degrees = graph.degrees()
    setup["max_degree"], setup["isolated"] = int(degrees.max()), int((degrees == 0).sum())
    del degrees
    t = time.perf_counter()
    if shape.kind == "minibatch":
        features = synth_features(graph.n, shape.d_feat, seed)
        sampler = NeighborSampler(graph, shape.fanout, seed=seed)
        targets = np.random.default_rng(seed).choice(graph.n, shape.batch_nodes, replace=False)
        batch = minibatch_batch(cfg, graph, features, sampler, targets, n_nodes, n_edges,
                                shape.n_classes, seed=seed)
    else:
        batch = full_graph_batch(cfg, graph, n_nodes, n_edges, shape.d_feat, d_out,
                                 shape.n_classes, seed=seed)
    setup["batch_s"] = time.perf_counter() - t
    return batch


def build_gnn_cell(bundle: ArchBundle, shape_name: str, groups: GridGroups, *, device=None,
                   seed: int = 0) -> GNNCell:
    """The GNN train cell of ``shape_name`` on the caller's R × C grid
    (fr = 1; every rank calls it, as every rank builds the groups): the
    shape's flat batch from ``seed`` on the host, ``to_2d_batch`` onto the
    grid at the JAX cell's layout (:func:`gnn_layout`), the rank's part
    on ``device`` (None: the card; ``"cpu"`` for gloo ranks; index arrays
    int32, the dtype ``index_select`` / ``index_add`` take), the
    parameters drawn there from a generator seeded with ``seed`` (equal
    on every rank of one device type), bf16 expand and fold payloads and
    ``adamw(1e-3)``, as the JAX cell.  ``setup`` records the host seconds
    of each step apart (``graph_s``, ``batch_s``, ``partition_s``,
    ``device_s``) and the sizes."""
    cfg, shape = bundle.arch, bundle.shapes[shape_name]
    if not isinstance(cfg, GNNArch):
        raise TypeError(f"not a GNN arch: {type(cfg).__name__}")
    if groups.fr != 1:
        raise ValueError(f"a GNN cell runs on an R x C grid, not {groups.fr} replicas")
    dev = device_for_rank(device)
    chunk, max_arcs = gnn_layout(shape, groups.R, groups.C)
    setup = {}
    batch = gnn_cell_batch(cfg, shape, seed, setup)
    t = time.perf_counter()
    b2d = to_2d_batch(batch, batch["node_feat"].shape[0], groups.R, groups.C, max_arcs=max_arcs)
    del batch
    setup["partition_s"] = time.perf_counter() - t
    setup["real_arcs"] = int((b2d["dst_local"] < groups.C * chunk).sum())
    t = time.perf_counter()
    local = gnn2d_local_batch(b2d, groups, dev)
    del b2d
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = gnn_mod.init_params(cfg, shape.d_feat, gnn_mod.output_dim(cfg, shape), gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["device_s"] = time.perf_counter() - t
    optimizer = adamw(params.values(), 1e-3)
    loss_fn = make_gnn2d_loss_fn(cfg, groups, shape.kind, chunk=chunk, max_arcs=max_arcs,
                                 n_graphs=shape.n_graphs or 0, gather_dtype=torch.bfloat16,
                                 fold_dtype=torch.bfloat16)

    def fn(batch: dict | None = None) -> dict:
        loss = loss_fn(params, local if batch is None else batch)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return GNNCell(name=f"{cfg.name}:{shape.name}", fn=fn,
                   static_meta=gnn_static_meta(cfg, shape), params=params, optimizer=optimizer,
                   batch=local, loss_fn=loss_fn, chunk=chunk, max_arcs=max_arcs, setup=setup)


# --------------------------------------------------------------------- BC
#: the engines whose per-device footprint a BC cell's meta prices: the
#: port's names of the JAX cell's "sparse", "pallas" and "pallas_sparse"
_FOOTPRINT_ENGINES = ("sparse", "fused", "fused_sparse")


def bc_static_meta(cfg: BCArch, shape: BCShape, fr: int = 1, R: int = 1, C: int = 1) -> dict:
    """The BC cell's meta on an fr × R × C grid, from the shapes alone (no
    graph is made), with the JAX cell's keys and formulas: n = 2^scale,
    m2 = 2·EF·n arcs, s + k sources a round (k = max(1, s // 2) derived
    columns), model FLOP 2·(m2/2)·(s + k)·2·fr (one traversed-edge update
    per column, forward and backward, per replica), the per-device
    footprint of each engine of :data:`_FOOTPRINT_ENGINES` at
    max_arcs = 1.5·m2/(R·C) padded to 8 and the default tile (nonzero
    tiles bounded by one per arc), the autotune cache's report (read
    only; the path from ``AUTOTUNE_CACHE_JSON``, default
    ``AUTOTUNE_cache.json``) and the resilience defaults."""
    n = 1 << shape.scale
    chunk = -(-n // (R * C))
    m2 = 2 * shape.edge_factor * n
    max_arcs = int(1.5 * m2 / (R * C))  # imbalance headroom
    max_arcs += (-max_arcs) % 8
    tile = default_tile_dim(chunk)
    tiles_per_dev = (C * chunk // tile) * (R * chunk // tile)
    footprints = {
        kind: device_hbm_footprint(
            kind, R=R, C=C, chunk=chunk, batch_size=cfg.batch_size,
            nnz_tiles=min(max_arcs, tiles_per_dev), bm=tile, bk=tile, max_arcs=max_arcs,
        )["total_bytes"]
        for kind in _FOOTPRINT_ENGINES
    }
    cache_path = os.environ.get("AUTOTUNE_CACHE_JSON", "AUTOTUNE_cache.json")
    tune_cache = CostCache(cache_path) if os.path.exists(cache_path) else None
    gkey = graph_key(n, m2, R=R, C=C, fr=fr)
    s, k = cfg.batch_size, max(1, cfg.batch_size // 2)
    return {
        "n_vertices": n,
        "n_arcs": m2,
        "sources_per_round": s + k,
        "model_flops": 2.0 * (m2 / 2) * (s + k) * 2 * fr,
        "hbm_footprint_bytes": footprints,
        "tune": {
            "graph_key": gkey,
            "modes": list(AUTOTUNE_MODES),
            "cache_path": cache_path if tune_cache is not None else None,
            "cached_configs": (
                len(tune_cache.entries.get(gkey, {})) if tune_cache is not None else 0
            ),
        },
        "resilience": {
            "max_retries": DEFAULT_MAX_RETRIES,
            "retry_backoff_s": DEFAULT_RETRY_BACKOFF_S,
            "checkpoint_generations": DEFAULT_GENERATIONS,
            "remesh_on_replica_loss": fr > 1,
            "fault_kinds": list(FAULT_KINDS),
        },
    }


@dataclasses.dataclass
class BCCell:
    """One BC round of a shape on a grid.  ``fn(sources, derived, *,
    num_levels=cfg.max_levels)`` runs it (``num_levels=None``: the
    liveness loop) and returns :func:`make_distributed_round_fn`'s outputs
    (bc f32 [fr, n_pad], ns, roots, levels), gathered to every rank.
    Without a grid (meta only) ``fn`` and the host state are None."""

    name: str
    fn: Callable | None
    static_meta: dict
    fr: int = 1  #: replicas: rounds a dispatch block
    schedule: Schedule | None = None
    residual: Graph | None = None  #: the graph the round traverses
    omega: np.ndarray | None = None  #: f64 [n] 1-degree weights of the residual
    partition: TwoDPartition | None = None
    setup: dict = dataclasses.field(default_factory=dict)  #: host seconds and sizes

    def round_inputs(self, block: int) -> tuple[np.ndarray, np.ndarray]:
        """(sources i32 [fr, s], derived i32 [fr, k, 3]) of dispatch block
        ``block``: rounds fr·block … fr·block + fr − 1 of the schedule, a
        replica each (all padding past the last round)."""
        fr = self.fr
        rounds = self.schedule.rounds[fr * block:fr * (block + 1)]
        s, k = self.schedule.batch_size, self.schedule.derived_per_round
        sources = np.full((fr, s), -1, np.int32)
        derived = np.full((fr, k, 3), -1, np.int32)
        for f, rnd in enumerate(rounds):
            sources[f], derived[f] = rnd.sources, rnd.derived
        return sources, derived


def build_bc_cell(bundle: ArchBundle, shape_name: str, groups: GridGroups, *, device=None,
                  seed: int = 0) -> BCCell:
    """The BC cell of ``shape_name`` on the caller's grid (every rank calls
    it, as every rank builds the groups): ``rmat_graph(scale, EF, seed)``
    on the host, its schedule under the arch's heuristics and batch (the
    residual and ω), ``partition_2d`` of the residual on the grid, and the
    rank's arc arrays and ω on ``device`` (None: the card; ``"cpu"`` for
    gloo ranks).  ``setup`` records the host seconds of each step apart
    (``rmat_s``, ``schedule_s``, ``partition_s``, ``device_s``) and the
    graph's size."""
    cfg, shape = bundle.arch, bundle.shapes[shape_name]
    if not isinstance(cfg, BCArch):
        raise TypeError(f"not a BC arch: {type(cfg).__name__}")
    dev = device_for_rank(device)
    setup = {}
    t = time.perf_counter()
    graph = rmat_graph(shape.scale, shape.edge_factor, seed=seed)
    setup["rmat_s"] = time.perf_counter() - t
    setup["n"], setup["arcs"] = graph.n, graph.num_arcs
    t = time.perf_counter()
    schedule, _, residual, omega = build_schedule(graph, batch_size=cfg.batch_size,
                                                  heuristics=cfg.heuristics)
    setup["schedule_s"] = time.perf_counter() - t
    setup["residual_arcs"], setup["rounds"] = residual.num_arcs, len(schedule.rounds)
    del graph
    t = time.perf_counter()
    part = partition_2d(residual, groups.R, groups.C)
    setup["partition_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph_args = distributed_graph_arrays(part, "sparse", groups.i, groups.j, dev)
    omega_pad = np.zeros(part.n_pad, np.float32)
    omega_pad[: residual.n] = omega
    omega_t = torch.from_numpy(omega_pad).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup["device_s"] = time.perf_counter() - t
    fr, s, k = groups.fr, schedule.batch_size, schedule.derived_per_round
    round_fns = {}

    def fn(sources, derived, *, num_levels: int | None = cfg.max_levels):
        sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
        derived = torch.as_tensor(derived, dtype=torch.int32, device=dev)
        if tuple(sources.shape) != (fr, s) or tuple(derived.shape) != (fr, k, 3):
            raise ValueError(f"{cfg.name}:{shape.name}: sources must be [{fr}, {s}] and derived "
                             f"[{fr}, {k}, 3], got {tuple(sources.shape)} and "
                             f"{tuple(derived.shape)}")
        if num_levels not in round_fns:
            round_fns[num_levels] = make_distributed_round_fn(part, groups,
                                                              num_levels=num_levels)
        return round_fns[num_levels](graph_args, omega_t, sources, derived)

    return BCCell(name=f"{cfg.name}:{shape.name}", fn=fn,
                  static_meta=bc_static_meta(cfg, shape, fr, groups.R, groups.C), fr=fr,
                  schedule=schedule, residual=residual, omega=omega, partition=part,
                  setup=setup)


def build_cell(bundle: ArchBundle, shape_name: str, groups: GridGroups | None = None, *,
               grid: tuple[int, int, int] = (1, 1, 1), **kwargs):
    """The cell of an (arch × shape) pair, the counterpart of the JAX
    package's ``build_cell``.  LM: :func:`build_lm_cell` (``kwargs``:
    device — ``"meta"`` for the meta alone —, seed, model, lr).  DLRM:
    :func:`build_dlrm_cell` (``kwargs``: device, seed, model).  BC: with ``groups``, the runnable round on that
    grid (:func:`build_bc_cell`; ``kwargs``: device, seed); without, only
    the meta on ``grid`` = (fr, R, C), which takes the place of the JAX
    mesh (:func:`bc_static_meta`; no graph is made).  GNN: with ``groups``,
    the runnable train step on that grid (:func:`build_gnn_cell`;
    ``kwargs``: device, seed); without, only the meta
    (:func:`gnn_static_meta`, which the grid does not change)."""
    arch = bundle.arch
    if isinstance(arch, LMArch):
        return build_lm_cell(bundle, shape_name, **kwargs)
    if isinstance(arch, DLRMArch):
        return build_dlrm_cell(bundle, shape_name, **kwargs)
    if isinstance(arch, BCArch):
        if groups is not None:
            return build_bc_cell(bundle, shape_name, groups, **kwargs)
        shape = bundle.shapes[shape_name]
        return BCCell(name=f"{arch.name}:{shape.name}", fn=None,
                      static_meta=bc_static_meta(arch, shape, *grid), fr=grid[0])
    if isinstance(arch, GNNArch):
        if groups is not None:
            return build_gnn_cell(bundle, shape_name, groups, **kwargs)
        shape = bundle.shapes[shape_name]
        return GNNCell(name=f"{arch.name}:{shape.name}", fn=None,
                       static_meta=gnn_static_meta(arch, shape))
    raise TypeError(f"no cell for arch {type(arch).__name__}")
