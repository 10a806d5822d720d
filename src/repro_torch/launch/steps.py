"""Cell programs of the port: (arch × shape) -> a callable.

The counterpart of the JAX package's ``launch/steps.py`` for the archs
the port has: the LMs' serving shapes (``_build_lm_cell`` there), DLRM
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
from ..configs.base import BCArch, BCShape, DLRMArch, DLRMShape, LMArch
from ..configs.registry import ArchBundle
from ..core.distributed import distributed_graph_arrays, make_distributed_round_fn
from ..core.driver import DEFAULT_MAX_RETRIES, DEFAULT_RETRY_BACKOFF_S
from ..core.scheduler import Schedule, build_schedule
from ..device import resolve_device
from ..distributed.chaos import FAULT_KINDS
from ..distributed.groups import GridGroups, device_for_rank
from ..graphs.generators import rmat_graph
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
from ..models import transformer as tf
from ..models.dlrm import DLRM, dlrm_loss, interaction_dims, retrieval_scores
from ..optim import adafactor, adamw
from ..roofline.model import device_hbm_footprint

__all__ = ["LMCell", "build_lm_cell", "lm_model_flops", "lm_analytic_bytes", "lm_static_meta",
           "DLRMCell", "build_dlrm_cell", "dlrm_model_flops", "dlrm_n_params", "pad_mult",
           "make_optimizer",
           "RETRIEVAL_TOP_K", "BCCell", "build_bc_cell", "bc_static_meta", "build_cell"]

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
    mesh (:func:`bc_static_meta`; no graph is made)."""
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
    raise TypeError(f"no cell for arch {type(arch).__name__}")
