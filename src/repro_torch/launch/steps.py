"""Cell programs of the port: (arch × shape) -> a callable on one device.

The counterpart of the JAX package's ``launch/steps.py`` for the archs
the port has (so far DLRM, ``_build_dlrm_cell`` there).  A cell owns its
model, created on the device from a seeded generator, and a callable
that takes one batch of numpy arrays (or tensors), moves it to the
device and returns the outputs there:

  serve      -> sigmoid(logit) f32 [B]
  retrieval  -> (scores [B, 100], candidate ids [B, 100])

``static_meta`` holds ``n_params`` and ``model_flops``, computed as the
JAX cell computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import DLRMArch, DLRMShape
from ..configs.registry import ArchBundle
from ..device import resolve_device
from ..models.dlrm import DLRM, interaction_dims, retrieval_scores

__all__ = ["DLRMCell", "build_dlrm_cell", "dlrm_model_flops", "dlrm_n_params", "pad_mult",
           "RETRIEVAL_TOP_K"]

RETRIEVAL_TOP_K = 100
DEV_MULT = 512  # the JAX cells pad the candidate count to this multiple


def pad_mult(x: int, m: int = DEV_MULT) -> int:
    """``x`` rounded up to a multiple of ``m`` (the retrieval candidates)."""
    return x + (-x) % m


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


@dataclasses.dataclass
class DLRMCell:
    name: str
    fn: Callable  # batch dict -> outputs on the device
    model: DLRM
    static_meta: dict


def build_dlrm_cell(bundle: ArchBundle, shape_name: str, device=None, seed: int = 0,
                    model: DLRM | None = None) -> DLRMCell:
    """The ``serve`` or ``retrieval`` cell of a DLRM arch on one device
    (``device=None``: the card, raising without one).  The model's
    parameters are created on the device from a generator there seeded
    with ``seed``, unless ``model`` (built for the same arch on the same
    device) is passed: cells of several shapes then share one set of
    tables, as one server holds one copy.  Retrieval batches carry
    ``candidates`` [Nc', D], Nc' the shape's candidate count padded to a
    multiple of 512."""
    cfg, shape = bundle.arch, bundle.shapes[shape_name]
    if not isinstance(cfg, DLRMArch):
        raise TypeError(f"not a DLRM arch: {type(cfg).__name__}")
    if shape.kind == "train":
        raise NotImplementedError(
            "the DLRM train cell waits for the optimizer's port (ROADMAP Queue 1 item 12)"
        )
    if shape.kind not in ("serve", "retrieval"):
        raise ValueError(f"unknown DLRM shape kind {shape.kind!r}")
    dev = resolve_device(device)
    if model is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = DLRM(cfg, device=dev, generator=gen)
    else:
        here = model.tables.device
        if model.cfg != cfg or here.type != dev.type or dev.index not in (None, here.index):
            raise ValueError(f"the model was built for {model.cfg.name} on {here}, "
                             f"not {cfg.name} on {dev}")
    model.eval()
    b = shape.batch
    want = {"dense": ((b, cfg.n_dense), torch.float32),
            "sparse": ((b, cfg.n_sparse, cfg.hot_size), torch.int32)}
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

    if shape.kind == "retrieval":
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
    )
