"""Decoder-only transformer LM (dense or MoE) of the port: prefill and
decode against a KV cache.

The JAX package's ``models/transformer.py`` (its serving half) as an
``nn.Module``.  Parameters keep the reference's layout and dtypes
(``x @ W`` with W [in, out]; weights bf16, norms and the router f32), one
:class:`DecoderLayer` per layer where the reference stacks them on a
leading L axis (``interop.lm_params_from_jax`` maps one onto the other).
The KV cache is the reference's: ``{"k", "v"}`` each bf16 [L, B, S_max,
K, hd], allocated once at ``S_max``; prefill writes positions [0, S)
and every decode step writes its one position in place, layer by layer
(the reference's ``dynamic_update_slice``).  Logits are ``x @ embed.T``
in bf16 cast to f32 over the padded vocab, pad ids included, as the
reference computes them.

On the card a decode step is captured once as a CUDA graph and replayed
(the counterpart of the reference's ``jax.jit`` of its decode step, which
runs as one compiled program): run op by op, the step's ~130 torch ops a
layer leave the card idle while the host issues them.  The replay runs
the same kernels on the same buffers, so its results are the eager
step's, bit for bit.

The reference's logical sharding (``param_partition_specs``,
``distributed.sharding.constrain``) has no counterpart on one card.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import LMArch
from . import attention as attn
from .layers import ACTIVATIONS, apply_rope, dense_init_, rms_norm, rope_frequencies, rope_tables
from .moe import moe_ffn

__all__ = ["padded_vocab", "layer_shapes", "param_specs", "cache_specs", "n_params",
           "DecoderLayer", "TransformerLM"]


def padded_vocab(cfg: LMArch) -> int:
    """Vocab rounded up to a multiple of 256 (the reference pads it so the
    embedding shards on any mesh axis; pad ids are never in a prompt)."""
    return cfg.vocab + (-cfg.vocab) % 256


def layer_shapes(cfg: LMArch) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of one layer's parameters (the reference's
    ``_layer_shapes`` without its leading L)."""
    d, hhd, khd = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {
        "ln1": ((d,), torch.float32),
        "ln2": ((d,), torch.float32),
        "wq": ((d, hhd), torch.bfloat16),
        "wk": ((d, khd), torch.bfloat16),
        "wv": ((d, khd), torch.bfloat16),
        "wo": ((hhd, d), torch.bfloat16),
    }
    if cfg.moe is None:
        shapes["wi"] = ((d, 2 * cfg.d_ff), torch.bfloat16)
        shapes["wo_mlp"] = ((cfg.d_ff, d), torch.bfloat16)
    else:
        m = cfg.moe
        shapes["router"] = ((d, m.num_experts), torch.float32)
        shapes["wi_e"] = ((m.num_experts, d, 2 * m.d_ff), torch.bfloat16)
        shapes["wo_e"] = ((m.num_experts, m.d_ff, d), torch.bfloat16)
    return shapes


def param_specs(cfg: LMArch) -> dict:
    """The reference's ``param_specs`` as (shape, dtype) pairs, stacked
    layers included: nothing is allocated."""
    L = cfg.n_layers
    return {
        "embed": ((padded_vocab(cfg), cfg.d_model), torch.bfloat16),
        "ln_f": ((cfg.d_model,), torch.float32),
        "layers": {k: ((L,) + shape, dt) for k, (shape, dt) in layer_shapes(cfg).items()},
    }


def cache_specs(cfg: LMArch, batch: int, max_seq: int) -> dict:
    """(shape, dtype) of the cache's k and v: bf16 [L, B, S_max, K, hd]."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def n_params(cfg: LMArch) -> int:
    """Parameter count, from the shapes."""
    specs = param_specs(cfg)
    leaves = [specs["embed"], specs["ln_f"], *specs["layers"].values()]
    return sum(math.prod(shape) for shape, _ in leaves)


class DecoderLayer(nn.Module):
    """One layer's parameters (names as the reference's stacked leaves)."""

    def __init__(self, cfg: LMArch, device: torch.device):
        super().__init__()
        for name, (shape, dt) in layer_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=dt, device=device)))


class TransformerLM(nn.Module):
    """Decoder-only LM on ``device``.  With a ``generator`` (on that
    device) the parameters are drawn as the reference's ``init_params``
    draws them, from other random numbers: each weight fan-in truncated
    normal with fan-in its second-to-last axis, the embedding's fan-in
    d_model, the norms zero.  Each weight is drawn in f32 on the device,
    one at a time, then cast: a stacked f32 copy of a 7B model would not
    fit beside it.  Without one they are left unset, for a caller that
    loads a state dict (``interop.lm_params_from_jax``).  State keys:
    ``embed``, ``ln_f``, ``layers.{i}.{name}``."""

    def __init__(self, cfg: LMArch, *, device: torch.device | str,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        self.embed = nn.Parameter(torch.empty((padded_vocab(cfg), cfg.d_model),
                                              dtype=torch.bfloat16, device=device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.register_buffer("rope_freq", rope_frequencies(cfg.head_dim, cfg.rope_theta)
                             .to(device), persistent=False)
        self.requires_grad_(False)  # serving: no autograd state
        self._graph: _DecodeGraph | None = None
        if generator is not None:
            self._draw(generator)

    @torch.no_grad()
    def _draw(self, generator: torch.Generator) -> None:
        def draw_(param: torch.Tensor, in_axis: int) -> None:
            f32 = torch.empty(param.shape, dtype=torch.float32, device=param.device)
            param.copy_(dense_init_(f32, generator, in_axis=in_axis))

        for layer in self.layers:
            for name, param in sorted(layer.named_parameters()):
                if name.startswith("ln"):
                    param.zero_()
                else:
                    draw_(param, -2)
        draw_(self.embed, 1)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def empty_cache(self, batch: int, max_seq: int) -> dict[str, torch.Tensor]:
        """A zero KV cache for ``batch`` sequences of up to ``max_seq`` tokens."""
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in cache_specs(self.cfg, batch, max_seq).items()}

    def _ffn(self, layer: DecoderLayer, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.moe is None:
            return ACTIVATIONS[cfg.activation](h @ layer.wi) @ layer.wo_mlp
        y, _ = moe_ffn(h.reshape(-1, cfg.d_model), layer.router, layer.wi_e, layer.wo_e,
                       top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                       activation=cfg.activation)
        return y.view(h.shape)

    def _qkv(self, layer: DecoderLayer, x: torch.Tensor, rot: tuple[torch.Tensor, torch.Tensor]):
        cfg = self.cfg
        b, s = x.shape[:2]
        h = rms_norm(x, layer.ln1)
        q = (h @ layer.wq).view(b, s, cfg.n_heads, cfg.head_dim)
        k = (h @ layer.wk).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ layer.wv).view(b, s, cfg.n_kv_heads, cfg.head_dim)
        return apply_rope(q, *rot), apply_rope(k, *rot), v

    def _rot(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The rotary tables at ``positions``, shared by every layer."""
        return rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta, self.rope_freq)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return (rms_norm(x, self.ln_f) @ self.embed.T).float()

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict[str, torch.Tensor] | None = None,
                max_seq: int | None = None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """tokens i32 [B, S] -> (logits f32 [B, V_padded] of the last
        position, cache).  The cache is ``cache`` (k and v [L, B, S_max,
        K, hd], S_max >= S), or a new one of ``max_seq`` (default S)
        positions; positions [0, S) are written in place."""
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            cache = self.empty_cache(b, s if max_seq is None else max_seq)
        x = self.embed[tokens.long()]
        rot = self._rot(torch.arange(s, device=tokens.device).expand(b, s))
        for l in range(cfg.n_layers):
            x = self.ffn_block(l, self.prefill_attention(l, x, cache, rot))
        return self._logits(x[:, -1]), cache

    @torch.no_grad()
    def prefill_attention(self, l: int, x: torch.Tensor, cache: dict[str, torch.Tensor],
                          rot: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        """The attention half of prefill layer ``l``: x + o(x) @ wo (``rot``:
        the rotary tables of positions [0, S), made here when not given)."""
        cfg = self.cfg
        layer = self.layers[l]
        b, s = x.shape[:2]
        if rot is None:
            rot = self._rot(torch.arange(s, device=x.device).expand(b, s))
        q, k, v = self._qkv(layer, x, rot)
        cache["k"][l, :, :s] = k
        cache["v"][l, :, :s] = v
        o = attn.causal_attention(q, k, v, q_chunk=cfg.q_chunk, window=cfg.attn_window)
        del q, k, v
        return x + o.reshape(b, s, -1) @ layer.wo

    @torch.no_grad()
    def ffn_block(self, l: int, x: torch.Tensor) -> torch.Tensor:
        """The FFN half of layer ``l`` (dense or MoE): x + ffn(rms_norm(x))."""
        layer = self.layers[l]
        return x + self._ffn(layer, rms_norm(x, layer.ln2))

    @torch.no_grad()
    def decode_step(self, cache: dict[str, torch.Tensor], tokens: torch.Tensor, pos,
                    graph: bool | None = None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One decode step: ``tokens`` [B] sit at position ``pos`` (an int
        or a 0-d tensor; the cache is valid for [0, pos) and gets their k
        and v at ``pos``, in place) -> (logits f32 [B, V_padded], the same
        cache).  ``graph`` (default: on the card) replays the step's CUDA
        graph, captured at the first call on this cache; ``graph=False``
        runs it op by op."""
        dev = self.device
        if not (dev.type == "cuda" if graph is None else graph):
            pos_t = pos.to(dev).long().reshape(()) if isinstance(pos, torch.Tensor) else \
                torch.full((), int(pos), dtype=torch.long, device=dev)
            return self._decode(cache, tokens, pos_t), cache
        if self._graph is None or not self._graph.fits(cache, tokens):
            self._graph = None  # release the old graph's memory pool first
            self._graph = _DecodeGraph(self, cache, tokens, pos)
        return self._graph.replay(tokens, pos), cache

    def _decode(self, cache: dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
        """The decode step at ``pos`` (0-d i64 on the device): no host sync,
        so that it can be captured."""
        cfg = self.cfg
        b = tokens.shape[0]
        rot = self._rot(pos.expand(b, 1))
        at = pos.view(1)
        x = self.embed[tokens.long()]  # [B, d]
        for l, layer in enumerate(self.layers):
            q, k, v = self._qkv(layer, x[:, None], rot)
            cache["k"][l].index_copy_(1, at, k)
            cache["v"][l].index_copy_(1, at, v)
            o = attn.decode_attention(q[:, 0], cache["k"][l], cache["v"][l], pos,
                                      window=cfg.attn_window)
            x = self.ffn_block(l, x + o.reshape(b, -1) @ layer.wo)
        return self._logits(x)


class _DecodeGraph:
    """One decode step of ``model`` on one cache, captured as a CUDA graph:
    the tokens and the position are copied into static buffers, the graph
    is replayed, and the logits are copied out of its static output."""

    def __init__(self, model: TransformerLM, cache: dict[str, torch.Tensor],
                 tokens: torch.Tensor, pos):
        self.key = self._key(cache, tokens)
        dev = model.device
        self.tokens = torch.empty(tokens.shape, dtype=torch.long, device=dev)
        self.pos = torch.empty((), dtype=torch.long, device=dev)
        self._load(tokens, pos)
        # one eager step on a side stream first (cuBLAS handles and
        # workspaces); it writes the same k and v at pos as the replay will
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model._decode(cache, self.tokens, self.pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = model._decode(cache, self.tokens, self.pos)

    @staticmethod
    def _key(cache, tokens) -> tuple:
        return (cache["k"].data_ptr(), cache["v"].data_ptr(), tuple(cache["k"].shape),
                tuple(tokens.shape))

    def fits(self, cache, tokens) -> bool:
        return self._key(cache, tokens) == self.key

    def _load(self, tokens: torch.Tensor, pos) -> None:
        self.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos.reshape(()))
        else:
            self.pos.fill_(int(pos))

    def replay(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        self._load(tokens, pos)
        self.graph.replay()
        return self.logits.clone()
