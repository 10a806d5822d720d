"""Decoder-only transformer LM (dense or MoE) of the port: prefill and
decode against a KV cache, and the training forward and loss.

The JAX package's ``models/transformer.py`` as an ``nn.Module``.
Parameters keep the reference's layout and dtypes (``x @ W`` with W [in,
out]; weights bf16, norms and the router f32), each layer leaf stacked on
a leading L axis as the reference stacks it (:class:`LayerStack`;
``interop.lm_params_from_jax`` maps one onto the other bit for bit).  So
the optimizer steps the reference's leaves: Adafactor factors ``ln1`` [L,
d] into [L] and [d] statistics and clips each layer's [E, d, 2ff] expert
slice as a whole, as the reference's ``_layerwise`` does.
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

Training (:func:`lm_loss`, the reference's ``_backbone`` and ``lm_loss``)
runs the prefill's layers under autograd, without a cache.  With
``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint(..., nothing_saveable)``): only the layer's
bf16 input is kept, the rest is recomputed in the backward; each loss
chunk likewise, so that no chunk's f32 logits outlive it.  A serving
model is frozen (no autograd state); ``trainable=True`` builds one whose
parameters take gradients.

The reference's logical sharding (``param_partition_specs``,
``distributed.sharding.constrain``) has no counterpart on one card.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMArch
from . import attention as attn
from .layers import ACTIVATIONS, apply_rope, dense_init_, rms_norm, rope_frequencies, rope_tables
from .moe import moe_ffn

__all__ = ["padded_vocab", "layer_shapes", "param_specs", "cache_specs", "n_params",
           "LayerStack", "TransformerLM", "lm_loss"]


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


class LayerStack(nn.Module):
    """The L layers' parameters, one per name of :func:`layer_shapes`, each
    stacked on a leading L axis (the reference's ``params["layers"]``).
    ``stack[l]`` is layer l: a namespace of the views ``leaf[l]``."""

    def __init__(self, cfg: LMArch, device: torch.device):
        super().__init__()
        self.n_layers = cfg.n_layers
        for name, (shape, dt) in layer_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty((cfg.n_layers,) + shape, dtype=dt, device=device)))

    def __len__(self) -> int:
        return self.n_layers

    def __getitem__(self, l: int) -> SimpleNamespace:
        return SimpleNamespace(**{name: p[l] for name, p in self.named_parameters()})

    def __iter__(self):
        return (self[l] for l in range(self.n_layers))

    def unbind(self) -> list[SimpleNamespace]:
        """Every layer at once, through one ``unbind`` a leaf: under
        autograd a leaf's gradient is then stacked once, by the unbind's
        backward (indexing layer by layer would add a zero [L, ...]
        gradient a layer)."""
        names = [name for name, _ in self.named_parameters()]
        views = zip(*(p.unbind(0) for _, p in self.named_parameters()))
        return [SimpleNamespace(**dict(zip(names, layer))) for layer in views]


class TransformerLM(nn.Module):
    """Decoder-only LM on ``device``.  With a ``generator`` (on that
    device) the parameters are drawn as the reference's ``init_params``
    draws them, from other random numbers: each weight fan-in truncated
    normal with fan-in its second-to-last axis, the embedding's fan-in
    d_model, the norms zero.  Each weight is drawn in f32 on the device,
    one layer at a time, then cast: a stacked f32 copy of a 7B model would
    not fit beside it.  Without one they are left unset, for a caller that
    loads a state dict (``interop.lm_params_from_jax``).  State keys:
    ``embed``, ``ln_f``, ``layers.{name}`` (stacked [L, ...]).  The model
    is frozen unless ``trainable``."""

    def __init__(self, cfg: LMArch, *, device: torch.device | str,
                 generator: torch.Generator | None = None, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        device = torch.device(device)
        self.embed = nn.Parameter(torch.empty((padded_vocab(cfg), cfg.d_model),
                                              dtype=torch.bfloat16, device=device))
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, device=device))
        self.layers = LayerStack(cfg, device)
        self.register_buffer("rope_freq", rope_frequencies(cfg.head_dim, cfg.rope_theta)
                             .to(device), persistent=False)
        self.requires_grad_(trainable)  # serving: no autograd state
        self._graph: _DecodeGraph | None = None
        if generator is not None:
            self._draw(generator)

    @torch.no_grad()
    def _draw(self, generator: torch.Generator) -> None:
        def draw_(param: torch.Tensor, in_axis: int) -> None:
            f32 = torch.empty(param.shape, dtype=torch.float32, device=param.device)
            param.copy_(dense_init_(f32, generator, in_axis=in_axis))

        leaves = sorted(self.layers.named_parameters())
        for l in range(self.cfg.n_layers):
            for name, param in leaves:
                if name.startswith("ln"):
                    param[l].zero_()
                else:
                    draw_(param[l], -2)
        draw_(self.embed, 1)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def trainable(self) -> bool:
        return self.embed.requires_grad

    def empty_cache(self, batch: int, max_seq: int) -> dict[str, torch.Tensor]:
        """A zero KV cache for ``batch`` sequences of up to ``max_seq`` tokens."""
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in cache_specs(self.cfg, batch, max_seq).items()}

    def _ffn(self, layer: SimpleNamespace, h: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(ffn(h), the MoE's aux loss f32 0-d; None for a dense FFN)."""
        cfg = self.cfg
        if cfg.moe is None:
            return ACTIVATIONS[cfg.activation](h @ layer.wi) @ layer.wo_mlp, None
        y, aux = moe_ffn(h.reshape(-1, cfg.d_model), layer.router, layer.wi_e, layer.wo_e,
                         top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                         activation=cfg.activation)
        return y.view(h.shape), aux

    def _attention(self, layer: SimpleNamespace, x: torch.Tensor,
                   rot: tuple[torch.Tensor, torch.Tensor],
                   cache: dict[str, torch.Tensor] | None = None, l: int = 0) -> torch.Tensor:
        """x + o(x) @ wo over positions [0, S); their k and v go to layer
        ``l`` of ``cache`` when one is given."""
        b, s = x.shape[:2]
        q, k, v = self._qkv(layer, x, rot)
        if cache is not None:
            cache["k"][l, :, :s] = k
            cache["v"][l, :, :s] = v
        o = attn.causal_attention(q, k, v, q_chunk=self.cfg.q_chunk, window=self.cfg.attn_window)
        del q, k, v
        return x + o.reshape(b, s, -1) @ layer.wo

    def _layer(self, layer: SimpleNamespace, x: torch.Tensor,
               rot: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor | None]:
        """One training layer, no cache: (its output, its aux loss or None)."""
        x = self._attention(layer, x, rot)
        y, aux = self._ffn(layer, rms_norm(x, layer.ln2))
        return x + y, aux

    def hidden(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """tokens i32 [B, S] -> (the final normed hidden bf16 [B, S, d], the
        layers' MoE aux losses f32 [L], None for a dense model): the
        reference's ``_backbone`` without a cache, under autograd when the
        model is trainable.  With ``cfg.remat`` each layer is
        checkpointed: its bf16 input is all it keeps for the backward."""
        cfg = self.cfg
        b, s = tokens.shape
        x = self.embed[tokens.long()]
        rot = self._rot(torch.arange(s, device=tokens.device).expand(b, s))
        auxs = []
        for layer in self.layers.unbind():
            if cfg.remat:
                x, aux = checkpoint(self._layer, layer, x, rot, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = self._layer(layer, x, rot)
            auxs.append(aux)
        return rms_norm(x, self.ln_f), None if cfg.moe is None else torch.stack(auxs)

    def _qkv(self, layer: SimpleNamespace, x: torch.Tensor,
             rot: tuple[torch.Tensor, torch.Tensor]):
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
        b, s = x.shape[:2]
        if rot is None:
            rot = self._rot(torch.arange(s, device=x.device).expand(b, s))
        return self._attention(self.layers[l], x, rot, cache, l)

    @torch.no_grad()
    def ffn_block(self, l: int, x: torch.Tensor) -> torch.Tensor:
        """The FFN half of layer ``l`` (dense or MoE): x + ffn(rms_norm(x))."""
        layer = self.layers[l]
        return x + self._ffn(layer, rms_norm(x, layer.ln2))[0]

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


def _chunk_ce(xc: torch.Tensor, targets: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over a chunk: xc bf16 [B, c, d], targets
    i64 [B, c]; the logits f32 [B, c, V_padded], pad columns included."""
    logits = (xc @ embed.T).float()
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, aux_weight: float = 0.01
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token CE over tokens i32 [B, S] (the reference's ``lm_loss``):
    (loss, {"ce", "aux"}), each f32 0-d.  The hidden states x[:, :-1]
    against tokens[:, 1:], in ``loss_chunk`` sequence chunks and then the
    ragged tail, summed in f32 and divided by B·(S − 1); plus
    ``aux_weight`` × the mean over layers of the MoE aux loss."""
    cfg = model.cfg
    b, s = tokens.shape
    x, auxs = model.hidden(tokens)
    inputs, targets = x[:, :-1], tokens[:, 1:].long()
    n_tok = s - 1
    chunk = min(cfg.loss_chunk, n_tok)
    usable = max(n_tok // chunk, 1) * chunk
    pieces = [(c, c + chunk) for c in range(0, usable, chunk)]
    if usable < n_tok:
        pieces.append((usable, n_tok))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in pieces:
        args = (inputs[:, lo:hi], targets[:, lo:hi], model.embed)
        if cfg.remat:
            total = total + checkpoint(_chunk_ce, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_ce(*args)
    loss = total / (b * n_tok)
    aux = torch.zeros_like(loss) if auxs is None else auxs.mean()
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


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
