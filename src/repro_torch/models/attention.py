"""Grouped-query attention of the port: q-chunked causal attention for
prefill and single-token decode against a KV cache.

The JAX package's ``models/attention.py`` in torch.  Scores are the
product of bf16 operands with an f32 result (:func:`bmm_f32`) times
hd^-1/2; masked entries are set to -1e30 (not -inf), the softmax runs in
f32 and the probabilities are cast to bf16 before the PV product, whose
result is bf16.  GQA reshapes q to [B, S, K, G, hd]: the G query heads
of a group share one kv head.  Prefill attends each chunk of q_chunk
queries to every key, masked, as the reference does (no causal block is
skipped), so the [B, H, q_chunk, S] score block is the largest
transient.  Prefill runs under autograd as the training forward; the
serving path, without gradients, keeps its in-place ops and buffers.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "bmm_f32", "causal_attention", "decode_attention"]

NEG_INF = -1e30


def _bmm_f32(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    if a.is_cuda:
        if out is None:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32, out=out)
    return torch.bmm(a.float(), b.float(), out=out)


class _BmmF32(torch.autograd.Function):
    """:func:`bmm_f32` under autograd.  The backward is what ``jax.grad``
    of the reference's ``preferred_element_type=f32`` einsum gives: the f32
    cotangent times the other operand upcast to f32, an f32 product,
    rounded once to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(grad, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), grad).to(b.dtype)
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """[n, m, k] @ [n, k, p] of bf16 operands with an f32 result,
    accumulated in f32 (the reference's ``preferred_element_type=f32``),
    into ``out`` when given.  On the card this is ``torch.bmm(...,
    out_dtype=torch.float32)``: no f32 copy of an operand (the operand may
    be one head of the KV cache, the largest tensor of the system); a
    build without that overload raises.  On the CPU, which has no kernel
    for it, the operands are upcast: the products of bf16 values are exact
    in f32, so this computes the same function.  When an operand needs a
    gradient it runs through :class:`_BmmF32` (no ``out`` then)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if out is not None:
            raise ValueError("bmm_f32 under autograd writes no out= tensor")
        return _BmmF32.apply(a, b)
    return _bmm_f32(a, b, out)


def _mask_(scores: torch.Tensor, q0: int, s: int, window: int | None) -> None:
    """Set -1e30, in place, where key k is not visible from query q =
    q0 + row of ``scores`` [..., qc, s]: k > q, or q - k >= window.  Keys
    past the chunk's last query are filled whole; without a window the
    keys before q0 are all visible and left as they are."""
    qc = scores.shape[-2]
    end = q0 + qc
    if end < s:
        scores[..., end:].fill_(NEG_INF)
    lo = q0 if window is None else 0
    q_pos = torch.arange(q0, end, device=scores.device)[:, None]
    k_pos = torch.arange(lo, min(end, s), device=scores.device)[None, :]
    hidden = k_pos > q_pos
    if window is not None:
        hidden |= q_pos - k_pos >= window
    scores[..., lo:min(end, s)].masked_fill_(hidden, NEG_INF)


def causal_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    *,
    q_chunk: int = 512,
    window: int | None = None,
) -> torch.Tensor:
    """Full (or windowed) causal GQA for prefill -> [B, S, H, hd]."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd**-0.5
    q_chunk = min(q_chunk, s)
    if s % q_chunk != 0:  # one chunk for ragged shapes, as the reference
        q_chunk = s
    # a power-of-two scale (head_dim 64 or 256) is exact on the bf16 q, and
    # the f32 sums of the scaled products are then the scores times the
    # scale, bit for bit: folded into q, it saves a pass over every chunk
    fold = math.frexp(scale)[0] == 0.5
    if fold:
        q = q * scale
    # one batch index per (sequence, kv head): k as [B·K, hd, S], v as [B·K, S, hd]
    kt = k.permute(0, 2, 3, 1).reshape(b * kh, hd, s)
    vt = v.permute(0, 2, 1, 3).reshape(b * kh, s, hd)
    # under autograd the chunks are concatenated: a slice write a chunk
    # would copy the whole output's gradient a chunk in the backward
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    out = None if grad else torch.empty((b, s, kh, g, hd), dtype=q.dtype, device=q.device)
    for q0 in range(0, s, q_chunk):
        qc = (q[:, q0:q0 + q_chunk].reshape(b, q_chunk, kh, g, hd)
              .permute(0, 2, 3, 1, 4).reshape(b * kh, g * q_chunk, hd))
        scores = bmm_f32(qc, kt).view(b, kh, g, q_chunk, s)
        if not fold:
            scores.mul_(scale)
        _mask_(scores, q0, s, window)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        del scores
        o = torch.bmm(probs.view(b * kh, g * q_chunk, s), vt)
        o = o.view(b, kh, g, q_chunk, hd).permute(0, 3, 1, 2, 4)
        if grad:
            outs.append(o)
        else:
            out[:, q0:q0 + q_chunk] = o
    if grad:
        out = torch.cat(outs, dim=1)
    return out.reshape(b, s, h, hd)


def decode_attention(
    q: torch.Tensor,  # [B, H, hd]: one new token per sequence
    k_cache: torch.Tensor,  # [B, S_max, K, hd]
    v_cache: torch.Tensor,  # [B, S_max, K, hd]
    pos: int,  # the new token's position: the cache is valid for [0, pos]
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-step GQA decode over the whole cache, masked past ``pos``
    -> [B, H, hd].  The cache is a strided operand of the products, never
    copied: one product a kv head over the B sequences, or, when B is the
    smaller, one a sequence over its K kv heads (the B = 1 long-context
    case is then one product a layer)."""
    b, h, hd = q.shape
    s_max, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = hd**-0.5
    qg = q.reshape(b, kh, g, hd).to(k_cache.dtype)
    k_pos = torch.arange(s_max, device=q.device)
    hidden = k_pos > pos
    if window is not None:
        hidden |= k_pos <= pos - window
    if b <= kh:  # per sequence: [K, G, hd] @ [K, hd, S_max]
        pieces = [(qg[i], k_cache[i].permute(1, 2, 0), v_cache[i].transpose(0, 1))
                  for i in range(b)]
        lead = (b, kh)
    else:  # per kv head: [B, G, hd] @ [B, hd, S_max]
        pieces = [(qg[:, j], k_cache[:, :, j].transpose(1, 2), v_cache[:, :, j])
                  for j in range(kh)]
        lead = (kh, b)
    # every piece's scores in one buffer: one mask, softmax and cast a layer
    scores = torch.empty(lead + (g, s_max), dtype=torch.float32, device=q.device)
    for i, (qp, kp, _) in enumerate(pieces):
        bmm_f32(qp, kp, out=scores[i])
    scores.mul_(scale).masked_fill_(hidden, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    del scores
    out = torch.empty(lead + (g, hd), dtype=v_cache.dtype, device=q.device)
    for i, (_, _, vp) in enumerate(pieces):
        torch.bmm(probs[i], vp, out=out[i])
    if b > kh:
        out = out.transpose(0, 1)
    return out.reshape(b, h, hd)
