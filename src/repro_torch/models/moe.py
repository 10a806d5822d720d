"""Mixture-of-Experts FFN with capacity-based token dispatch.

The JAX package's ``models/moe.py`` in torch, step for step:

  1. router logits in f32 → softmax → top-k experts, gates renormalised
     over the k (floor 1e-9);
  2. the slot of each (token, expert) assignment: its rank within the
     expert, the exclusive cumulative count in token-major order (no
     sort), equal as integers to the reference's;
  3. the kept tokens copied into an [E, cap, d] buffer, cap = max(8,
     int(cf·T·k/E)) rounded up to a multiple of 8; assignments ranked at
     or past cap are dropped and contribute zero;
  4. the expert FFN as batched products over the [E, cap, ·] buffer;
  5. each token's k rows gathered back, times their bf16 gates, and
     added one at a time in k order in bf16 (the reference's
     ``segment_sum`` of bf16 rows gives exactly these sequential adds; a
     sum over k in f32 rounded once differs in about half the entries).

All T tokens are routed at once: the capacity depends on T, so chunking
the tokens would change which assignments drop.  The load-balance
auxiliary loss E·Σ me·ce (Switch eq. 4) is returned beside the output.
Under autograd the gradient flows as the reference's does: a dropped
assignment's row and gate take none, the gates through the router's
softmax and top-k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import ACTIVATIONS

__all__ = ["moe_ffn", "route", "expert_slots", "capacity"]


def capacity(tokens: int, top_k: int, num_experts: int, capacity_factor: float) -> int:
    """Rows per expert: max(8, int(cf·T·k/E)), rounded up to a multiple of 8."""
    cap = max(8, int(capacity_factor * tokens * top_k / num_experts))
    return cap + (-cap) % 8


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs f32 [T, E], renormalised gates f32 [T, k], expert ids [T, k])
    of tokens x [T, d]; the ids in descending order of probability."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_ids


def expert_slots(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """i64 [T·k]: how many earlier assignments (in token-major order) went
    to the same expert as each of ``flat_e`` [T·k] — the reference's
    exclusive cumulative one-hot count, as integers.  The count runs as
    one flat scan over the expert-major one-hot [E, T·k], each expert's
    row then offset by the assignments to the experts before it: a scan
    along T·k rows of only E columns leaves the card nearly idle."""
    n = flat_e.numel()
    experts = torch.arange(num_experts, device=flat_e.device)
    hits = (experts[:, None] == flat_e[None, :]).to(torch.int32)  # [E, T·k]
    running = torch.cumsum(hits.view(-1), dim=0, dtype=torch.int32).view(num_experts, n)
    before = torch.cat([running.new_zeros(1), running[:-1, -1]])  # to lower experts
    ranks = running - before[:, None]  # inclusive, within each expert
    return ranks.gather(0, flat_e[None, :])[0].long() - 1


def moe_ffn(
    x: torch.Tensor,  # [T, d] flattened tokens
    router_w: torch.Tensor,  # [d, E]
    wi: torch.Tensor,  # [E, d, 2*ff] (fused gate+up)
    wo: torch.Tensor,  # [E, ff, d]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    activation: str = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [T, d] in x's dtype, aux_loss f32 0-d)."""
    t, d = x.shape
    e = router_w.shape[1]
    act = ACTIVATIONS[activation]
    probs, gate_vals, expert_ids = route(x, router_w, top_k)

    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)

    flat_e = expert_ids.reshape(-1)
    pos = expert_slots(flat_e, e)
    cap = capacity(t, top_k, e, capacity_factor)
    keep = pos < cap
    slot = pos.clamp_max(cap - 1)

    # dropped assignments write to a spare row cap, cut off below, so the
    # kept ones, each at its own (expert, slot), need no accumulation
    buf = x.new_zeros((e, cap + 1, d))
    tok_of = torch.arange(t * top_k, device=x.device) // top_k
    buf[flat_e, torch.where(keep, pos, cap)] = x[tok_of]
    buf = buf[:, :cap]

    h = act(torch.bmm(buf, wi))
    y = torch.bmm(h, wo)

    gates = gate_vals.to(x.dtype) * keep.view(t, top_k).to(x.dtype)
    rows = y[expert_ids, slot.view(t, top_k)]  # [T, k, d]: the reference's out_rows
    if rows.requires_grad or gates.requires_grad:  # autograd needs rows for the gates' grad
        rows = rows * gates[..., None]
    else:
        rows.mul_(gates[..., None])
    out = rows[:, 0]
    for j in range(1, top_k):  # in k order, in x's dtype
        out = out + rows[:, j]
    return out, aux
