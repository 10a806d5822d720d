"""Optimizers: AdamW, Adafactor (factored second moments), SGD+momentum.

The port of the JAX package's ``optim/optimizers.py``, as
``torch.optim.Optimizer`` subclasses that update the parameters in
place.  The maths is the reference's, written out by hand (not
``torch.optim.AdamW`` / ``Adafactor``, whose defaults and formulas
differ): float32 state, the bias corrections and Adafactor's decay
computed in float32 from the step, the learning rate from a schedule of
the step (:mod:`repro_torch.optim.schedules`) or a constant.

Every parameter's state is made, zero, when the optimizer is built (as
the reference's ``init``), so a fresh optimizer already has the state a
checkpoint restores into.  Each parameter keeps its own ``step``; a
parameter whose ``.grad`` is None is skipped (and its step not
advanced), as PyTorch's optimizers do; the reference always has every
gradient, and then the steps agree.

A parameter of three or more dimensions whose leading dimension is above
1 (the DLRM table stack [F, V, D]) is updated one leading slice at a
time, as the reference's ``_layerwise``: the temporaries then hold one
slice (one table), and Adafactor's row/column means and its RMS clip
are taken per slice, which is its semantics there.

Layout: ``nn.Linear`` holds a weight as [out, in], the reference as
[in, out].  AdamW's and SGD's state is elementwise and transposes with
the weight; Adafactor's row statistics ``vr`` of an [out, in] weight are
the reference's column statistics ``vc`` and vice versa (the factored
estimate is symmetric; ``repro_torch.interop`` swaps them when it
carries state across).
"""
from __future__ import annotations

from collections.abc import Callable, Iterator

import torch

from .schedules import constant

__all__ = [
    "AdamW",
    "Adafactor",
    "SGDMomentum",
    "adamw",
    "adafactor",
    "sgd_momentum",
    "global_norm",
    "clip_by_global_norm",
]


def _as_schedule(lr) -> Callable[[int], float]:
    return lr if callable(lr) else constant(lr)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32, a 0-d tensor);
    ``tree`` is a tensor or a dict / list / tuple of them."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in _leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled so that its global norm is at most ``max_norm``, the
    norm before), each leaf in its own dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda x: (x * scale).to(x.dtype), tree), norm


def _slices(p: torch.Tensor, *rest: torch.Tensor) -> Iterator[tuple[torch.Tensor, ...]]:
    """The reference's ``_layerwise``: a leaf of ndim >= 3 with a leading
    dimension above 1 one leading slice at a time (views), else whole."""
    if p.ndim >= 3 and p.shape[0] > 1:
        for i in range(p.shape[0]):
            yield (p[i],) + tuple(t[i] for t in rest)
    else:
        yield (p,) + rest


def _apply(p: torch.Tensor, u: torch.Tensor, lr: float) -> None:
    """p := p - lr·u, computed in float32 and stored in p's dtype."""
    if p.dtype == torch.float32:
        p.sub_(u, alpha=lr)
    else:
        p.copy_(p.float().sub_(u, alpha=lr))


class _Optimizer(torch.optim.Optimizer):
    """What the three share: the state made at construction and the loop
    over parameters with a gradient, their slices and their step."""

    def __init__(self, params, defaults: dict):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self._state_of(p)

    def _state_of(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = 0
            state.update(self._init(p))
        return state

    def _init(self, p: torch.Tensor) -> dict:  # pragma: no cover - interface
        raise NotImplementedError

    def _update(self, p, g, state: dict, step: int, lr: float, group: dict,
                scale) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def _grad_scale(self, group: dict, grads: list[torch.Tensor]):
        return None

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            sched = _as_schedule(group["lr"])
            params = [p for p in group["params"] if p.grad is not None]
            scale = self._grad_scale(group, [p.grad for p in params])
            for p in params:
                if p.grad.is_sparse:
                    raise RuntimeError(f"{type(self).__name__} does not take sparse gradients")
                state = self._state_of(p)
                state["step"] += 1
                step = state["step"]
                self._update(p, p.grad, state, step, sched(step), group, scale)
        return loss


class AdamW(_Optimizer):
    """AdamW with the reference's formula: m, v float32;
    u = (m/c1) / (sqrt(v/c2) + eps) + wd·p, c_i = 1 - b_i^step in float32;
    p := p - lr·u.  ``grad_clip_norm`` clips the group's gradients by
    their global norm first (the scale applied slice by slice, so no
    scaled copy of a whole leaf is made)."""

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip_norm: float | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                      grad_clip_norm=grad_clip_norm))

    def _init(self, p):
        return {"mu": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "nu": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _grad_scale(self, group, grads):
        if group["grad_clip_norm"] is None or not grads:
            return None
        return _clip_scale(global_norm(grads), group["grad_clip_norm"])

    def _update(self, p, g, state, step, lr, group, scale):
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        c1 = float(1.0 - _f32(b1) ** _f32(step))
        c2 = float(1.0 - _f32(b2) ** _f32(step))
        for ps, gs, m, v in _slices(p, g, state["mu"], state["nu"]):
            gs = gs.float()
            if scale is not None:
                gs = (gs * scale).to(g.dtype).float()  # the reference clips in the grad's dtype
            m.mul_(b1).add_(gs, alpha=1 - b1)
            v.mul_(b2).addcmul_(gs, gs, value=1 - b2)
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if wd:
                u.add_(ps.float(), alpha=wd)
            _apply(ps, u, lr)


class Adafactor(_Optimizer):
    """Factored Adafactor (Shazeer & Stern), the reference's own: a
    parameter of ndim >= 2 keeps row statistics ``vr`` (its shape without
    the last dim) and column statistics ``vc`` (without the last but
    one), a smaller one its full second moment in ``vr`` (``vc`` a zero
    placeholder [1]); decay β = 1 - (step + 1)^-decay; the update RMS
    clipped to ``clip_threshold`` per slice."""

    def __init__(self, params, lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
                 clip_threshold: float = 1.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      clip_threshold=clip_threshold))

    def _init(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"vr": torch.zeros(p.shape, **f32), "vc": torch.zeros((1,), **f32)}

    def _update(self, p, g, state, step, lr, group, scale):
        eps, clip = group["eps"], group["clip_threshold"]
        beta_t = 1.0 - (_f32(step) + 1.0) ** (-group["decay"])
        beta, keep = float(beta_t), float(1.0 - beta_t)
        for ps, gs, vr, vc in _slices(p, g, state["vr"], state["vc"]):
            gs = gs.float()
            g2 = gs * gs + eps
            if ps.ndim >= 2:
                vr.mul_(beta).add_(g2.mean(dim=-1), alpha=keep)
                vc.mul_(beta).add_(g2.mean(dim=-2), alpha=keep)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                u = gs / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :] + eps)
            else:
                vr.mul_(beta).add_(g2, alpha=keep)
                u = gs / (torch.sqrt(vr) + eps)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip, min=1.0)
            _apply(ps, u, lr)


class SGDMomentum(_Optimizer):
    """SGD with heavy-ball momentum: m := momentum·m + g; p := p - lr·m."""

    def __init__(self, params, lr=1e-2, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    def _init(self, p):
        return {"momentum": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

    def _update(self, p, g, state, step, lr, group, scale):
        for ps, gs, m in _slices(p, g, state["momentum"]):
            torch.add(gs.float(), m, alpha=group["momentum"], out=m)  # momentum·m + g
            _apply(ps, m, lr)


def adamw(params, lr=1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip_norm: float | None = None) -> AdamW:
    """The reference's ``adamw`` over ``params`` (``lr`` a float or a
    schedule of the step)."""
    return AdamW(params, lr, b1, b2, eps, weight_decay, grad_clip_norm)


def adafactor(params, lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Adafactor:
    """The reference's ``adafactor`` over ``params``."""
    return Adafactor(params, lr, decay, eps, clip_threshold)


def sgd_momentum(params, lr=1e-2, momentum: float = 0.9) -> SGDMomentum:
    """The reference's ``sgd_momentum`` over ``params``."""
    return SGDMomentum(params, lr, momentum)
