"""The engine layer: the two level loops, written once.

One BFS level is a *masked matrix product* over a frontier matrix
``F ∈ R^{n×s}`` holding ``s`` concurrent sources:

    forward level ℓ:   t = A @ (σ ⊙ [d = ℓ-1])
                       newly discovered:  d < 0 and t > 0  →  d := ℓ
                       path counts:       σ += t  on  d = ℓ

    backward level ℓ:  g = (1 + δ + ω) / σ  on  d = ℓ+1
                       δ += σ ⊙ (A @ g)     on  d = ℓ

:func:`forward_counting` and :func:`backward_accumulation` are written
against the :class:`repro_torch.core.operators.TraversalOperator`
protocol, so the same loops drive the dense, sparse and fused engines.
Where the JAX package runs a ``lax.while_loop`` with an on-device
liveness flag, the port runs a Python loop and reads the flag back once
per level (a host sync); the static ``num_levels`` path runs a fixed
trip count without reading anything back.

:func:`forward_buckets` and :func:`backward_buckets` are the weighted
traversal's loops (bucketed delta-stepping) over the
:class:`~repro_torch.core.operators.WeightedTraversalOperator` protocol:
nested Python loops in place of the JAX package's nested
``lax.while_loop``, with the same trip caps.  Each inner fixpoint trip and
each forward bucket skip reads one already-reduced scalar back through
:func:`readback`, which counts it in :data:`BUCKET_TRIPS`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .operators import as_operator

__all__ = [
    "ForwardState",
    "forward_counting",
    "backward_accumulation",
    "WeightedForwardState",
    "forward_buckets",
    "backward_buckets",
    "BUCKET_TRIPS",
    "reset_bucket_trips",
    "readback",
]

#: trips of the weighted loops since the last :func:`reset_bucket_trips`:
#: forward buckets visited, forward inner trips (light-edge and σ
#: fixpoints), backward buckets and inner trips, the host readbacks of
#: the weighted round (every :func:`readback`), and the loops that hit
#: their trip cap still changing (``capped``: their state has not
#: converged, so a nonzero count means a wrong BC)
BUCKET_TRIPS = {"forward_buckets": 0, "forward_trips": 0, "backward_buckets": 0,
                "backward_trips": 0, "readbacks": 0, "capped": 0}


def reset_bucket_trips() -> None:
    for key in BUCKET_TRIPS:
        BUCKET_TRIPS[key] = 0


def readback(value: torch.Tensor) -> list | float | int | bool:
    """``value`` on the host (``tolist``: a number, or a list of them),
    counted as one readback of the weighted round."""
    BUCKET_TRIPS["readbacks"] += 1
    with tracing.span("bc.readback"):
        return value.tolist()


class ForwardState(NamedTuple):
    sigma: torch.Tensor  # f32 [n, s] shortest-path counts
    depth: torch.Tensor  # i32 [n, s] discovery level (-1 = unreached)
    max_depth: int  # deepest level discovered
    # f32 0-d running max ABFT checksum residual over all levels
    # (checksum=True runs only; None otherwise)
    check_err: torch.Tensor | None = None


def forward_counting(
    operator, src_onehot: torch.Tensor, num_levels: int | None = None, *,
    checksum: bool = False, roots: torch.Tensor | None = None,
) -> ForwardState:
    """Multi-source shortest-path counting (Alg. 2 analogue).

    Args:
      operator:   a TraversalOperator, or a bare ``A @ x`` callable over
                  the rows of ``src_onehot``.
      src_onehot: f32 [n_rows, s]; column j is the indicator of source j
                  (all-zero columns are inert padding).
      num_levels: None → run until a level discovers nothing (one liveness
                  readback per level); int → that many levels, no
                  readback (extra levels are no-ops).
      checksum:   run the ABFT-checked level steps and carry the running
                  max column-sum residual in ``ForwardState.check_err``
                  (the lane is transient inside each level).
      roots:      i32 [s], each column's root (-1 = padding), for the
                  tracing counters only; None counts no column as padded.
    """
    op = as_operator(operator, n_rows=src_onehot.shape[0], device=src_onehot.device)
    sigma = src_onehot.to(torch.float32)
    depth = torch.where(src_onehot > 0, 0, -1).to(torch.int32)
    err = torch.zeros((), dtype=torch.float32, device=sigma.device)

    def level(lvl, sigma, depth, err):
        if not checksum:
            return op.forward_level(lvl, sigma, depth) + (err,)
        sigma, depth, local_alive, lerr = op.forward_level_checked(lvl, sigma, depth)
        return sigma, depth, local_alive, torch.maximum(err, lerr)

    if num_levels is None:
        cap = op.level_cap()
        lvl, alive = 1, True
        while alive and lvl <= cap:
            with tracing.span("bc.level.forward"):
                sigma, depth, local_alive, err = level(lvl, sigma, depth, err)
                with tracing.span("bc.readback"):
                    alive = bool(op.reduce_any(local_alive))
            lvl += 1
        max_depth = lvl - 2  # last level that discovered anything
        steps = lvl - 1
    else:
        for k in range(num_levels):
            with tracing.span("bc.level.forward"):
                sigma, depth, _, err = level(k + 1, sigma, depth, err)
        with tracing.span("bc.readback"):
            max_depth = int(op.reduce_max(depth.max())) if depth.numel() else 0
        steps = num_levels
    if tracing.on():
        tracing.count_levels(steps, max_depth, depth, 0, roots)
    return ForwardState(sigma=sigma, depth=depth, max_depth=max_depth,
                        check_err=err if checksum else None)


def backward_accumulation(
    operator,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    omega: torch.Tensor,
    max_depth: int,
    num_levels: int | None = None,
    *,
    checksum: bool = False,
    roots: torch.Tensor | None = None,
):
    """Dependency accumulation (Alg. 4/5 analogue, checking successors).

    Returns δ f32 [n_rows, s].  ``operator`` is as for
    :func:`forward_counting`.  ``omega`` is f32 [n_rows] (1-degree
    weights; zeros disable the heuristic).  Levels run from
    ``max_depth - 1`` down to 1 (a Python int, read once per round);
    columns of different depths are handled by masking, which is what
    makes the 2-degree derived columns ride along for free.  With
    ``num_levels`` the sweep runs from ``num_levels - 1`` instead.

    With ``checksum=True`` every level runs the ABFT-checked step and the
    return value is the pair ``(δ, err)``, ``err`` the f32 0-d max
    relative column-sum residual across the sweep.  ``roots`` is as for
    :func:`forward_counting`, over the columns of ``sigma``.
    """
    op = as_operator(operator, n_rows=sigma.shape[0], device=sigma.device)
    delta = torch.zeros_like(sigma)
    err = torch.zeros((), dtype=torch.float32, device=sigma.device)
    top = (num_levels if num_levels is not None else max_depth) - 1
    for lvl in range(top, 0, -1):
        with tracing.span("bc.level.backward"):
            if checksum:
                delta, lerr = op.backward_level_checked(lvl, sigma, depth, omega, delta)
                err = torch.maximum(err, lerr)
            else:
                delta = op.backward_level(lvl, sigma, depth, omega, delta)
    if tracing.on():
        tracing.count_levels(max(top, 0), max_depth - 1, depth, 1, roots)
    return (delta, err) if checksum else delta


class WeightedForwardState(NamedTuple):
    sigma: torch.Tensor  # f32 [n, s] shortest-path counts
    dist: torch.Tensor  # f32 [n, s] settled distances (+inf = unreached)


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float: the bucket bounds are f32
    products and sums on the card in the JAX package too."""
    return float(np.float32(x))


def _fixpoint(step, state, op, cap: int, kind: str):
    """Run ``state, changed = step(state)`` until no rank's state changed
    (one readback of the grid-reduced flag a trip) or ``cap`` trips, the
    latter counted in ``BUCKET_TRIPS["capped"]``."""
    it, alive = 1, True
    while alive and it <= cap:
        state, changed = step(state)
        alive = bool(readback(op.reduce_any(changed)))
        BUCKET_TRIPS[kind] += 1
        it += 1
    BUCKET_TRIPS["capped"] += int(alive)
    return state


def forward_buckets(op, src_onehot: torch.Tensor) -> WeightedForwardState:
    """Multi-source weighted shortest-path counting (delta-stepping).

    The outer loop walks nonempty distance buckets.  Per bucket b (span
    [b·Δ, (b+1)·Δ)):

      1. light-edge relaxation to a fixpoint, the frontier re-derived from
         the tentative distances each trip (vertices pulled into the
         bucket keep relaxing);
      2. one heavy-edge pass (bucket-b distances are final after 1: a
         heavy relaxation lands past (b+1)·Δ);
      3. the σ fixpoint, overwrite semantics over the within-bucket
         predecessor DAG (earlier buckets are final);
      4. the skip to ⌊min unsettled distance / Δ⌋: one readback.

    w > 0 makes the monotone-min relaxation safe: a candidate through a
    frontier vertex exceeds b·Δ, so settled vertices never drop.  The
    bucket index is shared by all s columns and, through ``reduce_min`` /
    ``reduce_any``, by every rank of a grid; columns with nothing in the
    bucket idle as masked no-ops.  Caps as the JAX package's: ``level_cap``
    trips an inner loop, ``level_cap · s + 1`` buckets.
    """
    delta = _f32(op.delta)
    inner_cap = op.level_cap()
    outer_cap = op.level_cap() * src_onehot.shape[1] + 1
    sigma = src_onehot.to(torch.float32)
    dist = torch.where(src_onehot > 0, 0.0, torch.inf).to(torch.float32)
    b, trips, alive = 0, 1, True
    while alive and trips <= outer_cap:
        lo = _f32(np.float32(b) * np.float32(delta))
        hi = _f32(np.float32(lo) + np.float32(delta))
        BUCKET_TRIPS["forward_buckets"] += 1

        def light(d):  # (1)
            nd = torch.minimum(d, op.relax(d, (d >= lo) & (d < hi), heavy=False))
            return nd, (nd < d).any()

        dist = _fixpoint(light, dist, op, inner_cap, "forward_trips")
        # (2) heavy arcs once
        dist = torch.minimum(dist, op.relax(dist, (dist >= lo) & (dist < hi), heavy=True))
        # (3) dist > 0 keeps the roots' σ = 1 (only roots sit at 0: w > 0)
        in_bucket = (dist >= lo) & (dist < hi) & (dist > 0)
        settled = dist < hi

        def count(sg):
            ns = torch.where(in_bucket, op.sigma_step(torch.where(settled, sg, 0.0), dist), sg)
            return ns, (ns != sg).any()

        sigma = _fixpoint(count, sigma, op, inner_cap, "forward_trips")
        # (4) the next nonempty bucket
        mind = float(readback(op.reduce_min(torch.where(dist >= hi, dist, torch.inf).min())))
        alive = math.isfinite(mind)
        b = int(np.floor(np.float32(mind) / np.float32(delta))) if alive else b + 1
        trips += 1
    BUCKET_TRIPS["capped"] += int(alive)
    return WeightedForwardState(sigma=sigma, dist=dist)


def backward_buckets(op, sigma: torch.Tensor, dist: torch.Tensor, omega: torch.Tensor,
                     max_bucket: int) -> torch.Tensor:
    """Weighted dependency accumulation in descending bucket order;
    returns δ f32 [n_rows, s].

    ``max_bucket`` is the global max bucket index (a grid reduces it
    first), so every rank runs exactly ``max_bucket + 1`` buckets: no
    backward skipping, which keeps the ranks in lockstep.  Per bucket,
    successors in deeper buckets are final, lower buckets are masked out
    of g by ``dist ≥ b·Δ``, and same-bucket successor chains converge in
    the inner fixpoint; the roots keep δ = 0 through ``dist > 0``.
    """
    delta = _f32(op.delta)
    inner_cap = op.level_cap()
    omega_col = omega.to(torch.float32)[:, None]
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    finite = torch.isfinite(dist)
    dacc = torch.zeros_like(sigma)
    for b in range(int(max_bucket), -1, -1):
        lo = _f32(np.float32(b) * np.float32(delta))
        hi = _f32(np.float32(lo) + np.float32(delta))
        BUCKET_TRIPS["backward_buckets"] += 1
        in_bucket = finite & (dist >= lo) & (dist < hi) & (dist > 0)
        reach = finite & (dist >= lo)

        def step(da):
            g = torch.where(reach, (1.0 + da + omega_col) / safe_sigma, 0.0)
            nd = torch.where(in_bucket, sigma * op.delta_step(g, dist), da)
            return nd, (nd != da).any()

        dacc = _fixpoint(step, dacc, op, inner_cap, "backward_trips")
    return dacc
