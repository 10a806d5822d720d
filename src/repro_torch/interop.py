"""Carry state across from the JAX package's objects.

BC has no weights: the state both packages must share is the graph and
the round schedule.  These functions take the *numpy fields* of the JAX
package's ``Graph`` and ``Round`` objects (so this module imports nothing
of that package) and give the port's equivalents:

    g = graph_from_arrays(jg.n, jg.src, jg.dst, jg.w)
    sched = schedule_from_arrays(
        [(r.sources, r.derived) for r in js.rounds], js.batch_size,
        js.derived_per_round, ...)

    part = partition_from_arrays(jp.R, jp.C, jp.n, jp.chunk, jp.src_local,
                                 jp.dst_local, jp.arc_counts, jp.arc_perm)

With these, one schedule can be fed through both packages'
``traversal_round`` round by round, and one 2-D partition through both
packages' distributed operators.

DLRM has weights: :func:`dlrm_params_from_arrays` takes the JAX package's
parameter dict as numpy arrays and gives the port's module state::

    model.load_state_dict(dlrm_params_from_arrays(
        {k: np.asarray(v) for k, v in jax_params.items()}))
"""
from __future__ import annotations

import re
from collections.abc import Sequence

import numpy as np
import torch

from .core.scheduler import Round, Schedule
from .graphs.graph import Graph
from .graphs.partition import TwoDPartition

__all__ = [
    "graph_from_arrays",
    "schedule_from_arrays",
    "partition_from_arrays",
    "dlrm_params_from_arrays",
]


def graph_from_arrays(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray | None = None
) -> Graph:
    """The port's :class:`Graph` from a symmetric, (src, dst)-sorted arc list."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be equal 1-D arrays, got {src.shape}, {dst.shape}")
    if src.size and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n):
        raise ValueError(f"arc endpoint out of range for n = {n}")
    if w is not None:
        w = np.asarray(w, np.float32)
        if w.shape != src.shape:
            raise ValueError(f"w must align with the arcs, got {w.shape}")
    return Graph(n=int(n), src=src, dst=dst, w=w)


def schedule_from_arrays(
    rounds: Sequence[tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    derived_per_round: int,
    *,
    num_leaf_skipped: int = 0,
    num_isolated_omega: int = 0,
    analytic_corrections: np.ndarray | None = None,
    round_depths: np.ndarray | None = None,
) -> Schedule:
    """The port's :class:`Schedule` from ``(sources i32 [s], derived i32
    [k, 3])`` pairs, one per round; the explicit/derived counts are
    recomputed from the rounds."""
    port_rounds = []
    for sources, derived in rounds:
        sources = np.asarray(sources, np.int32)
        derived = np.asarray(derived, np.int32).reshape(-1, 3)
        if sources.shape != (batch_size,) or derived.shape != (derived_per_round, 3):
            raise ValueError(
                f"round shapes {sources.shape}, {derived.shape} do not match "
                f"batch_size={batch_size}, derived_per_round={derived_per_round}"
            )
        port_rounds.append(Round(sources=sources, derived=derived))
    return Schedule(
        rounds=port_rounds,
        batch_size=int(batch_size),
        derived_per_round=int(derived_per_round),
        num_explicit=sum(int((r.sources >= 0).sum()) for r in port_rounds),
        num_derived=sum(int((r.derived[:, 0] >= 0).sum()) for r in port_rounds),
        num_leaf_skipped=int(num_leaf_skipped),
        num_isolated_omega=int(num_isolated_omega),
        analytic_corrections=(
            np.zeros((0, 2), np.float64)
            if analytic_corrections is None
            else np.asarray(analytic_corrections, np.float64).reshape(-1, 2)
        ),
        round_depths=None if round_depths is None else np.asarray(round_depths, np.int64),
    )


def partition_from_arrays(
    R: int,
    C: int,
    n: int,
    chunk: int,
    src_local: np.ndarray,
    dst_local: np.ndarray,
    arc_counts: np.ndarray,
    arc_perm: np.ndarray | None = None,
) -> TwoDPartition:
    """The port's :class:`TwoDPartition` from the numpy fields of the JAX
    package's one (same layout: ``[R, C, max_arcs]`` local arc indices,
    sentinel destination ``C·chunk``)."""
    src_local = np.asarray(src_local, np.int32)
    dst_local = np.asarray(dst_local, np.int32)
    if src_local.shape != dst_local.shape or src_local.shape[:2] != (R, C):
        raise ValueError(
            f"arc arrays must be [{R}, {C}, max_arcs], got {src_local.shape}, {dst_local.shape}"
        )
    if chunk * R * C < n:
        raise ValueError(f"chunk {chunk} on a {R}x{C} grid cannot hold n = {n}")
    return TwoDPartition(
        R=int(R),
        C=int(C),
        n=int(n),
        chunk=int(chunk),
        src_local=src_local,
        dst_local=dst_local,
        arc_counts=np.asarray(arc_counts, np.int64),
        arc_perm=None if arc_perm is None else np.asarray(arc_perm, np.int64),
    )


_MLP_KEY = re.compile(r"(bot|top)_([wb])(\d+)")


def dlrm_params_from_arrays(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The port's :class:`~repro_torch.models.DLRM` state (CPU tensors) from
    the JAX package's DLRM parameters: ``tables`` [F, V, D] and
    ``{bot,top}_{w,b}{i}``.  JAX stores each weight as [in, out] for
    ``x @ W``; ``nn.Linear`` holds [out, in], so weights are transposed."""
    state = {}
    for key, value in params.items():
        arr = np.asarray(value, np.float32)
        if key == "tables":
            if arr.ndim != 3:
                raise ValueError(f"tables must be [F, V, D], got {arr.shape}")
            state["tables"] = torch.tensor(arr)
            continue
        match = _MLP_KEY.fullmatch(key)
        if match is None:
            raise ValueError(f"unknown DLRM parameter {key!r}")
        tag, kind, i = match.groups()
        if kind == "w":
            if arr.ndim != 2:
                raise ValueError(f"{key} must be [in, out], got {arr.shape}")
            state[f"{tag}.{i}.weight"] = torch.tensor(arr.T)
        else:
            state[f"{tag}.{i}.bias"] = torch.tensor(arr)
    return state
