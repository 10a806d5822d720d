"""Work and collective counter: the port's stand-in for the JAX package's
HLO cost parser (``roofline/hlo.py:analyze_hlo_module``).

The JAX package reads a round's FLOP, bytes and collectives from the
compiled HLO.  The port runs eagerly, so it counts them as they happen:
while a :class:`WorkCounter` is active (``with WorkCounter() as c:``),

* every ``torch.distributed`` collective of the 2-D path is recorded in
  the HLO parser's schema, ``{"class", "operand_bytes", "group_size",
  "count"}`` — the expand's ``all_gather_into_tensor`` ("all-gather",
  the operand is the shard), the fold's ``reduce_scatter_tensor``
  ("reduce-scatter", the operand is the whole partial), the agreements'
  ``all_reduce`` ("all-reduce") and the end-of-round gathers
  (``distributed/groups.py``), and each ring hop's ``batch_isend_irecv``
  ("collective-permute", one record a hop whose ``count`` is the
  tensors it sends: the HLO has one ``collective-permute`` per operand);
* every product of a level step reports its FLOP and bytes from its
  operands' shapes: the kernel wrappers of ``kernels/ops.py`` (K1–K7;
  on the CPU their plain versions, the same work) and the arc-list
  operators' gather and row sums (``core/operators.py:_arc_product``: the
  hand kernel on the card, the torch passes on the CPU, counted alike).

:meth:`WorkCounter.terms` gives ``{"flops", "bytes", "collectives"}``
per device, which :func:`repro_torch.roofline.model.roofline_terms`
prices.  The byte and FLOP formulas below are also the kernel table's
(``chip_smoke.py`` phase 7), so the table and the counter count the same
work: each input read once, each output written once.  The arc-list
products count as the HLO parser counts a gather and a scatter: their
operands and outputs, so the [arcs, s] message tensor between the two
counts twice (the card's kernel holds no such tensor, but counts alike);
all at the operand's width (f32), whatever width the product accumulates
in.  The elementwise epilogues of the level steps (masks,
σ/δ updates) are not counted.

Inactive, the hooks cost one ``ACTIVE is not None`` check per call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "ACTIVE",
    "WorkCounter",
    "dense_flops",
    "sparse_flops",
    "frontier_bytes",
    "dependency_bytes",
    "partial_bytes",
    "sparse_bytes",
    "index_sparse_bytes",
    "segment_bag_bytes",
    "gather_bytes",
    "segment_sum_bytes",
]

#: the active counter, or None: what every hook checks first
ACTIVE: "WorkCounter | None" = None


def dense_flops(m: int, k: int, s: int) -> float:
    """2·m·k·s: an [m, k] block times an [k, s] operand."""
    return 2.0 * m * k * s


def sparse_flops(nnz: int, s: int) -> float:
    """2·nnz·s: one multiply-add per stored nonzero (or arc) and column."""
    return 2.0 * nnz * s


def frontier_bytes(adjacency, sigma, depth) -> int:
    """Bytes a K1 call must move: A, σ and d read once, σ' and d' written
    once."""
    return adjacency.nbytes + 2 * (sigma.nbytes + depth.nbytes)


def dependency_bytes(adjacency, sigma, depth, delta, omega) -> int:
    """Bytes a K2 call must move: A, σ, d, δ and ω read once, δ' written
    once."""
    return adjacency.nbytes + sigma.nbytes + depth.nbytes + 2 * delta.nbytes + omega.nbytes


def partial_bytes(adjacency, sigma, depth, delta=None, omega=None, acc=None) -> int:
    """Bytes a K3/K4 call must move: each input read once, t written once."""
    ins = [adjacency, sigma, depth] + [x for x in (delta, omega, acc) if x is not None]
    return sum(x.nbytes for x in ins) + adjacency.shape[0] * sigma.shape[1] * 4


def index_sparse_bytes(m: int, nnz: int, state_bytes: int, s: int) -> int:
    """Bytes a K5/K6 call must move over a nonzero index of ``nnz`` entries
    for ``m`` rows: the index's ptr (i32 [m + 1]), col (i32) and val (f32),
    the state inputs (``state_bytes``) read once, t [m, s] f32 written
    once."""
    return (m + 1) * 4 + nnz * 8 + state_bytes + m * s * 4


def sparse_bytes(index, sigma, depth, delta=None, omega=None) -> int:
    """Bytes a K5/K6 call must move: the nonzeros (col, val) and one row
    structure (ptr) of its index, and each state input, read once, t
    written once.  The work list (seg, long_ptr) is the kernel's own
    choice and is not counted."""
    state = sum(x.nbytes for x in (sigma, depth, delta, omega) if x is not None)
    return index_sparse_bytes(index.ptr.numel() - 1, index.col.numel(), state, sigma.shape[1])


def segment_bag_bytes(table, indices, weights=None, distinct: int | None = None) -> int:
    """Bytes a K7 call must move: each distinct table row read once, the
    ids (and weights) read once, the [B, D] f32 output written once."""
    if distinct is None:
        distinct = int(torch.unique(indices[indices >= 0]).numel())
    d = table.shape[1]
    extra = weights.nbytes if weights is not None else 0
    return distinct * d * table.element_size() + indices.nbytes + extra + indices.shape[0] * d * 4


def gather_bytes(x: torch.Tensor, index: torch.Tensor) -> int:
    """``x.index_select(0, index)``: its operands and its [len, ...] output."""
    return x.nbytes + index.nbytes + index.numel() * (x.nbytes // max(x.shape[0], 1))


def segment_sum_bytes(messages: int, lengths: torch.Tensor, out: torch.Tensor) -> int:
    """Row sums of a ``messages``-byte [arcs, ...] tensor over consecutive
    segments of ``lengths`` rows into ``out``: the messages and lengths
    read, out written."""
    return messages + lengths.nbytes + out.nbytes


class WorkCounter:
    """Records collectives and level-step work while active (see the
    module docstring).  One counter is active at a time; entering a second
    raises."""

    def __init__(self):
        #: every collective call, in order, in the HLO parser's schema plus
        #: the process group it ran on (``"group"``, None: the default one)
        self.records: list[dict] = []
        #: every product: ``{"name", "flops", "bytes"}``, in order
        self.work: list[dict] = []

    def __enter__(self) -> "WorkCounter":
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("a WorkCounter is already active")
        ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global ACTIVE
        ACTIVE = None

    # ------------------------------------------------------------ hooks
    def collective(self, cls: str, operand_bytes: int, group, count: int = 1) -> None:
        self.records.append({"class": cls, "operand_bytes": float(operand_bytes),
                             "group_size": dist.get_world_size(group), "count": int(count),
                             "group": group})

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.work.append({"name": name, "flops": float(flops), "bytes": float(nbytes)})

    # ---------------------------------------------------------- reports
    def collectives(self) -> list[dict]:
        """The records summed by (class, group size), in first-seen order —
        the HLO parser's aggregation (``operand_bytes`` and ``count`` are
        totals)."""
        out: dict[tuple, dict] = {}
        for rec in self.records:
            key = (rec["class"], rec["group_size"])
            if key not in out:
                out[key] = {"class": key[0], "group_size": key[1], "operand_bytes": 0.0,
                            "count": 0}
            out[key]["operand_bytes"] += rec["operand_bytes"]
            out[key]["count"] += rec["count"]
        return list(out.values())

    def by_name(self) -> dict[str, dict]:
        """Calls, FLOP and bytes summed per product name."""
        out: dict[str, dict] = {}
        for w in self.work:
            agg = out.setdefault(w["name"], {"calls": 0, "flops": 0.0, "bytes": 0.0})
            agg["calls"] += 1
            agg["flops"] += w["flops"]
            agg["bytes"] += w["bytes"]
        return out

    def terms(self) -> dict:
        """``{"flops", "bytes", "collectives"}`` of this device, the input of
        :func:`repro_torch.roofline.model.roofline_terms`."""
        return {"flops": sum(w["flops"] for w in self.work),
                "bytes": sum(w["bytes"] for w in self.work),
                "collectives": self.collectives()}
