"""The arc product — ``A @ x`` over an arc list sorted by destination —
launched on the card, and the work list it reads.

The kernel (``csrc/arc_product.cu``) replaces no TPU kernel: the JAX
package's sparse engine leaves this product to XLA's gather and
``segment_sum``, and the port's torch version
(:func:`repro_torch.core.operators._arc_sum`) gathers ``x[src]`` into an
[arcs, s] tensor before it sums.  The kernel reads each arc's operand row
once and sums it in f64 registers in the torch version's order, so the
two agree bit for bit; the note in the source gives the bound and the
design.

:func:`arc_plan` builds the kernel's work list on the arcs' device, once
per arc list, from the operands the operators already hold:
:func:`~repro_torch.core.operators._arc_pieces`' ``(pieces, counts)``
over the destination-sorted ``src``, which the plan keeps for the torch
version.  The public, checked entry point is
:func:`repro_torch.kernels.ops.arc_product`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

__all__ = ["ArcPlan", "arc_plan", "arc_product_cuda"]


class ArcPlan(NamedTuple):
    """The arc product's work list over one destination-sorted arc list
    (the kernel's arrays int32; see :func:`arc_plan`), and the pieces it
    was cut from."""

    src: torch.Tensor  #: [arcs]: each arc's operand row, arcs sorted by destination
    seg: torch.Tensor  #: [S, 3]: (row, lo, hi) — long rows' pieces, then every other row whole
    long_ptr: torch.Tensor  #: [L + 1]: long row i owns pieces [long_ptr[i], long_ptr[i + 1])
    n_long_seg: int  #: long_ptr[-1], the pieces in front of the whole rows
    rows: int  #: output rows; the sentinel row (and any past it) has no segment
    pieces: torch.Tensor | None  #: ``_arc_pieces``' arc count of each piece (None: rows whole)
    counts: torch.Tensor  #: ``_arc_pieces``' piece (or arc) count of each row, sentinel's too

    @property
    def arrays(self) -> tuple[torch.Tensor, ...]:
        return (self.src, self.seg, self.long_ptr)

    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.arrays)


def arc_plan(src: torch.Tensor, pieces: torch.Tensor | None, counts: torch.Tensor,
             rows: int) -> ArcPlan:
    """The work list of the arc product over ``src`` (the arcs' operand
    rows, sorted by destination) cut by ``_arc_pieces``: ``pieces`` the
    arc count of each piece (None: every row is one piece) and ``counts``
    the piece count of each destination row (the arc count where
    ``pieces`` is None), rows ``rows`` and past dropped.

    A row of more than one piece is long: its pieces become segments, in
    piece order, in front; the long rows go heaviest first (most pieces;
    ties in row order).  Every other row, empty ones too, is one segment,
    in row order.  So every arc of rows [0, rows) lies in exactly one
    segment, each segment's arcs are a piece of ``_arc_pieces``, and each
    output row has exactly one writer.  The plan keeps ``pieces`` and
    ``counts`` as given.  Raises past the int32 index."""
    if src.numel() >= 2**31 or rows >= 2**31:
        raise ValueError(f"{src.numel()} arcs or {rows} rows exceed the arc product's int32 index")
    dev = src.device
    given = (pieces, counts)
    counts = counts[:rows].long()
    if pieces is None:
        lo = counts.cumsum(0) - counts
        seg = torch.stack([torch.arange(rows, device=dev), lo, lo + counts], 1)
        long_ptr = counts.new_zeros(1)
    else:
        pieces = pieces.long()
        first = counts.cumsum(0) - counts  # each row's first piece
        start = pieces.cumsum(0) - pieces  # each piece's first arc
        long_rows = (counts > 1).nonzero().squeeze(1)
        order = torch.argsort(counts[long_rows], descending=True, stable=True)
        long_rows = long_rows[order]
        per_row = counts[long_rows]
        long_ptr = torch.cat([per_row.new_zeros(1), per_row.cumsum(0)])
        seg_row = long_rows.repeat_interleave(per_row)
        piece = (first[seg_row] + torch.arange(seg_row.numel(), device=dev)
                 - long_ptr[:-1].repeat_interleave(per_row))
        short = (counts == 1).nonzero().squeeze(1)
        one = first[short]
        seg = torch.cat([
            torch.stack([seg_row, start[piece], start[piece] + pieces[piece]], 1),
            torch.stack([short, start[one], start[one] + pieces[one]], 1),
        ])
    i32 = torch.int32
    return ArcPlan(src.to(i32), seg.to(i32).contiguous(), long_ptr.to(i32),
                   int(long_ptr[-1]), rows, *given)


def arc_product_cuda(x: torch.Tensor, plan: ArcPlan) -> torch.Tensor:
    """Launch the arc product on already-validated CUDA tensors (see
    ops.arc_product): out f32 [plan.rows, s], row v the f64 sum of x[src]
    over the arcs into v, rounded once."""
    kdim, s = x.shape
    dev = x.device
    n_long_rows = plan.long_ptr.numel() - 1
    out = torch.empty((plan.rows, s), dtype=torch.float32, device=dev)
    partials = torch.empty((plan.n_long_seg, s), dtype=torch.float64, device=dev)
    err = _build.library().arc_product_f32(
        x.data_ptr(), plan.src.data_ptr(), plan.seg.data_ptr(), plan.long_ptr.data_ptr(),
        out.data_ptr(), partials.data_ptr(), kdim, s, plan.seg.shape[0], plan.n_long_seg,
        n_long_rows, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"arc_product kernel launch failed: CUDA error {err}")
    return out
