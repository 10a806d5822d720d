"""K5 and K6 — the blocked-sparse (BCSR) pre-fold partials of a forward
and a dependency level — launched on the card.

K5 replaces ``kernels/blocked_spmm.py:frontier_sparse_kernel`` /
``frontier_sparse_acc_kernel`` of the JAX package (Pallas TPU kernels),
K6 ``dependency_sparse_kernel`` / ``dependency_sparse_acc_kernel``; both
are ``csrc/sparse_spmm.cu``.  The TPU kernels multiply every stored
[bm, bk] tile; on R-MAT a 128 x 128 tile holds about 7 nonzeros, so the
CUDA kernels read instead a per-layout index of the tiles' nonzeros
(:func:`nonzero_index`, built once per layout on the device, which the
engine keeps and the wrappers require on the card) and do nnz·s work: an
operand pass writes the masked frontier or g once into a [k, s] scratch,
a gather pass sums operand rows over each row's nonzeros (one warp per
work segment, long rows cut into segments of :data:`SEGMENT`), and a
combine pass adds up the segments of long rows.  The bound is bytes:
the index's ptr, col and val, σ and d (K6: δ, ω) read once and t written once, over
3.35 TB/s; the note in the source gives the numbers and the design.

The plain versions are :func:`repro_torch.kernels.ref.frontier_sparse_ref`
and :func:`~repro_torch.kernels.ref.dependency_sparse_ref` (the tile
products, the semantics); :func:`~repro_torch.kernels.ref.frontier_index_ref`
and :func:`~repro_torch.kernels.ref.dependency_index_ref` take the same
sums over the index, as the kernels do.  The public, checked entry points
are :func:`repro_torch.kernels.ops.frontier_spmm_sparse` and
:func:`~repro_torch.kernels.ops.dependency_spmm_sparse`.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from . import _build

__all__ = [
    "SEGMENT",
    "NonzeroIndex",
    "layout_key",
    "nonzero_index",
    "frontier_sparse_cuda",
    "dependency_sparse_cuda",
]

#: nonzeros one warp of K5/K6 sums at most; a longer row is cut into
#: segments of this length, summed apart and combined in order
SEGMENT = 256
#: tile elements one ``torch.nonzero`` call of :func:`nonzero_index` reads
#: (R-MAT scale 16 at tile 128 stores 4.2e9 elements, past what one call
#: indexes safely)
INDEX_CHUNK_ELEMS = 1 << 28


class NonzeroIndex(NamedTuple):
    """The nonzeros of one BCSR block as a row-CSR, and the work list of
    K5/K6 over it (all int32 but ``val``; see :func:`nonzero_index`)."""

    ptr: torch.Tensor  #: [m + 1]: row r's entries are [ptr[r], ptr[r + 1])
    col: torch.Tensor  #: [nnz]: operand row tile_cols·bk + c, ascending within a row
    val: torch.Tensor  #: f32 [nnz]: the tile entry
    seg: torch.Tensor  #: [S, 3]: (row, lo, hi) — long rows' segments, then every other row
    long_ptr: torch.Tensor  #: [L + 1]: long row i owns segments [long_ptr[i], long_ptr[i + 1])
    layout: tuple  #: :func:`layout_key` of the tile list and m it was built from
    build_s: float  #: seconds the build took, the device's work included

    @property
    def arrays(self) -> tuple[torch.Tensor, ...]:
        return (self.ptr, self.col, self.val, self.seg, self.long_ptr)

    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.arrays)


def layout_key(tiles: torch.Tensor, tile_rows: torch.Tensor, tile_cols: torch.Tensor,
               m: int) -> tuple:
    """What identifies a tile list for its :class:`NonzeroIndex`: each
    tensor's device, shape, storage and version counter (bumped by every
    in-place write), and m.  An index whose ``layout`` differs was built
    from other tiles, or from these before they changed."""
    def stamp(t):
        return (str(t.device), tuple(t.shape), t.data_ptr(),
                -1 if t.is_inference() else t._version)
    return (stamp(tiles), stamp(tile_rows), stamp(tile_cols), m)


def nonzero_index(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    m: int,
    *,
    chunk_tiles: int | None = None,
) -> NonzeroIndex:
    """The nonzero entries of the block that a BCSR tile list holds
    (tiles [T, bm, bk], tile_rows / tile_cols i32 [T]; any order, fillers
    and padding allowed), built on the tiles' device, once per layout.

    Entry (tile t, r, c) becomes row ``tile_rows[t]·bm + r`` with operand
    row ``tile_cols[t]·bk + c`` and value ``tiles[t, r, c]``; rows are
    ordered, and a row's entries by ascending operand row (a stable sort,
    so the kernels' summation order is the same for every build).  The
    tiles are read ``chunk_tiles`` at a time (default: 2^28 elements).
    Then the work list: each row of more than :data:`SEGMENT` entries
    gives ceil(len / SEGMENT) segments, in front; every other row, empty
    ones too, one segment in row order.  The index keeps the tile list's
    :func:`layout_key`, which the wrappers check against the tiles they
    are given.  Raises if nnz >= 2^31."""
    start = time.perf_counter()
    num_tiles, bm, bk = tiles.shape
    dev = tiles.device
    step = chunk_tiles or max(1, INDEX_CHUNK_ELEMS // (bm * bk))
    keys, vals = [torch.zeros(0, dtype=torch.int64, device=dev)], [tiles.new_zeros(0)]
    for t0 in range(0, num_tiles, step):
        part = tiles[t0 : t0 + step]
        t, r, c = torch.nonzero(part, as_tuple=True)
        vals.append(part[t, r, c])
        row = tile_rows[t0 + t].long() * bm + r
        keys.append(row << 32 | (tile_cols[t0 + t].long() * bk + c))
    key = torch.cat(keys)
    if key.numel() >= 2**31:
        raise ValueError(f"{key.numel()} nonzeros exceed the int32 index of K5/K6")
    key, order = torch.sort(key, stable=True)
    val = torch.cat(vals)[order].to(torch.float32)
    row = key >> 32
    ptr = torch.searchsorted(row, torch.arange(m + 1, device=dev))
    lens = ptr[1:] - ptr[:-1]
    nseg = (lens + SEGMENT - 1) // SEGMENT
    is_long = nseg > 1
    long_rows = is_long.nonzero().squeeze(1)
    counts = nseg[long_rows]
    long_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    seg_row = long_rows.repeat_interleave(counts)
    first = long_ptr[:-1].repeat_interleave(counts)
    lo = ptr[seg_row] + (torch.arange(seg_row.numel(), device=dev) - first) * SEGMENT
    hi = torch.minimum(lo + SEGMENT, ptr[seg_row + 1])
    short = (~is_long).nonzero().squeeze(1)
    seg = torch.cat([torch.stack([seg_row, lo, hi], 1),
                     torch.stack([short, ptr[short], ptr[short + 1]], 1)])
    i32 = torch.int32
    arrays = (ptr.to(i32), (key & 0xFFFFFFFF).to(i32), val, seg.to(i32), long_ptr.to(i32))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return NonzeroIndex(*arrays, layout_key(tiles, tile_rows, tile_cols, m),
                        time.perf_counter() - start)


def _launch(name: str, fn, index: NonzeroIndex, operands, acc, m: int, lvl: int) -> torch.Tensor:
    kdim, s = operands[0].shape
    dev = operands[0].device
    n_seg, n_long_rows = index.seg.shape[0], index.long_ptr.numel() - 1
    t_out = torch.empty((m, s), dtype=torch.float32, device=dev)
    operand = torch.empty((kdim, s), dtype=torch.float32, device=dev)
    partials = torch.empty((n_seg - (m - n_long_rows), s), dtype=torch.float32, device=dev)
    err = fn(
        index.col.data_ptr(), index.val.data_ptr(), index.seg.data_ptr(),
        index.long_ptr.data_ptr(), *(x.data_ptr() for x in operands),
        None if acc is None else acc.data_ptr(), t_out.data_ptr(), operand.data_ptr(),
        partials.data_ptr(), m, kdim, s, n_seg, n_long_rows, int(lvl),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return t_out


def frontier_sparse_cuda(
    index: NonzeroIndex,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K5 on already-validated CUDA tensors (see
    ops.frontier_spmm_sparse): t = [acc +] A_block @ (σ ⊙ [d = lvl-1])
    over the index's nonzeros."""
    return _launch("frontier_spmm_sparse", _build.library().frontier_sparse_f32, index,
                   (sigma, depth), acc, m, lvl)


def dependency_sparse_cuda(
    index: NonzeroIndex,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    m: int,
    acc: torch.Tensor | None,
) -> torch.Tensor:
    """Launch K6 on already-validated CUDA tensors (see
    ops.dependency_spmm_sparse): t = [acc +] A_block @ g over the index's
    nonzeros."""
    return _launch("dependency_spmm_sparse", _build.library().dependency_sparse_f32, index,
                   (sigma, depth, delta, omega), acc, m, lvl)
