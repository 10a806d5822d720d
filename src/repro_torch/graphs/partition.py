"""2-D decomposition of the adjacency matrix (paper §2.3), numpy.

The processor grid has R rows and C columns.  Vertices are padded to
``n_pad = R*C*chunk`` and assigned to chunks contiguously: chunk ``k``
owns vertices ``[k*chunk, (k+1)*chunk)``.  Device ``(i, j)`` owns chunk
``j*R + i`` — the paper's exact vertex assignment — which makes both
collectives of a traversal level land on contiguous memory:

* **expand** (paper's "gather Q and σ from column j"): gathering the owned
  chunks over the R devices of grid column j, in order of i, yields the
  contiguous vertex range ``cols_j = [j*R*chunk, (j+1)*R*chunk)``.
* **fold** (paper's "exchange Q_r and σ for row i"): device ``(i, j)``
  accumulates partials for ``rows_i`` = chunks ``{i, R+i, ..., (C-1)R+i}``;
  a reduce-scatter of the ``[C*chunk, ...]`` partial over the C devices of
  grid row i, in order of j, delivers block ``j`` — chunk ``j*R+i`` —
  exactly the device's own chunk.  No re-indexing traffic.

Arcs are stored on the device owning (source-column, destination-row):
arc (u, v) lives on grid cell ``(row_of(v), col_of(u))`` with local
indices precomputed here.  Padding arcs point at a sentinel destination
row (``C*chunk``) so they accumulate into a discarded slot.

The same graph and grid give the same arrays as the JAX package's
partitioner (:mod:`repro_torch.interop` carries one across).  The
blocked-sparse and ring layouts arrive with their engines (ROADMAP
Queue 1 items 6 and 7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import Graph

__all__ = ["TwoDPartition", "partition_2d", "partition_arcs_2d"]


@dataclasses.dataclass(frozen=True)
class TwoDPartition:
    """Host-side product of the 2-D partitioner.

    Attributes:
      R, C:      grid shape.
      n:         true vertex count.
      chunk:     vertices per chunk; ``n_pad = R*C*chunk``.
      src_local: int32 [R, C, max_arcs] — arc source index into the
                 column-gathered frontier (``[0, R*chunk)``).
      dst_local: int32 [R, C, max_arcs] — arc destination index into the
                 local partial accumulator (``[0, C*chunk]``; the value
                 ``C*chunk`` is the padding sentinel).
      arc_counts: int64 [R, C] true arc count per cell (diagnostics).
      arc_perm:  int64 [R, C, max_arcs] index of each slot in the
                 original arc list (-1 = padding).
    """

    R: int
    C: int
    n: int
    chunk: int
    src_local: np.ndarray
    dst_local: np.ndarray
    arc_counts: np.ndarray
    arc_perm: np.ndarray | None = None

    @property
    def n_pad(self) -> int:
        return self.R * self.C * self.chunk

    def owned_vertex_base(self, i: int, j: int) -> int:
        return (j * self.R + i) * self.chunk

    def vertex_chunk_owner(self) -> np.ndarray:
        """int32 [n_pad] -> flat device id (i * C + j) of each vertex's owner."""
        chunks = np.arange(self.n_pad) // self.chunk
        i = chunks % self.R
        j = chunks // self.R
        return (i * self.C + j).astype(np.int32)

    def _cell_arcs(self, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
        """True (dst_local, src_local) arc pairs of one grid cell."""
        valid = self.dst_local[i, j] != self.C * self.chunk
        return self.dst_local[i, j][valid], self.src_local[i, j][valid]

    def dense_blocks(self, dtype=np.float32) -> np.ndarray:
        """Dense per-device adjacency blocks [R, C, C·chunk, R·chunk] on the
        host (small graphs and tests only: the engines build one cell on
        its device with :meth:`cell_dense_block`).

        Block (i, j) is A[rows_i, cols_j] in the local index spaces the
        collectives use: rows index the [C·chunk] fold partial, columns
        index the [R·chunk] column-gathered frontier.
        """
        blocks = np.zeros(
            (self.R, self.C, self.C * self.chunk, self.R * self.chunk), dtype
        )
        for i in range(self.R):
            for j in range(self.C):
                d, s = self._cell_arcs(i, j)
                blocks[i, j, d, s] = 1
        return blocks

    def cell_dense_block(
        self, i: int, j: int, dtype: torch.dtype = torch.float32, device=None
    ) -> torch.Tensor:
        """Cell (i, j)'s [C·chunk, R·chunk] 0/1 block, built on ``device``
        from that cell's arcs, so the host never holds an n²/p matrix
        (17.2 GB in f32 for the 1×1 grid at n = 65 536)."""
        d, s = self._cell_arcs(i, j)
        block = torch.zeros(
            (self.C * self.chunk, self.R * self.chunk), dtype=dtype, device=device
        )
        block[
            torch.from_numpy(d).to(device=device, dtype=torch.int64),
            torch.from_numpy(s).to(device=device, dtype=torch.int64),
        ] = 1
        return block


def partition_2d(graph: Graph, R: int, C: int, arc_pad_multiple: int = 8) -> TwoDPartition:
    """Partition ``graph`` over an R×C grid (see module docstring)."""
    return partition_arcs_2d(
        graph.src, graph.dst, graph.n, R, C, arc_pad_multiple=arc_pad_multiple
    )


def partition_arcs_2d(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    R: int,
    C: int,
    arc_pad_multiple: int = 8,
    max_arcs: int | None = None,
) -> TwoDPartition:
    """2-D partition of an arbitrary (possibly asymmetric) arc list."""
    chunk = -(-n // (R * C))  # ceil
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)

    src_chunk = src // chunk
    dst_chunk = dst // chunk
    # grid cell of each arc: column owner of src, row owner of dst
    j_of_arc = src_chunk // R
    i_of_arc = dst_chunk % R

    # local indices
    src_local = (src - j_of_arc * R * chunk).astype(np.int32)  # within cols_j
    dst_block = dst_chunk // R  # block m of rows_i
    dst_local = (dst_block * chunk + dst % chunk).astype(np.int32)

    cell = i_of_arc * C + j_of_arc
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    counts = np.bincount(cell_sorted, minlength=R * C).reshape(R, C)

    if max_arcs is None:
        max_arcs = int(counts.max()) if counts.size else 0
        max_arcs = max(max_arcs, 1)
        max_arcs += (-max_arcs) % arc_pad_multiple
    elif counts.size and int(counts.max()) > max_arcs:
        raise ValueError(f"max_arcs={max_arcs} < worst cell {int(counts.max())}")

    sentinel_dst = C * chunk
    out_src = np.zeros((R, C, max_arcs), dtype=np.int32)
    out_dst = np.full((R, C, max_arcs), sentinel_dst, dtype=np.int32)
    out_perm = np.full((R, C, max_arcs), -1, dtype=np.int64)

    starts = np.zeros(R * C + 1, dtype=np.int64)
    np.cumsum(counts.ravel(), out=starts[1:])
    src_sorted = src_local[order]
    dst_sorted = dst_local[order]
    for flat in range(R * C):
        i, j = divmod(flat, C)
        s, e = starts[flat], starts[flat + 1]
        out_src[i, j, : e - s] = src_sorted[s:e]
        out_dst[i, j, : e - s] = dst_sorted[s:e]
        out_perm[i, j, : e - s] = order[s:e]

    return TwoDPartition(
        R=R,
        C=C,
        n=n,
        chunk=chunk,
        src_local=out_src,
        dst_local=out_dst,
        arc_counts=counts.astype(np.int64),
        arc_perm=out_perm,
    )
