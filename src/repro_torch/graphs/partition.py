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

Blocked-sparse (BCSR) layout: a cell's block is cut into (bm × bk)
tiles and only the nonzero ones are stored, row-sorted, with every
tile-row present (an all-zero filler where a row has none).  One cached
arc→tile pass per tile shape (:meth:`TwoDPartition._tile_pass`) serves
the counts (memory guard, hybrid choice) and the build.  The engines build
their own cell on its device (:meth:`TwoDPartition.cell_blocked_sparse`);
the host-side ``blocked_sparse`` / ``blocked_hybrid`` serve the tests and
small graphs.

The same graph and grid give the same arrays as the JAX package's
partitioner (:mod:`repro_torch.interop` carries one across).  The ring
layouts arrive with their schedule (ROADMAP Queue 1 item 7), weighted
tiles with the weighted traversal (item 11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph import Graph

__all__ = [
    "TwoDPartition",
    "BlockedSparseLayout",
    "HybridLayout",
    "partition_2d",
    "partition_arcs_2d",
    "default_tile_dim",
]


def _arc_tile_unique(d: np.ndarray, s: np.ndarray, bm: int, bk: int, num_tc: int):
    """The arc→tile unique pass of one grid cell: maps its (dst_local,
    src_local) arc pairs onto the (bm × bk) tile grid and deduplicates.
    Returns ``(r_u, c_u, inv)`` — the unique tile row/col ids (sorted by
    row-major key, i64) and the arc→unique-tile inverse map."""
    key = (d // bm) * num_tc + (s // bk)
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq // num_tc, uniq % num_tc, inv


def default_tile_dim(chunk: int, preferred: int = 128) -> int:
    """Largest divisor of ``chunk`` ≤ ``preferred``, preferring multiples
    of 8.  Tile dims divide ``chunk`` so that tiles never straddle a chunk
    boundary (the ring schedule slices by chunk)."""
    divisors = [d for d in range(1, min(chunk, preferred) + 1) if chunk % d == 0]
    lane_aligned = [d for d in divisors if d % 8 == 0]
    return max(lane_aligned or divisors)


def _no_ring_or_weights(ring: bool, weights) -> None:
    if ring:
        raise NotImplementedError(
            "the ring-sliced tile layout is not ported yet (ROADMAP Queue 1 item 7)"
        )
    if weights is not None:
        raise NotImplementedError(
            "weighted tiles are not ported yet (ROADMAP Queue 1 item 11)"
        )


@dataclasses.dataclass(frozen=True)
class BlockedSparseLayout:
    """Host-side BCSR layout of every cell, in the JAX package's full form
    (small graphs and tests: the engines build their own cell on its
    device with :meth:`TwoDPartition.cell_blocked_sparse`).

    Attributes:
      bm, bk:     tile shape (rows × cols); both divide ``chunk``.
      tiles:      [R, C, T, bm, bk] tile data (0/1 values).
      tile_rows:  i32 [R, C, T] output tile-row of each stored tile (into
                  the [C·chunk/bm] grid), non-decreasing along T.
      tile_cols:  i32 [R, C, T] operand tile-col (into [R·chunk/bk]).
      nnz_tiles:  i64 [R, C] true nonzero-tile count per cell (fillers and
                  padding excluded).
    Every tile-row of a cell holds at least one (possibly all-zero filler)
    tile, and cells are padded with zero tiles on their last tile-row to
    the worst cell's T.
    """

    bm: int
    bk: int
    R: int
    C: int
    chunk: int
    nnz_tiles: np.ndarray
    tiles: np.ndarray
    tile_rows: np.ndarray
    tile_cols: np.ndarray

    @property
    def num_tile_rows(self) -> int:
        return self.C * self.chunk // self.bm

    @property
    def num_tile_cols(self) -> int:
        return self.R * self.chunk // self.bk

    def adjacency_bytes(self, dtype_bytes: int = 4) -> int:
        """Stored per-device adjacency bytes (tile data + index maps),
        padding included."""
        cells = self.R * self.C
        return (self.tiles.size // cells * dtype_bytes
                + (self.tile_rows.size + self.tile_cols.size) // cells * 4)


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """Mixed dense/BCSR host layout in the JAX package's form: ``blocks``
    [R, C, C·chunk, R·chunk] holds data only for the dense-chosen cells
    (``dense_cells`` bool [R, C]), ``sparse`` tile data only for the
    others (dense-chosen cells carry the minimal filler list).  The
    ``fused_hybrid`` engine itself holds, on each rank, only its own
    cell's chosen representation."""

    dense_cells: np.ndarray
    blocks: np.ndarray
    sparse: BlockedSparseLayout

    def host_bytes(self) -> int:
        """Materialised host bytes: dense data of the dense-chosen cells,
        every cell's (padded) tile arrays, and the choice mask."""
        m, k = self.blocks.shape[2:]
        dense = int(self.dense_cells.sum()) * m * k * self.blocks.itemsize
        n_cells = self.dense_cells.size
        return dense + n_cells * self.sparse.adjacency_bytes() + n_cells


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

    # ------------------------------------------------ blocked-sparse layout
    def _tile_dims(self, bm: int | None, bk: int | None) -> tuple[int, int]:
        bm = default_tile_dim(self.chunk) if bm is None else bm
        bk = default_tile_dim(self.chunk) if bk is None else bk
        if bm < 1 or bk < 1 or self.chunk % bm or self.chunk % bk:
            raise ValueError(
                f"tile dims ({bm}, {bk}) must divide chunk={self.chunk} "
                "(ring-chunk slicing needs tile-aligned chunk boundaries)"
            )
        return bm, bk

    def _tile_pass(self, bm: int, bk: int) -> list[list[tuple]]:
        """The one arc→tile pass per (bm, bk), cached on the partition:
        ``result[i][j] = (r_u, c_u, inv)`` of :func:`_arc_tile_unique`.
        The counts, the hybrid choice, the memory guard and the layout
        builds all read it, so a run sorts each cell's arcs once."""
        cache = self.__dict__.setdefault("_tile_pass_cache", {})
        if (bm, bk) not in cache:
            num_tc = self.R * self.chunk // bk
            cache[(bm, bk)] = [
                [_arc_tile_unique(*self._cell_arcs(i, j), bm, bk, num_tc) for j in range(self.C)]
                for i in range(self.R)
            ]
        return cache[(bm, bk)]

    def nnz_tile_counts(self, bm: int | None = None, bk: int | None = None) -> np.ndarray:
        """int64 [R, C] nonzero (bm × bk)-tile count per cell, without any
        tile data."""
        bm, bk = self._tile_dims(bm, bk)
        cells = self._tile_pass(bm, bk)
        return np.array(
            [[cells[i][j][0].size for j in range(self.C)] for i in range(self.R)], np.int64
        )

    def blocked_sparse_counts(
        self, bm: int | None = None, bk: int | None = None, cells: np.ndarray | None = None
    ) -> dict:
        """Exact stored-tile accounting of :meth:`blocked_sparse` without
        any tile data, from the cached :meth:`_tile_pass`.

        Stored = true nonzero tiles + one filler per empty tile-row; the
        full form pads every cell to the worst cell's count, the ring form
        (ROADMAP item 7) stores R per-slot slices each with its own fillers.
        ``bytes_full`` / ``bytes_ring`` price those layouts.  ``cells``
        (bool [R, C], default all) restricts which cells store data;
        deselected cells count as their filler-only list.  The per-cell
        arrays (``nnz_cell``, ``stored_full_cell``,
        ``stored_ring_slot_cell``) feed the hybrid choice
        (:func:`repro_torch.roofline.model.cell_kernel_choice`); the port's
        ``fused_sparse`` rank stores exactly ``stored_full_cell[i, j]``
        tiles (no padding).
        """
        bm, bk = self._tile_dims(bm, bk)
        R, C, chunk = self.R, self.C, self.chunk
        num_tr = C * chunk // bm
        cpk = chunk // bk
        sel = np.ones((R, C), bool) if cells is None else np.asarray(cells, bool)
        pass_cells = self._tile_pass(bm, bk)
        nnz_cell = np.zeros((R, C), np.int64)
        full_cell = np.zeros((R, C), np.int64)
        ring_slot_cell = np.zeros((R, C), np.int64)
        for i in range(R):
            for j in range(C):
                # a deselected cell materialises like an empty one: num_tr
                # row-complete fillers, no data tiles
                r_u, c_u, _ = (
                    pass_cells[i][j] if sel[i, j]
                    else (np.zeros(0, np.int64), np.zeros(0, np.int64), None)
                )
                nnz_cell[i, j] = r_u.size
                full_cell[i, j] = r_u.size + num_tr - np.unique(r_u).size
                slot_max = 0
                for r in range(R):
                    rows_r = r_u[(c_u // cpk) == r]
                    slot_max = max(slot_max, rows_r.size + num_tr - np.unique(rows_r).size)
                ring_slot_cell[i, j] = slot_max
        stored_full = max(int(full_cell.max()), 1)
        stored_ring = R * max(int(ring_slot_cell.max()), 1)
        per_tile = bm * bk * 4 + 8
        return {
            "bm": bm,
            "bk": bk,
            "nnz_max": int(nnz_cell.max()),
            "nnz_total": int(nnz_cell.sum()),
            "stored_tiles_full": stored_full,
            "stored_tiles_ring": stored_ring,
            "bytes_full": stored_full * per_tile,
            "bytes_ring": stored_ring * per_tile,
            "nnz_cell": nnz_cell,
            "stored_full_cell": full_cell,
            "stored_ring_slot_cell": ring_slot_cell,
        }

    def _cell_tile_order(self, i: int, j: int, bm: int, bk: int):
        """Cell (i, j)'s row-complete tile list without data: ``(rows,
        cols, arc_tile)`` — i64 tile-row and tile-col of every stored tile
        (row-sorted, one zero filler per empty tile-row) and the stored
        position of every arc's tile."""
        r_u, c_u, inv = self._tile_pass(bm, bk)[i][j]
        num_tr = self.C * self.chunk // bm
        missing = np.setdiff1d(np.arange(num_tr, dtype=np.int64), r_u)
        rows = np.concatenate([r_u, missing])
        cols = np.concatenate([c_u, np.zeros(missing.size, np.int64)])
        order = np.argsort(rows, kind="stable")
        position = np.empty(order.size, np.int64)
        position[order] = np.arange(order.size)
        return rows[order], cols[order], position[inv]

    def blocked_sparse(
        self,
        bm: int | None = None,
        bk: int | None = None,
        *,
        ring: bool = False,
        dtype=np.float32,
        cells: np.ndarray | None = None,
        weights: np.ndarray | None = None,
    ) -> BlockedSparseLayout:
        """Every cell's BCSR layout on the host (see BlockedSparseLayout;
        the JAX package's full form).  ``cells`` (bool [R, C]) stores tile
        data only for the selected cells; the others get the minimal
        filler list.  ``ring=True`` (item 7) and ``weights`` (item 11)
        raise ``NotImplementedError``."""
        _no_ring_or_weights(ring, weights)
        bm, bk = self._tile_dims(bm, bk)
        R, C = self.R, self.C
        num_tr = C * self.chunk // bm
        sel = np.ones((R, C), bool) if cells is None else np.asarray(cells, bool)
        empty = (np.arange(num_tr, dtype=np.int64), np.zeros(num_tr, np.int64), None)
        lists = [[self._cell_tile_order(i, j, bm, bk) if sel[i, j] else empty
                  for j in range(C)] for i in range(R)]
        t_max = max(rows.size for row in lists for rows, _, _ in row)
        tile_rows = np.full((R, C, t_max), num_tr - 1, np.int32)
        tile_cols = np.zeros((R, C, t_max), np.int32)
        tiles = np.zeros((R, C, t_max, bm, bk), dtype)
        nnz = np.zeros((R, C), np.int64)
        for i in range(R):
            for j in range(C):
                rows, cols, arc_tile = lists[i][j]
                tile_rows[i, j, : rows.size] = rows
                tile_cols[i, j, : cols.size] = cols
                if sel[i, j]:
                    d, s = self._cell_arcs(i, j)
                    tiles[i, j, arc_tile, d % bm, s % bk] = 1
                    nnz[i, j] = self._tile_pass(bm, bk)[i][j][0].size
        return BlockedSparseLayout(
            bm=bm, bk=bk, R=R, C=C, chunk=self.chunk, nnz_tiles=nnz,
            tiles=tiles, tile_rows=tile_rows, tile_cols=tile_cols,
        )

    def blocked_hybrid(
        self,
        bm: int | None = None,
        bk: int | None = None,
        *,
        dense_cells: np.ndarray,
        ring: bool = False,
        dtype=np.float32,
        weights: np.ndarray | None = None,
    ) -> HybridLayout:
        """The JAX package's mixed host layout (see HybridLayout):
        ``dense_cells`` (bool [R, C], the per-cell kernel choice) get their
        dense block, the others their tiles."""
        _no_ring_or_weights(ring, weights)
        dense_cells = np.asarray(dense_cells, bool)
        if dense_cells.shape != (self.R, self.C):
            raise ValueError(f"dense_cells shape {dense_cells.shape} != grid {(self.R, self.C)}")
        sparse = self.blocked_sparse(bm, bk, dtype=dtype, cells=~dense_cells)
        blocks = np.zeros((self.R, self.C, self.C * self.chunk, self.R * self.chunk), np.float32)
        for i in range(self.R):
            for j in range(self.C):
                if dense_cells[i, j]:
                    d, s = self._cell_arcs(i, j)
                    blocks[i, j, d, s] = 1
        return HybridLayout(dense_cells=dense_cells, blocks=blocks, sparse=sparse)

    def cell_blocked_sparse(
        self, i: int, j: int, bm: int | None = None, bk: int | None = None, device=None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cell (i, j)'s BCSR tile list, built on ``device``: ``(tiles f32
        [T, bm, bk], tile_rows i32 [T], tile_cols i32 [T], row_ptr i32
        [C·chunk/bm + 1])``, row-sorted and row-complete, with no padding
        to a uniform T (each rank holds only its own cell).  The host
        computes only the tile indices; the tile data is written on the
        device from the cell's arcs, so the host never holds it (15.7 GB at
        the 1×1 grid of R-MAT scale 16 and tile 128)."""
        bm, bk = self._tile_dims(bm, bk)
        rows, cols, arc_tile = self._cell_tile_order(i, j, bm, bk)
        d, s = self._cell_arcs(i, j)
        flat = (arc_tile * bm + d % bm) * bk + s % bk
        tiles = torch.zeros(rows.size * bm * bk, dtype=torch.float32, device=device)
        tiles[torch.from_numpy(flat).to(device)] = 1
        row_ptr = np.searchsorted(rows, np.arange(self.C * self.chunk // bm + 1))
        return (
            tiles.view(rows.size, bm, bk),
            *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (rows, cols, row_ptr)),
        )


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
