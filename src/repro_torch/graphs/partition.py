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

Weighted layouts: every builder takes ``weights`` (f32 [num_arcs] in the
graph's arc order) and stores the edge weights in place of the 0/1
values, 0 meaning "no arc" — the bucketed traversal's operands.

Ring layouts (the ``overlap="expand"`` / ``"expand+fold"`` schedules):
at ring step t rank (i, j) holds the owned chunk of grid row
``r = (i − t) mod R`` and must process exactly the arcs or tiles sourced
in that chunk, so each cell's operand is re-sliced by source row-chunk
into R slots: :meth:`TwoDPartition.ring_arcs` (arc slots),
``blocked_sparse(ring=True)`` (tile slots, column ids re-based to the
chunk) in the JAX package's host form, and the per-cell forms a rank
holds on its device: :meth:`TwoDPartition.cell_ring_arcs`,
:meth:`TwoDPartition.cell_dense_slabs` (the dense block as R contiguous
column slabs) and :meth:`TwoDPartition.cell_ring_blocked_sparse`.

The same graph and grid give the same arrays as the JAX package's
partitioner (:mod:`repro_torch.interop` carries one across).
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


def _arc_tile_unique(d: np.ndarray, s: np.ndarray, bm: int, bk: int, num_tc: int,
                     inverse: bool = True):
    """The arc→tile unique pass of one grid cell: maps its (dst_local,
    src_local) arc pairs onto the (bm × bk) tile grid and deduplicates.
    Returns ``(r_u, c_u, inv)`` — the unique tile row/col ids (sorted by
    row-major key, i64) and the arc→unique-tile inverse map (None unless
    ``inverse``: the counts need none, and a plain sort is ~4x cheaper).
    The key is int64: an int32 one wraps past 2^31 tiles (R-MAT scale 23
    on one cell at tile 128 has 2^32)."""
    key = (d.astype(np.int64) // bm) * num_tc + (s // bk)
    if inverse:
        uniq, inv = np.unique(key, return_inverse=True)
    else:
        key.sort()
        uniq = key[np.concatenate(([True], key[1:] != key[:-1]))] if key.size else key
        inv = None
    return uniq // num_tc, uniq % num_tc, inv


def _distinct_sorted(a: np.ndarray) -> int:
    """Distinct values of a sorted array (``np.unique(a).size`` without
    its hash path, which some numpy versions take and which is slow on
    10^8 values)."""
    return int(np.count_nonzero(a[1:] != a[:-1])) + 1 if a.size else 0


def default_tile_dim(chunk: int, preferred: int = 128) -> int:
    """Largest divisor of ``chunk`` ≤ ``preferred``, preferring multiples
    of 8.  Tile dims divide ``chunk`` so that tiles never straddle a chunk
    boundary (the ring schedule slices by chunk)."""
    divisors = [d for d in range(1, min(chunk, preferred) + 1) if chunk % d == 0]
    lane_aligned = [d for d in divisors if d % 8 == 0]
    return max(lane_aligned or divisors)


def _row_complete(r_u: np.ndarray, c_u: np.ndarray, num_tr: int):
    """A tile list made row-complete: one zero filler (tile-col 0) appended
    for every tile-row absent from ``r_u``, then stably sorted by row.
    Returns ``(rows, cols, position)``: the stored list and the stored
    position of each input tile."""
    missing = np.setdiff1d(np.arange(num_tr, dtype=np.int64), r_u)
    rows = np.concatenate([r_u, missing])
    cols = np.concatenate([c_u, np.zeros(missing.size, np.int64)])
    order = np.argsort(rows, kind="stable")
    position = np.empty(order.size, np.int64)
    position[order] = np.arange(order.size)
    return rows[order], cols[order], position[: r_u.size]


def _check_ring_weights(ring: bool, weights) -> None:
    if ring and weights is not None:
        raise ValueError(
            "weighted tiles are barrier-schedule only (ring pipelining of the bucketed "
            "relaxation is not implemented); build with ring=False"
        )


@dataclasses.dataclass(frozen=True)
class BlockedSparseLayout:
    """Host-side BCSR layout of every cell, in the JAX package's form
    (small graphs and tests: the engines build their own cell on its
    device with :meth:`TwoDPartition.cell_blocked_sparse` /
    :meth:`TwoDPartition.cell_ring_blocked_sparse`).

    Attributes:
      bm, bk:     tile shape (rows × cols); both divide ``chunk``.
      tiles:      [R, C, T, bm, bk] tile data (0/1 values).
      tile_rows:  i32 [R, C, T] output tile-row of each stored tile (into
                  the [C·chunk/bm] grid), non-decreasing along T.
      tile_cols:  i32 [R, C, T] operand tile-col (into [R·chunk/bk]).
      nnz_tiles:  i64 [R, C] true nonzero-tile count per cell (fillers and
                  padding excluded).
      ring_*:     the ring form (``ring=True``): slot r of [R, C, R, Tr, ...]
                  holds the cell's tiles sourced in grid row r's chunk,
                  ``ring_tile_cols`` re-based to [0, chunk/bk).
    Every tile-row of a cell (of a slot) holds at least one (possibly
    all-zero filler) tile, and cells (slots) are padded with zero tiles on
    their last tile-row to the worst one's T.  Exactly one of the two forms
    is built; the other's arrays are None.
    """

    bm: int
    bk: int
    R: int
    C: int
    chunk: int
    nnz_tiles: np.ndarray
    tiles: np.ndarray | None = None
    tile_rows: np.ndarray | None = None
    tile_cols: np.ndarray | None = None
    ring_tiles: np.ndarray | None = None
    ring_tile_rows: np.ndarray | None = None
    ring_tile_cols: np.ndarray | None = None

    @property
    def num_tile_rows(self) -> int:
        return self.C * self.chunk // self.bm

    @property
    def num_tile_cols(self) -> int:
        return self.R * self.chunk // self.bk

    def adjacency_bytes(self, dtype_bytes: int = 4) -> int:
        """Stored per-device adjacency bytes (tile data + index maps) of the
        form built, padding included."""
        cells = self.R * self.C
        tiles, rows, cols = ((self.ring_tiles, self.ring_tile_rows, self.ring_tile_cols)
                             if self.ring_tiles is not None
                             else (self.tiles, self.tile_rows, self.tile_cols))
        return tiles.size // cells * dtype_bytes + (rows.size + cols.size) // cells * 4


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

    # ---------------------------------------------------- ring arc slots
    def _cell_ring_slots(self, i: int, j: int) -> list[tuple[np.ndarray, np.ndarray]]:
        """Cell (i, j)'s true arcs split by source row-chunk: slot r holds
        ``(src_local mod chunk, dst_local)`` of the arcs sourced in global
        chunk ``j·R + r``, in slot order."""
        d, s = self._cell_arcs(i, j)
        r_all = s // self.chunk
        return [(s[r_all == r] % self.chunk, d[r_all == r]) for r in range(self.R)]

    def ring_arcs(self, arc_pad_multiple: int = 8) -> tuple[np.ndarray, np.ndarray]:
        """The ring-sliced arc layout: ``(ring_src, ring_dst)`` int32
        [R, C, R, max_ring_arcs], slot (i, j, r) holding cell (i, j)'s arcs
        sourced in global chunk ``j·R + r``.  ``ring_src`` is chunk-relative
        ([0, chunk): it indexes the chunk in hand, not the gathered slice),
        ``ring_dst`` as ``dst_local`` ([0, C·chunk], sentinel-padded);
        padding slots hold src 0 / dst sentinel (the discarded row)."""
        R, C = self.R, self.C
        max_ring = self.ring_arcs_max(arc_pad_multiple)
        ring_src = np.zeros((R, C, R, max_ring), np.int32)
        ring_dst = np.full((R, C, R, max_ring), C * self.chunk, np.int32)
        for i in range(R):
            for j in range(C):
                for r, (s_r, d_r) in enumerate(self._cell_ring_slots(i, j)):
                    ring_src[i, j, r, : s_r.size] = s_r
                    ring_dst[i, j, r, : d_r.size] = d_r
        return ring_src, ring_dst

    def ring_arcs_max(self, arc_pad_multiple: int = 8) -> int:
        """``max_ring_arcs`` of :meth:`ring_arcs` without building it: the
        worst (cell, slot) arc count, padded to ``arc_pad_multiple``.  The
        ring arc layout holds 2·R·max_ring_arcs indices a rank, which the
        memory guard prices under a ring schedule."""
        max_ring = 1
        for i in range(self.R):
            for j in range(self.C):
                _, s = self._cell_arcs(i, j)
                if s.size:
                    max_ring = max(max_ring, int(np.bincount(s // self.chunk,
                                                             minlength=self.R).max()))
        return max_ring + (-max_ring) % arc_pad_multiple

    def cell_ring_arcs(self, i: int, j: int, device=None,
                       arc_pad_multiple: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
        """Cell (i, j)'s ring arc slots on ``device``: ``(ring_src,
        ring_dst)`` int64 [R, max_ring_arcs], equal to ``ring_arcs()[k][i,
        j]`` (the same worst-slot padding on every rank)."""
        max_ring = self.ring_arcs_max(arc_pad_multiple)
        ring_src = np.zeros((self.R, max_ring), np.int64)
        ring_dst = np.full((self.R, max_ring), self.C * self.chunk, np.int64)
        for r, (s_r, d_r) in enumerate(self._cell_ring_slots(i, j)):
            ring_src[r, : s_r.size] = s_r
            ring_dst[r, : d_r.size] = d_r
        return (torch.from_numpy(ring_src).to(device), torch.from_numpy(ring_dst).to(device))

    def arc_weights(self, w: np.ndarray) -> np.ndarray:
        """The graph's f32 [num_arcs] weights in the partitioned slot
        layout: f32 [R, C, max_arcs] aligned with ``src_local`` /
        ``dst_local``, 0 at padding slots (the dense layouts' "no arc")."""
        if self.arc_perm is None:
            raise ValueError("arc_weights needs arc_perm (partition_arcs_2d output)")
        w = np.asarray(w, np.float32)
        valid = self.arc_perm >= 0
        return np.where(valid, w[np.clip(self.arc_perm, 0, None)], np.float32(0)).astype(
            np.float32
        )

    def _cell_values(self, i: int, j: int, weights: np.ndarray | None):
        """The values of cell (i, j)'s true arcs, in :meth:`_cell_arcs`
        order: 1, or their weights (graph arc order in)."""
        if weights is None:
            return 1
        perm = self.arc_perm[i, j]
        return np.asarray(weights, np.float32)[perm[perm >= 0]]

    def dense_blocks(self, dtype=np.float32, weights: np.ndarray | None = None) -> np.ndarray:
        """Dense per-device adjacency blocks [R, C, C·chunk, R·chunk] on the
        host (small graphs and tests only: the engines build one cell on
        its device with :meth:`cell_dense_block`).

        Block (i, j) is A[rows_i, cols_j] in the local index spaces the
        collectives use: rows index the [C·chunk] fold partial, columns
        index the [R·chunk] column-gathered frontier.  With ``weights`` the
        blocks hold edge weights instead of 0/1.
        """
        blocks = np.zeros(
            (self.R, self.C, self.C * self.chunk, self.R * self.chunk), dtype
        )
        for i in range(self.R):
            for j in range(self.C):
                d, s = self._cell_arcs(i, j)
                blocks[i, j, d, s] = self._cell_values(i, j, weights)
        return blocks

    def cell_dense_block(
        self, i: int, j: int, dtype: torch.dtype = torch.float32, device=None,
        weights: np.ndarray | None = None,
    ) -> torch.Tensor:
        """Cell (i, j)'s [C·chunk, R·chunk] 0/1 block (or weight block, with
        ``weights``), built on ``device`` from that cell's arcs, so the host
        never holds an n²/p matrix (17.2 GB in f32 for the 1×1 grid at
        n = 65 536)."""
        d, s = self._cell_arcs(i, j)
        block = torch.zeros(
            (self.C * self.chunk, self.R * self.chunk), dtype=dtype, device=device
        )
        index = (torch.from_numpy(d).to(device=device, dtype=torch.int64),
                 torch.from_numpy(s).to(device=device, dtype=torch.int64))
        if weights is None:
            block[index] = 1
        else:
            block[index] = torch.from_numpy(self._cell_values(i, j, weights)).to(device, dtype)
        return block

    def cell_dense_slabs(
        self, i: int, j: int, dtype: torch.dtype = torch.float32, device=None,
    ) -> torch.Tensor:
        """Cell (i, j)'s dense block as R contiguous column slabs, [R,
        C·chunk, chunk]: slab r is ``A[rows_i, cols_j][:, r·chunk:(r+1)·chunk]``,
        the operand of ring step r (K3/K4 take no strided view).  Built on
        ``device`` from the cell's arcs, once: the slabs hold exactly the
        block's bytes."""
        d, s = self._cell_arcs(i, j)
        slabs = torch.zeros((self.R, self.C * self.chunk, self.chunk), dtype=dtype,
                            device=device)
        index = tuple(torch.from_numpy(a).to(device=device, dtype=torch.int64)
                      for a in (s // self.chunk, d, s % self.chunk))
        slabs[index] = 1
        return slabs

    # ------------------------------------------------ blocked-sparse layout
    def tile_candidates(self, limit: int = 3) -> list[tuple[int, int]]:
        """Square BCSR (bm, bk) tiles for the autotuner to time: divisors
        of ``chunk`` ≤ 128, multiples of 8 where any exist, largest first,
        at most ``limit`` (the JAX package's menu).  The first is always
        :func:`default_tile_dim`'s pick, the tile an untuned run builds."""
        divisors = [d for d in range(1, min(self.chunk, 128) + 1) if self.chunk % d == 0]
        lane = [d for d in divisors if d % 8 == 0] or divisors
        return [(d, d) for d in sorted(lane, reverse=True)[: max(1, limit)]]

    def _tile_dims(self, bm: int | None, bk: int | None) -> tuple[int, int]:
        bm = default_tile_dim(self.chunk) if bm is None else bm
        bk = default_tile_dim(self.chunk) if bk is None else bk
        if bm < 1 or bk < 1 or self.chunk % bm or self.chunk % bk:
            raise ValueError(
                f"tile dims ({bm}, {bk}) must divide chunk={self.chunk} "
                "(ring-chunk slicing needs tile-aligned chunk boundaries)"
            )
        return bm, bk

    def _tile_pass(self, bm: int, bk: int, inverse: bool = False) -> list[list[tuple]]:
        """The one arc→tile pass per (bm, bk), cached on the partition:
        ``result[i][j] = (r_u, c_u, inv)`` of :func:`_arc_tile_unique`.
        The counts, the hybrid choice, the memory guard and the layout
        builds all read it, so a run sorts each cell's arcs once; the
        inverse map, which only the layout builds read, is computed (once)
        when one first asks for it."""
        cache = self.__dict__.setdefault("_tile_pass_cache", {})
        have = cache.get((bm, bk))
        if have is None or (inverse and have[0][0][2] is None):
            num_tc = self.R * self.chunk // bk
            cache[(bm, bk)] = [
                [_arc_tile_unique(*self._cell_arcs(i, j), bm, bk, num_tc, inverse)
                 for j in range(self.C)]
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
        stores R per-slot slices each with its own fillers, padded to the
        worst slot.
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
                full_cell[i, j] = r_u.size + num_tr - _distinct_sorted(r_u)
                slot_max = 0
                for r in range(R):
                    rows_r = r_u[(c_u // cpk) == r]
                    slot_max = max(slot_max, rows_r.size + num_tr - _distinct_sorted(rows_r))
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
        r_u, c_u, inv = self._tile_pass(bm, bk, inverse=True)[i][j]
        rows, cols, position = _row_complete(r_u, c_u, self.C * self.chunk // bm)
        return rows, cols, position[inv]

    def _slot_tile_orders(self, i: int, j: int, bm: int, bk: int) -> list[tuple]:
        """Cell (i, j)'s ring slots without data: for each r, ``(rows,
        cols, arcs, arc_tile)`` — slot r's row-complete tile list (tiles
        sourced in grid row r's chunk, tile-cols re-based to the chunk),
        the cell arcs (positions in :meth:`_cell_arcs` order) it holds
        and the stored position of each one's tile."""
        r_u, c_u, inv = self._tile_pass(bm, bk, inverse=True)[i][j]
        num_tr, cpk = self.C * self.chunk // bm, self.chunk // bk
        slot_of = c_u // cpk
        out = []
        for r in range(self.R):
            pick = slot_of == r
            rows, cols, position = _row_complete(r_u[pick], c_u[pick] - r * cpk, num_tr)
            within = np.cumsum(pick) - 1  # unique tile -> its index among the picked
            arcs = np.flatnonzero(pick[inv])
            out.append((rows, cols, arcs, position[within[inv[arcs]]]))
        return out

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
        the JAX package's form): the full tile list, or with ``ring=True``
        the R per-slot lists of the ring schedules.  ``cells`` (bool
        [R, C]) stores tile data only for the selected cells; the others
        get the minimal filler list; ``weights`` stores edge weights instead
        of 0/1 (full form only: a weighted ring layout raises
        ``ValueError``, as in the JAX package)."""
        _check_ring_weights(ring, weights)
        bm, bk = self._tile_dims(bm, bk)
        R, C = self.R, self.C
        num_tr = C * self.chunk // bm
        sel = np.ones((R, C), bool) if cells is None else np.asarray(cells, bool)
        empty = (np.arange(num_tr, dtype=np.int64), np.zeros(num_tr, np.int64),
                 np.zeros(0, np.int64), np.zeros(0, np.int64))
        # per cell, its list of (rows, cols, arcs, arc_tile): one entry, or R slots
        lists = []
        for i in range(R):
            for j in range(C):
                if not sel[i, j]:
                    lists.append([empty] * (R if ring else 1))
                elif ring:
                    lists.append(self._slot_tile_orders(i, j, bm, bk))
                else:
                    rows, cols, arc_tile = self._cell_tile_order(i, j, bm, bk)
                    lists.append([(rows, cols, np.arange(arc_tile.size), arc_tile)])
        t_max = max(1, max(e[0].size for cell in lists for e in cell))
        lead = (R, C, R) if ring else (R, C)
        tile_rows = np.full(lead + (t_max,), num_tr - 1, np.int32)
        tile_cols = np.zeros(lead + (t_max,), np.int32)
        tiles = np.zeros(lead + (t_max, bm, bk), dtype)
        nnz = np.zeros((R, C), np.int64)
        for i in range(R):
            for j in range(C):
                d, s = self._cell_arcs(i, j)
                values = self._cell_values(i, j, weights)
                for r, (rows, cols, arcs, arc_tile) in enumerate(lists[i * C + j]):
                    at = (i, j, r) if ring else (i, j)
                    tile_rows[at][: rows.size] = rows
                    tile_cols[at][: cols.size] = cols
                    vals = values if np.isscalar(values) else values[arcs]
                    tiles[at][arc_tile, d[arcs] % bm, s[arcs] % bk] = vals
                if sel[i, j]:
                    nnz[i, j] = self._tile_pass(bm, bk)[i][j][0].size
        form = "ring_" if ring else ""
        return BlockedSparseLayout(
            bm=bm, bk=bk, R=R, C=C, chunk=self.chunk, nnz_tiles=nnz,
            **{f"{form}tiles": tiles, f"{form}tile_rows": tile_rows,
               f"{form}tile_cols": tile_cols},
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
        dense block, the others their tiles (the ring slots with
        ``ring=True``); ``weights`` threads edge weights into both sides."""
        _check_ring_weights(ring, weights)
        dense_cells = np.asarray(dense_cells, bool)
        if dense_cells.shape != (self.R, self.C):
            raise ValueError(f"dense_cells shape {dense_cells.shape} != grid {(self.R, self.C)}")
        sparse = self.blocked_sparse(bm, bk, ring=ring, dtype=dtype, cells=~dense_cells,
                                     weights=weights)
        blocks = np.zeros((self.R, self.C, self.C * self.chunk, self.R * self.chunk), np.float32)
        for i in range(self.R):
            for j in range(self.C):
                if dense_cells[i, j]:
                    d, s = self._cell_arcs(i, j)
                    blocks[i, j, d, s] = self._cell_values(i, j, weights)
        return HybridLayout(dense_cells=dense_cells, blocks=blocks, sparse=sparse)

    def cell_blocked_sparse(
        self, i: int, j: int, bm: int | None = None, bk: int | None = None, device=None,
        weights: np.ndarray | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cell (i, j)'s BCSR tile list, built on ``device``: ``(tiles f32
        [T, bm, bk], tile_rows i32 [T], tile_cols i32 [T])``, row-sorted
        and row-complete, with no padding to a uniform T (each rank holds
        only its own cell); ``weights`` stores edge weights instead of
        0/1.  The host computes only the tile indices; the tile data is
        written on the device from the cell's arcs, so the host never holds
        it (15.7 GB at the 1×1 grid of R-MAT scale 16 and tile 128)."""
        bm, bk = self._tile_dims(bm, bk)
        rows, cols, arc_tile = self._cell_tile_order(i, j, bm, bk)
        d, s = self._cell_arcs(i, j)
        flat = (arc_tile * bm + d % bm) * bk + s % bk
        tiles = torch.zeros(rows.size * bm * bk, dtype=torch.float32, device=device)
        values = self._cell_values(i, j, weights)
        tiles[torch.from_numpy(flat).to(device)] = (
            values if weights is None else torch.from_numpy(values).to(device))
        return (
            tiles.view(rows.size, bm, bk),
            *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (rows, cols)),
        )

    def cell_ring_blocked_sparse(
        self, i: int, j: int, bm: int | None = None, bk: int | None = None, device=None,
    ) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Cell (i, j)'s ring slots built on ``device``: for each r, slot
        r's ``(tiles f32 [T_r, bm, bk], tile_rows i32 [T_r], tile_cols i32
        [T_r])`` — the tiles sourced in grid row r's chunk, row-complete,
        tile-cols re-based to [0, chunk/bk), no padding: the JAX ring
        layout's slot (i, j, r) without its pad.  Each slot is the operand
        of ring step r (K5/K6 at m = C·chunk, k = chunk)."""
        bm, bk = self._tile_dims(bm, bk)
        d, s = self._cell_arcs(i, j)
        slots = []
        for rows, cols, arcs, arc_tile in self._slot_tile_orders(i, j, bm, bk):
            flat = (arc_tile * bm + d[arcs] % bm) * bk + s[arcs] % bk
            tiles = torch.zeros(rows.size * bm * bk, dtype=torch.float32, device=device)
            tiles[torch.from_numpy(flat).to(device)] = 1
            slots.append((tiles.view(rows.size, bm, bk),
                          *(torch.from_numpy(a.astype(np.int32)).to(device)
                            for a in (rows, cols))))
        return slots


def _partition_one_cell(src, dst, n: int, arc_pad_multiple: int,
                        max_arcs: int | None) -> TwoDPartition:
    """:func:`partition_arcs_2d` on a 1 × 1 grid, the same arrays without
    the general path's passes: the cell holds every arc in input order,
    its local indices the global ones (chunk = n)."""
    m = int(np.size(src))
    if max_arcs is None:
        max_arcs = max(m, 1)
        max_arcs += (-max_arcs) % arc_pad_multiple
    elif m > max_arcs:
        raise ValueError(f"max_arcs={max_arcs} < worst cell {m}")
    out_src = np.zeros((1, 1, max_arcs), dtype=np.int32)
    out_dst = np.full((1, 1, max_arcs), n, dtype=np.int32)
    out_perm = np.full((1, 1, max_arcs), -1, dtype=np.int64)
    out_src[0, 0, :m] = src
    out_dst[0, 0, :m] = dst
    out_perm[0, 0, :m] = np.arange(m)
    return TwoDPartition(R=1, C=1, n=n, chunk=n, src_local=out_src, dst_local=out_dst,
                         arc_counts=np.full((1, 1), m, dtype=np.int64), arc_perm=out_perm)


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
    if R * C == 1:
        return _partition_one_cell(src, dst, n, arc_pad_multiple, max_arcs)
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
    # one cell holds every arc in input order (the stable sort's order)
    order = np.arange(cell.size) if R * C == 1 else np.argsort(cell, kind="stable")
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
