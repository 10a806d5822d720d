"""Per-engine adjacency and state bytes of the 2-D distributed path.

The quantities the memory guard, the per-cell dense/BCSR choice and the
chip smoke test's bounds read, keyed by the port's engine names:

  sparse         arc list (src, dst) per cell
  fused          dense f32 block [C·chunk, R·chunk] per cell (K3/K4)
  fused_bf16     the same block in bf16
  fused_sparse   the cell's stored BCSR tiles (K5/K6)
  fused_hybrid   per cell, the representation its choice picked

The JAX package's TPU rates and constants have no counterpart here;
the card's memory capacity reaches the guard as an input
(:func:`repro_torch.core.distributed.check_device_memory`).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "TILE_OVERHEAD_BYTES",
    "sparse_tile_bytes",
    "cell_kernel_choice",
    "exchange_operands",
    "adjacency_stream_bytes",
    "device_hbm_footprint",
]

#: payload tensors per exchanged direction: the arc-list engine ships one
#: pre-masked tensor; the fused engines (dense block, BCSR, and the
#: per-cell hybrid of the two) ship (σ, d) forward and (σ, d, δ, ω)
#: backward (paper §3.2 exchange set).
_EXCHANGE_OPERANDS = {
    "sparse": (1, 1),
    "fused": (2, 4),
    "fused_bf16": (2, 4),
    "fused_sparse": (2, 4),
    "fused_hybrid": (2, 4),
}

#: per-stored-tile overhead allowance of the BCSR kernels in equivalent
#: bytes (the 8 B index maps plus per-tile control), used only by the
#: per-cell dense/BCSR choice (:func:`cell_kernel_choice`); the memory
#: guard prices the stored bytes (:func:`sparse_tile_bytes`) without it.
TILE_OVERHEAD_BYTES = 32.0


def sparse_tile_bytes(bm: int, bk: int, elem: int = 4) -> int:
    """Stored bytes of one BCSR tile: data + 8 B of index maps."""
    return bm * bk * elem + 8


def cell_kernel_choice(
    stored_tiles_cell: np.ndarray,
    *,
    R: int,
    C: int,
    chunk: int,
    bm: int,
    bk: int,
    threshold: float = 1.0,
    elem: int = 4,
) -> np.ndarray:
    """Per-cell dense-vs-BCSR pick (bool [R, C], True = dense).

    Prices what each cell streams per traversal level:

        dense:  (C·chunk)·(R·chunk)·elem
        BCSR:   stored · (bm·bk·elem + 8 + TILE_OVERHEAD_BYTES)

    and picks dense where ``bcsr >= threshold · dense``.
    ``stored_tiles_cell`` is the per-cell stored tile count (nonzero tiles
    + fillers, ``TwoDPartition.blocked_sparse_counts()["stored_full_cell"]``).
    ``threshold`` 0 forces every cell dense, a huge value every cell
    sparse, 1.0 is the break-even.  (A measured calibration pair, the JAX
    package's ``measured=``, waits for the autotuner: ROADMAP item 9.)
    """
    stored = np.asarray(stored_tiles_cell, np.float64)
    if stored.shape != (R, C):
        raise ValueError(f"stored_tiles_cell shape {stored.shape} != {(R, C)}")
    dense_bytes = float(C * chunk) * (R * chunk) * elem
    bcsr_bytes = stored * (sparse_tile_bytes(bm, bk, elem) + TILE_OVERHEAD_BYTES)
    return bcsr_bytes >= threshold * dense_bytes


def exchange_operands(engine_kind: str) -> tuple[int, int]:
    """(forward, backward) per-level exchange-operand counts of an engine."""
    return _EXCHANGE_OPERANDS[engine_kind]


def adjacency_stream_bytes(
    engine_kind: str,
    *,
    R: int,
    C: int,
    chunk: int,
    nnz_tiles: int | None = None,
    bm: int | None = None,
    bk: int | None = None,
    max_arcs: int | None = None,
    dense_cell: bool | None = None,
) -> float:
    """Per-device adjacency bytes of one engine: what a rank stores and
    streams once per traversal level.

    fused / fused_bf16   (C·chunk)·(R·chunk)·elem — the full block
    fused_sparse         nnz_tiles · (bm·bk·4 + 8) — tiles + index maps
    sparse               2·max_arcs·4 — (src, dst) i32
    fused_hybrid         the rank's chosen representation: the f32 block
                         where ``dense_cell``, else its tiles.  (The JAX
                         package's hybrid ships the union of both on every
                         device, for shard_map's uniform shapes; one rank
                         per device holds only its own choice.)

    ``nnz_tiles`` is the tile count to price: the layout's stored count
    for the bytes a rank holds.  A rank's ``row_ptr`` (C·chunk/bm + 1 i32)
    is left out, as the JAX model leaves out its grid bookkeeping.
    """
    if engine_kind in ("fused", "fused_bf16"):
        elem = 2 if engine_kind == "fused_bf16" else 4
        return float(C * chunk) * (R * chunk) * elem
    if engine_kind == "fused_hybrid" and dense_cell is None:
        raise ValueError("fused_hybrid needs dense_cell (the rank's choice)")
    if engine_kind == "fused_hybrid" and dense_cell:
        return adjacency_stream_bytes("fused", R=R, C=C, chunk=chunk)
    if engine_kind in ("fused_sparse", "fused_hybrid"):
        if None in (nnz_tiles, bm, bk):
            raise ValueError(f"{engine_kind} needs nnz_tiles, bm, bk")
        return float(nnz_tiles) * sparse_tile_bytes(bm, bk)
    if engine_kind == "sparse":
        if max_arcs is None:
            raise ValueError("sparse needs max_arcs")
        return float(2 * max_arcs) * 4
    raise ValueError(f"unknown distributed engine {engine_kind!r}")


def device_hbm_footprint(
    engine_kind: str,
    *,
    R: int,
    C: int,
    chunk: int,
    batch_size: int,
    nnz_tiles: int | None = None,
    bm: int | None = None,
    bk: int | None = None,
    max_arcs: int | None = None,
    dense_cell: bool | None = None,
) -> dict:
    """Per-device memory footprint (bytes) of one distributed BC round.

    ``adjacency``: the resident graph operand (:func:`adjacency_stream_bytes`).
    ``state``: owned (σ, δ f32 + d i32) columns, ω and the bc accumulator,
    the worst-case gathered operand slice ([R·chunk, s] × exchanged
    tensors, backward) and the [C·chunk, s] fold partial.  An estimate for
    fail-fast guarding: temporaries add a constant factor, while the
    dense-block overflow the guard exists to catch is orders of magnitude.
    """
    s = batch_size
    adjacency = adjacency_stream_bytes(
        engine_kind, R=R, C=C, chunk=chunk, nnz_tiles=nnz_tiles, bm=bm, bk=bk,
        max_arcs=max_arcs, dense_cell=dense_cell,
    )
    _, bwd_operands = _EXCHANGE_OPERANDS[engine_kind]
    state = (
        3 * chunk * s * 4  # owned σ, d, δ
        + 2 * chunk * 4  # ω, bc accumulator
        + bwd_operands * R * chunk * s * 4  # gathered operand slice (worst: bwd)
        + C * chunk * s * 4  # pre-fold partial
    )
    return {
        "engine_kind": engine_kind,
        "adjacency_bytes": float(adjacency),
        "state_bytes": float(state),
        "total_bytes": float(adjacency + state),
    }
