"""Per-engine adjacency and state bytes of the 2-D distributed path.

The quantities the memory guard, the per-cell dense/BCSR choice and the
chip smoke test's bounds read, keyed by the port's engine names (and
:func:`sampled_run_seconds`, the wall estimate of a sampled run):

  sparse         arc list (src, dst) per cell
  fused          dense f32 block [C·chunk, R·chunk] per cell (K3/K4)
  fused_bf16     the same block in bf16
  fused_sparse   the cell's stored BCSR tiles (K5/K6)
  fused_hybrid   per cell, the representation its choice picked

and the level-time model behind ``overlap="auto"``
(:func:`overlap_step_time`, :func:`auto_overlap_policy`), priced with a
:class:`HardwareSpec`.  Its one instance, :data:`H100`, holds H100 SXM
data-sheet rates; none of the JAX package's TPU constants is used here.
The card's memory capacity reaches the guard as an input
(:func:`repro_torch.core.distributed.check_device_memory`).

The roofline terms of a measured piece of work (:func:`roofline_terms`,
the JAX package's model, priced with a :class:`HardwareSpec`): per device

    compute    = FLOP / peak_flops
    memory     = bytes / hbm_bandwidth
    collective = link bytes / link_bandwidth

where the link bytes weight each collective's operand bytes by the ring
algorithm (g = group size): all-gather (g−1)·operand (the operand is the
shard), reduce-scatter and all-to-all (g−1)/g·operand, all-reduce
2·(g−1)/g·operand, a collective-permute (one ring hop) its operand.  The
records are those of :class:`repro_torch.roofline.counter.WorkCounter`
(the JAX package reads them from the compiled HLO).  :func:`ring_steps`
counts the hops they imply and :func:`ring_latency_s` prices them at the
per-hop α.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "HardwareSpec",
    "H100",
    "RooflineTerms",
    "roofline_terms",
    "link_bytes",
    "ring_steps",
    "ring_latency_s",
    "overlap_step_time",
    "auto_overlap_policy",
    "TILE_OVERHEAD_BYTES",
    "sparse_tile_bytes",
    "cell_kernel_choice",
    "exchange_operands",
    "adjacency_stream_bytes",
    "device_hbm_footprint",
    "sampled_run_seconds",
]

@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """The rates one traversal level is priced with."""

    name: str
    peak_flops: float  #: the engines' arithmetic rate, FLOP/s per card
    hbm_bandwidth: float  #: device memory, bytes/s per card
    link_bandwidth: float  #: bytes/s one direction between two cards
    hop_latency_s: float  #: α, the fixed cost of one ring hop


#: H100 SXM data sheet: f32 FFMA (the exact engines use no tensor cores),
#: HBM3 3.35 TB/s, NVLink 4 at 450 GB/s a direction.  The per-hop α is an
#: assumption (an NCCL point-to-point launch and its sync), not a
#: measurement: a one-card machine has no NVLink hop to time, and a gloo
#: hop on the host says nothing of one.  Where the autotuner has measured
#: walls, the seams read those instead of this model.
H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=67e12,
    hbm_bandwidth=3.35e12,
    link_bandwidth=450e9,
    hop_latency_s=10e-6,
)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    link_bytes: float
    bottleneck: str
    model_flops_total: float
    useful_fraction: float  #: model FLOP / (counted FLOP × devices)
    ring_steps: int = 0  #: ring hops the collectives imply
    ring_latency_s: float = 0.0  #: α term: ring_steps · per-hop latency

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """The dominant term's share of the three summed: 1.0 when one
        term is all of it, lower the more the others could overlap it."""
        total = self.compute_s + self.memory_s + self.collective_s
        return self.step_time_s / total if total > 0 else 0.0


def link_bytes(coll_records: list[dict]) -> float:
    """Bytes the recorded collectives put on one device's links (the ring
    weights of the module docstring)."""
    total = 0.0
    for rec in coll_records:
        g = max(rec.get("group_size", 1), 1)
        b = rec["operand_bytes"]
        cls = rec["class"]
        if cls == "all-gather":
            total += (g - 1) * b
        elif cls in ("reduce-scatter", "all-to-all"):
            total += (g - 1) / g * b
        elif cls == "all-reduce":
            total += 2 * (g - 1) / g * b
        else:  # collective-permute, broadcast
            total += b
    return total


def ring_steps(coll_records: list[dict]) -> int:
    """Ring hops the recorded collectives imply (the α model's step count):
    a collective over g devices runs a g−1-hop ring (2·(g−1) for an
    all-reduce: reduce-scatter then all-gather), a collective-permute is
    one hop.  A record's ``count`` is the collectives it stands for."""
    total = 0
    for rec in coll_records:
        g = max(rec.get("group_size", 1), 1)
        sites = max(rec.get("count", 1), 1)
        cls = rec["class"]
        if cls == "all-reduce":
            total += sites * 2 * (g - 1)
        elif cls in ("all-gather", "reduce-scatter", "all-to-all"):
            total += sites * (g - 1)
        else:  # collective-permute, broadcast: a single hop each
            total += sites
    return total


def ring_latency_s(coll_records: list[dict], hw: HardwareSpec = H100) -> float:
    """α term: the per-hop latency over every implied ring hop."""
    return ring_steps(coll_records) * hw.hop_latency_s


def roofline_terms(
    terms: dict,
    n_devices: int,
    model_flops_total: float = 0.0,
    hw: HardwareSpec = H100,
) -> RooflineTerms:
    """The three terms of one device's ``terms`` (``{"flops", "bytes",
    "collectives"}``, :meth:`repro_torch.roofline.counter.WorkCounter.terms`)
    on ``hw``; ``model_flops_total`` over all ``n_devices`` gives the useful
    fraction."""
    flops = terms["flops"]
    mem_bytes = terms["bytes"]
    colls = terms.get("collectives", [])
    lb = link_bytes(colls)
    steps = ring_steps(colls)
    compute_s = flops / hw.peak_flops
    memory_s = mem_bytes / hw.hbm_bandwidth
    collective_s = lb / hw.link_bandwidth
    times = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    useful = (
        model_flops_total / (flops * n_devices) if flops > 0 and model_flops_total else 0.0
    )
    return RooflineTerms(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        flops=flops,
        bytes=mem_bytes,
        link_bytes=lb,
        bottleneck=max(times, key=times.get),
        model_flops_total=model_flops_total,
        useful_fraction=useful,
        ring_steps=steps,
        ring_latency_s=steps * hw.hop_latency_s,
    )


def overlap_step_time(compute_s: float, collective_s: float, k: int) -> float:
    """Pipelined level time of a k-step ring schedule.  The barrier
    schedule pays compute + collective in sequence; a ring cuts both into
    k slices and overlaps slice i's transfer with slice i−1's compute, so
    only one slice of the minor term is exposed:

        max(T_comp, T_comm) + min(T_comp, T_comm) / k
    """
    if k <= 1:
        return compute_s + collective_s
    lo, hi = sorted((compute_s, collective_s))
    return hi + lo / k


def auto_overlap_policy(
    compute_s: float,
    expand_s: float,
    fold_s: float,
    R: int,
    C: int,
    hw: HardwareSpec = H100,
    measured: dict | None = None,
) -> tuple[str, dict]:
    """The schedule :func:`overlap_step_time` prices fastest for one level:
    barrier (compute and both collectives in sequence), ``expand`` (the
    expand pipelined into R hops, the fold a barrier), ``expand+fold``
    (both as rings), each hop paying α on top of the pipelined transfer.
    Returns the pick and the per-policy estimates (logged by the caller,
    so the choice is auditable).

    ``measured`` maps a policy to the autotuner's measured per-level
    seconds.  When any policy has one, the pick compares the measured
    policies only (a measured wall and a modelled one are not on one
    scale), and the estimates carry the measured values in place of the
    modelled ones, so the log shows what was compared."""
    alpha = hw.hop_latency_s
    estimates = {
        "none": compute_s + expand_s + fold_s,
        "expand": overlap_step_time(compute_s, expand_s, R) + fold_s + (R - 1) * alpha,
        "expand+fold": overlap_step_time(compute_s, expand_s + fold_s, R)
        + (R - 1 + C - 1) * alpha,
    }
    known = {p: float(s) for p, s in (measured or {}).items()
             if p in estimates and s is not None}
    if known:
        estimates.update(known)
        return min(known, key=known.get), estimates
    return min(estimates, key=estimates.get), estimates


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
    measured: tuple[float, float] | None = None,
) -> np.ndarray:
    """Per-cell dense-vs-BCSR pick (bool [R, C], True = dense).

    Prices what each cell streams per traversal level:

        dense:  (C·chunk)·(R·chunk)·elem
        BCSR:   stored · (bm·bk·elem + 8 + TILE_OVERHEAD_BYTES)

    and picks dense where ``bcsr >= threshold · dense``.
    ``stored_tiles_cell`` is the per-cell stored tile count (nonzero tiles
    + fillers, ``TwoDPartition.blocked_sparse_counts()["stored_full_cell"]``).
    ``threshold`` 0 forces every cell dense, a huge value every cell
    sparse, 1.0 is the break-even.

    ``measured`` is the autotuner's calibration pair ``(dense_level_s,
    sparse_level_s)`` in place of the bytes: the all-dense level wall
    prices every cell's dense cost, the all-BCSR wall over the fullest
    cell's stored tiles prices one tile, and a cell goes dense where
    ``stored · per_tile_s >= threshold · dense_level_s``.
    """
    stored = np.asarray(stored_tiles_cell, np.float64)
    if stored.shape != (R, C):
        raise ValueError(f"stored_tiles_cell shape {stored.shape} != {(R, C)}")
    if measured is not None:
        dense_level_s, sparse_level_s = (float(x) for x in measured)
        per_tile_s = sparse_level_s / max(float(stored.max()), 1.0)
        return stored * per_tile_s >= threshold * dense_level_s
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


def sampled_run_seconds(num_rounds: int, fr: int, round_s: float) -> float:
    """Wall estimate of a (sampled) run: dispatch blocks × per-round wall.

    A k-root sample schedules ``ceil(k / batch)`` rounds dealt ``fr`` per
    dispatch block, so its cost is the block count times one block's
    wall ``round_s``: a measured one where there is one
    (``launch/serve_bc.py`` prices the refresh slices still to run from
    the slices it has run), else the grid's modelled prior
    (``core/distributed.py:prior_round_seconds``).
    """
    if num_rounds <= 0:
        return 0.0
    blocks = -(-int(num_rounds) // max(1, int(fr)))  # ceil division
    return blocks * float(round_s)
