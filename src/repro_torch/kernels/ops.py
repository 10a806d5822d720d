"""Public entry points of the level kernels K1–K6 and the EmbeddingBag
kernel K7.

K1/K2 (:func:`frontier_spmm`, :func:`dependency_spmm`) are the fused
single-device level steps on a square adjacency; K3/K4
(:func:`frontier_spmm_partial`, :func:`dependency_spmm_partial`) are their
pre-fold partials on one device's rectangular block of the 2-D
decomposition, with an optional ``acc`` running sum (the ring schedule's
combine); K5/K6 (:func:`frontier_spmm_sparse`,
:func:`dependency_spmm_sparse`) are the same partials over the block's
stored BCSR tiles only, summed on the card over the tiles' nonzero
index.  K7 (:func:`segment_bag`) is the DLRM lookup's gather-reduce.
:func:`arc_product` is the sparse engine's ``A @ x`` over a
destination-sorted arc list, summed in f64 in a fixed order; it replaces
no TPU kernel (see kernels/arc_product.py).
:func:`checksum_append` / :func:`checksum_residual` are the ABFT lane's
torch ops (no kernel), which the checked level steps put around K3/K4;
:func:`bucket_index` is the weighted traversal's bucket id (a torch op:
the weighted path runs no kernel, in the JAX package or here).

Each wrapper checks its operands (device, dtype, shape, contiguity) and
raises on anything the kernel does not take.  Then:

* tensors on the CPU go to the plain PyTorch version (kernels/ref.py;
  the arc product's is its torch version, ``core/operators.py:_arc_sum``);
* tensors on a CUDA device go to the hand-written kernel, which either
  launches or raises — there is no fallback.

While a :class:`~repro_torch.roofline.counter.WorkCounter` is active,
every wrapper reports its call's FLOP and bytes (the counter's formulas,
from the operands' shapes, on either device); :func:`arc_product`'s caller,
``core/operators.py:_arc_product``, reports the arc product's.

:data:`LAUNCHES` counts kernel launches per wrapper (plain ints, bumped
only where a kernel was launched), so a run can show that its main path
went through the kernels; :func:`reset_launches` zeroes them.  A K3–K6
launch with an ``acc`` operand counts under its wrapper's name plus
``_acc``: the ring schedules chain those, the barrier schedule never does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..roofline import counter
from . import ref
from .arc_product import ArcPlan, arc_product_cuda
from .blocked_spmm import NonzeroIndex, dependency_sparse_cuda, frontier_sparse_cuda, layout_key
from .dependency_spmm import dependency_partial_cuda, dependency_spmm_cuda
from .frontier_spmm import frontier_partial_cuda, frontier_spmm_cuda
from .segment_bag import segment_bag_cuda

__all__ = [
    "frontier_spmm",
    "dependency_spmm",
    "frontier_spmm_partial",
    "dependency_spmm_partial",
    "frontier_spmm_sparse",
    "dependency_spmm_sparse",
    "segment_bag",
    "segment_bag_table_grad",
    "SegmentBag",
    "arc_product",
    "checksum_append",
    "checksum_residual",
    "bucket_index",
    "LAUNCHES",
    "reset_launches",
]

#: kernel launches per wrapper since the last :func:`reset_launches`; the
#: ``*_acc`` keys count K3–K6 launched with an ``acc`` running sum (the
#: ring schedules' chained partials), the plain keys the launches without
#: one, so a kernel's launches are the sum of its two keys
LAUNCHES = {
    "frontier_spmm": 0,
    "dependency_spmm": 0,
    "frontier_spmm_partial": 0,
    "dependency_spmm_partial": 0,
    "frontier_spmm_sparse": 0,
    "dependency_spmm_sparse": 0,
    "frontier_spmm_partial_acc": 0,
    "dependency_spmm_partial_acc": 0,
    "frontier_spmm_sparse_acc": 0,
    "dependency_spmm_sparse_acc": 0,
    "segment_bag": 0,
    "arc_product": 0,
}

ADJACENCY_DTYPES = (torch.float32, torch.bfloat16)
TABLE_DTYPES = (torch.float32, torch.bfloat16)
# the kernels index rows with a 16-bit-limited grid dimension of 128-row tiles
MAX_N = 65535 * 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(name: str, adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor,
           delta: torch.Tensor | None = None, omega: torch.Tensor | None = None,
           acc: torch.Tensor | None = None, *, square: bool = True) -> None:
    """Validate a level kernel's operands: adjacency [m, k] (square for
    K1/K2), (σ, d[, δ]) [k, s], ω [k], acc f32 [m, s]."""
    if adjacency.dtype not in ADJACENCY_DTYPES:
        raise TypeError(f"{name}: adjacency must be float32 or bfloat16, got {adjacency.dtype}")
    if adjacency.dim() != 2:
        raise ValueError(f"{name}: adjacency must be 2-D, got {tuple(adjacency.shape)}")
    m, k = adjacency.shape
    if square and m != k:
        raise ValueError(f"{name}: adjacency must be square [n, n], got {tuple(adjacency.shape)}")
    if m > MAX_N:
        raise ValueError(f"{name}: {m} adjacency rows exceed the kernel's limit of {MAX_N}")
    _check_operands(name, m, k, [adjacency], sigma, depth, delta, omega, acc)


def _check_operands(name: str, m: int, k: int, graph: list[torch.Tensor], sigma, depth,
                    delta=None, omega=None, acc=None) -> None:
    """Validate the state operands (σ, d[, δ]) [k, s], ω [k] and acc f32
    [m, s] of a level kernel, and that they and the ``graph`` operands lie
    on one supported device, contiguous."""
    operands = {"sigma": (sigma, torch.float32), "depth": (depth, torch.int32)}
    if delta is not None:
        operands["delta"] = (delta, torch.float32)
    for key, (t, dtype) in operands.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != k or t.shape != sigma.shape:
            raise ValueError(
                f"{name}: {key} must be [{k}, s] like sigma, got {tuple(t.shape)}"
            )
    if omega is not None:
        if omega.dtype != torch.float32:
            raise TypeError(f"{name}: omega must be float32, got {omega.dtype}")
        if tuple(omega.shape) != (k,):
            raise ValueError(f"{name}: omega must be [{k}], got {tuple(omega.shape)}")
        operands["omega"] = (omega, torch.float32)
    if acc is not None:
        if acc.dtype != torch.float32:
            raise TypeError(f"{name}: acc must be float32, got {acc.dtype}")
        if tuple(acc.shape) != (m, sigma.shape[1]):
            raise ValueError(f"{name}: acc must be [{m}, s], got {tuple(acc.shape)}")
        operands["acc"] = (acc, torch.float32)
    tensors = graph + [t for t, _ in operands.values()]
    if any(t.device != graph[0].device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if graph[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {graph[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def _check_sparse(name: str, tiles: torch.Tensor, tile_rows: torch.Tensor,
                  tile_cols: torch.Tensor, index: NonzeroIndex | None, m: int, sigma, depth,
                  delta=None, omega=None, acc=None) -> None:
    """Validate a BCSR kernel's operands: tiles f32 [T, bm, bk],
    tile_rows / tile_cols i32 [T], m a multiple of bm and the gathered
    operand rows k a multiple of bk; the nonzero index
    (:func:`~repro_torch.kernels.blocked_spmm.nonzero_index`: ptr i32
    [m + 1], col i32 [nnz], val f32 [nnz], seg i32 [S, 3] with at least one
    segment a row, long_ptr i32 [L + 1]), built from these very tiles and
    required on the card, where the kernel reads it instead of the tiles;
    then the state operands as :func:`_check_operands`."""
    if tiles.dtype != torch.float32:
        raise TypeError(f"{name}: tiles must be float32, got {tiles.dtype}")
    if tiles.dim() != 3 or 0 in tiles.shape[1:]:
        raise ValueError(f"{name}: tiles must be [T, bm, bk], got {tuple(tiles.shape)}")
    num_tiles, bm, bk = tiles.shape
    k = sigma.shape[0] if sigma.dim() == 2 else -1
    if m < 0 or m % bm or k % bk:
        raise ValueError(
            f"{name}: rows m={m} and operand rows k={k} must be multiples of the "
            f"tile shape ({bm}, {bk})"
        )
    index_shapes = {"tile_rows": (tile_rows, (num_tiles,), torch.int32),
                    "tile_cols": (tile_cols, (num_tiles,), torch.int32)}
    if index is None and tiles.device.type == "cuda":
        raise ValueError(f"{name}: the kernel reads the tiles' nonzero index; pass index="
                         f"nonzero_index(tiles, tile_rows, tile_cols, m)")
    if index is not None:
        if not isinstance(index, NonzeroIndex):
            raise TypeError(f"{name}: index must be a NonzeroIndex, got {type(index).__name__}")
        nnz = index.col.shape[0] if index.col.dim() == 1 else -1
        num_long = index.long_ptr.shape[0] - 1 if index.long_ptr.dim() == 1 else -1
        num_seg = index.seg.shape[0] if index.seg.dim() == 2 else -1
        index_shapes.update({
            "index.ptr": (index.ptr, (m + 1,), torch.int32),
            "index.col": (index.col, (nnz,), torch.int32),
            "index.val": (index.val, (nnz,), torch.float32),
            "index.seg": (index.seg, (num_seg, 3), torch.int32),
            "index.long_ptr": (index.long_ptr, (num_long + 1,), torch.int32),
        })
        if nnz < 0 or num_long < 0 or num_seg < m + num_long:
            raise ValueError(
                f"{name}: index must hold 1-D col/val, long_ptr with a leading 0 and a "
                f"segment for each short row and two or more for each long one "
                f"(m={m}), got col {tuple(index.col.shape)}, seg {tuple(index.seg.shape)}, "
                f"long_ptr {tuple(index.long_ptr.shape)}"
            )
    for key, (t, shape, dtype) in index_shapes.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {list(shape)}, got {tuple(t.shape)}")
    if index is not None and index.layout != layout_key(tiles, tile_rows, tile_cols, m):
        raise ValueError(f"{name}: index was not built from these tiles at m={m}, or they "
                         f"changed since; rebuild it with nonzero_index")
    graph = [tiles] + [t for t, _, _ in index_shapes.values()]
    _check_operands(name, m, k, graph, sigma, depth, delta, omega, acc)


def checksum_append(x: torch.Tensor) -> torch.Tensor:
    """Append the ABFT ones-checksum lane to a batched [n, s] operand: the
    extra column is the row sum of the real ones, so after any linear map
    ``t = A @ x`` the output's last column must equal the sum of its real
    columns (:func:`checksum_residual` checks it).  A torch op on the
    operand's device, not a kernel."""
    return torch.cat([x, x.sum(dim=1, keepdim=True)], dim=1)


def checksum_residual(t: torch.Tensor) -> torch.Tensor:
    """Relative ABFT residual of a checksum-extended product ``t`` [n, s+1]
    (lane last): the f32 0-d tensor
    ``max_i |t[i, -1] - Σ_j t[i, j]| / (1 + Σ_j |t[i, j]|)`` — about 1e-7
    for a healthy f32 sum, orders of magnitude more when a flipped bit or a
    bad partial broke the column-sum invariant.  0 for an empty ``t``."""
    real = t[:, :-1]
    resid = (t[:, -1] - real.sum(dim=1)).abs()
    scale = 1.0 + real.abs().sum(dim=1)
    ratio = (resid / scale).to(torch.float32)
    return ratio.max() if ratio.numel() else ratio.new_zeros(())


def bucket_index(dist: torch.Tensor, delta: float, unreached: int = -1) -> torch.Tensor:
    """i32 bucket ids ``⌊d/Δ⌋`` of a tentative-distance array, ``unreached``
    where the distance is ``+inf``.  The floor runs on a 0-substituted copy
    (``inf/Δ`` has no integer value) and is masked back: the weighted
    round's analogue of the level array's -1.  A torch op, not a kernel."""
    delta32 = float(np.float32(delta))  # Δ as the f32 it is on the card
    finite = torch.isfinite(dist)
    safe = torch.where(finite, dist, 0.0)
    ids = torch.floor(safe / delta32).to(torch.int32)
    return torch.where(finite, ids, unreached)


def frontier_spmm(
    adjacency: torch.Tensor, sigma: torch.Tensor, depth: torch.Tensor, lvl: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused forward BFS level (K1): returns (σ', d').  See
    kernels/ref.py:frontier_spmm_ref for the semantics."""
    _check("frontier_spmm", adjacency, sigma, depth)
    if counter.ACTIVE is not None:
        counter.ACTIVE.add("frontier_spmm", counter.dense_flops(*adjacency.shape, sigma.shape[1]),
                           counter.frontier_bytes(adjacency, sigma, depth))
    if adjacency.device.type == "cpu":
        return ref.frontier_spmm_ref(adjacency, sigma, depth, lvl)
    if sigma.numel() == 0:
        return sigma.clone(), depth.clone()
    out = frontier_spmm_cuda(adjacency, sigma, depth, lvl)
    LAUNCHES["frontier_spmm"] += 1
    return out


def dependency_spmm(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
) -> torch.Tensor:
    """Fused backward dependency level (K2): returns δ'.  See
    kernels/ref.py:dependency_spmm_ref for the semantics."""
    _check("dependency_spmm", adjacency, sigma, depth, delta, omega)
    if counter.ACTIVE is not None:
        counter.ACTIVE.add("dependency_spmm",
                           counter.dense_flops(*adjacency.shape, sigma.shape[1]),
                           counter.dependency_bytes(adjacency, sigma, depth, delta, omega))
    if adjacency.device.type == "cpu":
        return ref.dependency_spmm_ref(adjacency, sigma, depth, delta, omega, lvl)
    if sigma.numel() == 0:
        return delta.clone()
    out = dependency_spmm_cuda(adjacency, sigma, depth, delta, omega, lvl)
    LAUNCHES["dependency_spmm"] += 1
    return out


def _empty(m: int, sigma: torch.Tensor, acc: torch.Tensor | None):
    """The result of a partial with no output elements (m = 0 or s = 0)."""
    if acc is not None:
        return acc.clone()
    return torch.zeros((m, sigma.shape[1]), device=sigma.device)


def frontier_spmm_partial(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold forward partial on a rectangular block (K3): returns t f32
    [m, s].  See kernels/ref.py:frontier_partial_ref for the semantics."""
    _check("frontier_spmm_partial", adjacency, sigma, depth, acc=acc, square=False)
    if counter.ACTIVE is not None:
        counter.ACTIVE.add("frontier_spmm_partial",
                           counter.dense_flops(*adjacency.shape, sigma.shape[1]),
                           counter.partial_bytes(adjacency, sigma, depth, acc=acc))
    if adjacency.device.type == "cpu":
        return ref.frontier_partial_ref(adjacency, sigma, depth, lvl, acc)
    if adjacency.shape[0] == 0 or sigma.shape[1] == 0:
        return _empty(adjacency.shape[0], sigma, acc)
    out = frontier_partial_cuda(adjacency, sigma, depth, lvl, acc)
    LAUNCHES["frontier_spmm_partial" if acc is None else "frontier_spmm_partial_acc"] += 1
    return out


def dependency_spmm_partial(
    adjacency: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    acc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pre-fold backward partial on a rectangular block (K4): returns t f32
    [m, s].  See kernels/ref.py:dependency_partial_ref for the semantics."""
    _check("dependency_spmm_partial", adjacency, sigma, depth, delta, omega, acc, square=False)
    if counter.ACTIVE is not None:
        counter.ACTIVE.add("dependency_spmm_partial",
                           counter.dense_flops(*adjacency.shape, sigma.shape[1]),
                           counter.partial_bytes(adjacency, sigma, depth, delta, omega, acc))
    if adjacency.device.type == "cpu":
        return ref.dependency_partial_ref(adjacency, sigma, depth, delta, omega, lvl, acc)
    if adjacency.shape[0] == 0 or sigma.shape[1] == 0:
        return _empty(adjacency.shape[0], sigma, acc)
    out = dependency_partial_cuda(adjacency, sigma, depth, delta, omega, lvl, acc)
    LAUNCHES["dependency_spmm_partial" if acc is None else "dependency_spmm_partial_acc"] += 1
    return out


def _count_sparse(name: str, tiles, index, m: int, sigma, *state) -> None:
    """Report a K5/K6 call to the active counter: over its nonzero index,
    or (a CPU call without one) over the tiles' nonzero entries."""
    s = sigma.shape[1]
    if index is not None:
        nnz, nbytes = index.col.numel(), counter.sparse_bytes(index, sigma, *state)
    else:
        nnz = int(torch.count_nonzero(tiles))
        nbytes = counter.index_sparse_bytes(m, nnz, sigma.nbytes + sum(x.nbytes for x in state),
                                            s)
    counter.ACTIVE.add(name, counter.sparse_flops(nnz, s), nbytes)


def frontier_spmm_sparse(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    lvl: int,
    *,
    m: int,
    acc: torch.Tensor | None = None,
    index: NonzeroIndex | None = None,
) -> torch.Tensor:
    """BCSR pre-fold forward partial (K5): returns t f32 [m, s] over one
    device's stored tiles (see
    :meth:`repro_torch.graphs.partition.TwoDPartition.cell_blocked_sparse`).
    ``m`` is the block's row count (C·chunk); ``index`` the tiles'
    :func:`~repro_torch.kernels.blocked_spmm.nonzero_index`, which the
    kernel reads instead of the tiles: required for CUDA tensors, checked
    when given for CPU ones (the plain version reads the tiles).  See
    kernels/ref.py:frontier_sparse_ref for the semantics (the kernel skips
    zero tile entries: on a non-finite operand see frontier_index_ref)."""
    _check_sparse("frontier_spmm_sparse", tiles, tile_rows, tile_cols, index, m, sigma, depth,
                  acc=acc)
    if counter.ACTIVE is not None:
        _count_sparse("frontier_spmm_sparse", tiles, index, m, sigma, depth)
    if tiles.device.type == "cpu":
        return ref.frontier_sparse_ref(tiles, tile_rows, tile_cols, sigma, depth, lvl, m, acc)
    if m == 0 or sigma.shape[1] == 0:
        return _empty(m, sigma, acc)
    out = frontier_sparse_cuda(index, sigma, depth, lvl, m, acc)
    LAUNCHES["frontier_spmm_sparse" if acc is None else "frontier_spmm_sparse_acc"] += 1
    return out


def dependency_spmm_sparse(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    sigma: torch.Tensor,
    depth: torch.Tensor,
    delta: torch.Tensor,
    omega: torch.Tensor,
    lvl: int,
    *,
    m: int,
    acc: torch.Tensor | None = None,
    index: NonzeroIndex | None = None,
) -> torch.Tensor:
    """BCSR pre-fold backward partial (K6): returns t f32 [m, s].  Operands
    as :func:`frontier_spmm_sparse` plus δ [k, s] and ω [k].  See
    kernels/ref.py:dependency_sparse_ref for the semantics."""
    _check_sparse("dependency_spmm_sparse", tiles, tile_rows, tile_cols, index, m, sigma, depth,
                  delta, omega, acc)
    if counter.ACTIVE is not None:
        _count_sparse("dependency_spmm_sparse", tiles, index, m, sigma, depth, delta, omega)
    if tiles.device.type == "cpu":
        return ref.dependency_sparse_ref(tiles, tile_rows, tile_cols, sigma, depth, delta, omega,
                                         lvl, m, acc)
    if m == 0 or sigma.shape[1] == 0:
        return _empty(m, sigma, acc)
    out = dependency_sparse_cuda(index, sigma, depth, delta, omega, lvl, m, acc)
    LAUNCHES["dependency_spmm_sparse" if acc is None else "dependency_spmm_sparse_acc"] += 1
    return out


def segment_bag(
    table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """EmbeddingBag, sum mode (K7): returns f32 [B, D], out[b] =
    Σ_l w[b,l]·table[indices[b,l]], with table [V, D] f32 or bf16, indices
    i32 [B, L] (a negative id is padding; the others must lie below V) and
    optional f32 weights [B, L].  See kernels/ref.py:segment_bag_ref for
    the semantics.

    Differentiable in ``table``: where autograd records (grad mode on and
    ``table.requires_grad``), the call goes through :class:`SegmentBag`,
    whose forward is this same call and whose backward is
    :func:`segment_bag_table_grad`.  ``weights`` get no gradient: one that
    requires it is refused."""
    if torch.is_grad_enabled() and (
        table.requires_grad or (weights is not None and weights.requires_grad)
    ):
        if weights is not None and weights.requires_grad:
            raise ValueError("segment_bag: per-sample weights get no gradient; detach them")
        return SegmentBag.apply(table, indices, weights)
    return _segment_bag(table, indices, weights)


def _segment_bag(table, indices, weights):
    """K7's checked call, no autograd: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    name = "segment_bag"
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"{name}: table must be float32 or bfloat16, got {table.dtype}")
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be [V, D], got {tuple(table.shape)}")
    if indices.dtype != torch.int32:
        raise TypeError(f"{name}: indices must be int32, got {indices.dtype}")
    if indices.dim() != 2:
        raise ValueError(f"{name}: indices must be [B, L], got {tuple(indices.shape)}")
    tensors = [table, indices]
    if weights is not None:
        if weights.dtype != torch.float32:
            raise TypeError(f"{name}: weights must be float32, got {weights.dtype}")
        if weights.shape != indices.shape:
            raise ValueError(f"{name}: weights must be {tuple(indices.shape)} like indices, "
                             f"got {tuple(weights.shape)}")
        tensors.append(weights)
    if any(t.device != table.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if counter.ACTIVE is not None:
        counter.ACTIVE.add(name, counter.sparse_flops(indices.numel(), table.shape[1]),
                           counter.segment_bag_bytes(table, indices, weights))
    if table.device.type == "cpu":
        return ref.segment_bag_ref(table, indices, weights)
    if indices.shape[0] == 0 or table.shape[1] == 0:
        return torch.zeros((indices.shape[0], table.shape[1]), device=table.device)
    out = segment_bag_cuda(table, indices, weights)
    LAUNCHES["segment_bag"] += 1
    return out


def arc_product(x: torch.Tensor, plan: ArcPlan | None, rows: int) -> torch.Tensor:
    """The arc product: returns f32 [rows, s], row v the sum of ``x[src]``
    over the arcs into v, taken in float64 in a fixed order and rounded
    once, with x f32 [k, s] and ``plan`` the arcs' work list
    (:func:`~repro_torch.kernels.arc_product.arc_plan`, built for these
    ``rows``; required on either device).  Its plain version, which CPU
    tensors take, is the torch version ``core/operators.py:_arc_sum`` over
    the plan's arcs and pieces: the same bits.  The caller reports the
    work to an active counter (``core/operators.py:_arc_product``)."""
    name = "arc_product"
    if plan is None:
        raise ValueError(f"{name}: the kernel reads the arcs' work list; pass "
                         f"plan=arc_plan(src, pieces, counts, rows)")
    if not isinstance(plan, ArcPlan):
        raise TypeError(f"{name}: plan must be an ArcPlan, got {type(plan).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] >= 2**31:
        raise ValueError(f"{name}: x must be [k, s] with k < 2^31, got {tuple(x.shape)}")
    if plan.rows != rows:
        raise ValueError(f"{name}: plan was built for {plan.rows} rows, not {rows}")
    for key, t in zip(("src", "seg", "long_ptr"), plan.arrays):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: plan.{key} must be int32, got {t.dtype}")
    num_long = plan.long_ptr.numel() - 1
    if (plan.src.dim() != 1 or plan.long_ptr.dim() != 1 or num_long < 0
            or tuple(plan.seg.shape) != (rows - num_long + plan.n_long_seg, 3)):
        raise ValueError(
            f"{name}: plan must hold a 1-D src, long_ptr with a leading 0 and a segment for "
            f"each short row and each long row's piece (rows={rows}), got src "
            f"{tuple(plan.src.shape)}, seg {tuple(plan.seg.shape)}, long_ptr "
            f"{tuple(plan.long_ptr.shape)}"
        )
    tensors = [x, *plan.arrays]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if rows == 0 or x.shape[1] == 0:
        return torch.zeros((rows, x.shape[1]), device=x.device)
    if x.device.type == "cpu":
        from ..core.operators import _arc_sum  # imported here: core imports this module

        return _arc_sum(x, plan.src, plan.pieces, plan.counts, rows)
    out = arc_product_cuda(x, plan)
    LAUNCHES[name] += 1
    return out


#: lookups of one table row that the first level of K7's gradient sums
#: in one piece at most (:func:`segment_bag_table_grad`)
GRAD_PIECE = 256


def segment_bag_table_grad(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: torch.Tensor | None, num_rows: int) -> torch.Tensor:
    """The gradient of :func:`segment_bag`'s sum in its table: f32
    [num_rows, D], row r = Σ over the lookups (b, l) of r of
    w[b,l]·grad_out[b] (zero for rows no bag reads), dense as
    ``jax.grad`` gives it.  torch ops, no kernel: the JAX package has no
    backward kernel for K7 either and trains through XLA's gather.

    The sum is order-fixed, not atomic: the lookups are sorted by row id
    (stable: bag order within a row), each one's f32 product w·grad_out
    is widened to float64, summed in that order in pieces of at most
    :data:`GRAD_PIECE` lookups and then the pieces (``segment_reduce``:
    one thread sums a run in order; no thread sums a hot row's ~10^4
    click-log lookups in one chain), and rounded once into the rows
    (``index_copy_`` of distinct rows).  The same inputs give the same
    bits, and the result is the float64 sum correctly rounded but for
    the float64 rounding of the sum itself."""
    bag_len = indices.shape[1]
    flat = indices.reshape(-1)
    lookup = torch.nonzero(flat >= 0).squeeze(1)  # bag-major
    ids, order = torch.sort(flat[lookup].long(), stable=True)
    lookup = lookup[order]
    grad = torch.zeros((num_rows, grad_out.shape[1]), dtype=torch.float32,
                       device=grad_out.device)
    if ids.numel() == 0:
        return grad
    rows = grad_out.index_select(0, lookup // bag_len)
    if weights is not None:
        rows = rows * weights.reshape(-1)[lookup, None]
    unique, lengths = torch.unique_consecutive(ids, return_counts=True)
    rows = rows.to(torch.float64)
    if lengths.numel() and int(lengths.max()) > GRAD_PIECE:
        counts = (lengths + GRAD_PIECE - 1) // GRAD_PIECE
        run = torch.repeat_interleave(torch.arange(lengths.numel(), device=lengths.device),
                                      counts)
        k = torch.arange(run.numel(), device=lengths.device) - (counts.cumsum(0) - counts)[run]
        pieces = (lengths[run] - k * GRAD_PIECE).clamp(max=GRAD_PIECE)
        rows = torch.segment_reduce(rows, "sum", lengths=pieces, axis=0)
        lengths = counts
    sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0)
    return grad.index_copy_(0, unique, sums.to(torch.float32))


class SegmentBag(torch.autograd.Function):
    """K7 with a gradient in the table: forward K7's checked call (the
    kernel on the card, launched and counted, or its plain version on the
    CPU), backward :func:`segment_bag_table_grad`, in the table's dtype."""

    @staticmethod
    def forward(ctx, table, indices, weights):
        ctx.save_for_backward(indices, weights)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return _segment_bag(table, indices, weights)

    @staticmethod
    def backward(ctx, grad_out):
        indices, weights = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = segment_bag_table_grad(grad_out.contiguous(), indices, weights,
                                          ctx.table_shape[0]).to(ctx.table_dtype)
        return grad, None, None
