"""The port's CUDA kernels and fused engines on the card.

Every test here is marked ``gpu`` and skips itself without a CUDA card.
The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: depth exact, σ rtol 1e-6 (exact integer path counts), δ rtol
1e-5 / atol 1e-6 (fractional g summed in another order than the plain
version's matmul), BC rtol 1e-5 / atol 1e-5 against the numpy oracle or
the single-device dense engine.  K3's and K5's partials are integer-valued
sums and are held exactly, and so are σ and K3's t on the column-tile and
copy-path cases of K1/K3; on signed tile values K5/K6 are held within
1e-5 of Σ|a·x| (a sum's rounding scale, which cancellation does not
shrink); K1–K6 are bitwise reproducible launch to launch.
K7 against its plain version: rtol 1e-6 / atol 1e-6 for f32 tables,
rtol 2e-2 for bf16 (the JAX kernel test's values; the two take the same
sum in the same order); the reduced DLRM forward on the card against
the same model on the CPU at rtol 1e-5 / atol 1e-5 (f32 matmuls summed
in another order, TF32 off).  The reduced LMs on the card against the
CPU at the tolerances tests/test_torch_lm_serve.py holds against the JAX
package (logits 5 % and cache 2 % of the largest value; an MoE arch may
have 1 % of its cache rows past that, a route flipped at a near-tie);
the score product of bf16 operands with an f32 result within rtol 1e-5
of the upcast product; a decode step's peak memory within LM_DECODE_MARGIN
(8 MiB) of the parameters and the cache, far below an f32 copy of one
layer's cache; the CUDA-graph replay of a decode step bitwise equal to
the step run op by op.  LM training, card against CPU at the tolerances
tests/test_torch_lm_train*.py hold against the JAX package, the card on
the CPU's expert routes (tests/torch_lm_routes.py, which imports no
JAX): the score product's autograd Function (its f32 cotangent products
within one bf16 unit plus 1e-5 of the sum of |terms|), lm_loss (1e-2 relative) and every
gradient (5 % of its largest value), and one train-cell step (μ 5 %,
second moments 10 %, parameters within 2·lr plus one unit).  The GNN
path (no kernel of ours), card against CPU at the tolerances the CPU
tests hold against the JAX package: the flat loss rtol 1e-5 and every
gradient rtol 1e-4 / atol 1e-6 (tests/test_torch_gnn.py), the 2-D path on
the 1×1 NCCL grid against the CPU's flat path at loss rtol 1e-4,
gradients rtol 1e-3 / atol 1e-5 (tests/test_dist_gnn2d.py); gin-tu's
train cell at its published width on full_graph_sm against the CPU's
flat loss of the same parameters within 1e-2 (bf16 expand and fold).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.graphs as pg
from repro_torch.core import bc as pbc
from repro_torch.core import brandes_reference
from repro_torch.core.distributed import distributed_betweenness_centrality
from repro_torch.core.driver import BCDriver
from repro_torch.core import operators
from repro_torch.core.operators import (
    DistributedWeightedDenseOperator,
    DistributedWeightedOperator,
    WeightedDenseOperator,
    WeightedSparseOperator,
)
from repro_torch.core.scheduler import build_schedule
from repro_torch.distributed import GridGroups
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.dependency_spmm import column_tile, fast_copies
from repro_torch.kernels.blocked_spmm import SEGMENT, nonzero_index
from repro_torch.launch.train import reduced_lm
from repro_torch.models import DLRM, TransformerLM
from repro_torch.models.attention import bmm_f32

SHAPES = [(8, 4), (16, 16), (64, 8), (128, 128), (130, 33), (256, 64), (1000, 192), (300, 260)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(n, s, seed, lvl, dtype, device):
    rng = np.random.default_rng(seed)
    A = pg.gnp_graph(n, min(0.3, 8.0 / n), seed=seed).dense_adjacency(np.float32)
    sigma = rng.integers(0, 5, size=(n, s)).astype(np.float32)
    depth = rng.integers(-1, lvl + 3, size=(n, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(sigma, 1.0), 0.0).astype(np.float32)
    delta = (rng.random((n, s)).astype(np.float32) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=n).astype(np.float32)
    return (torch.from_numpy(A).to(device=device, dtype=dtype),) + tuple(
        torch.from_numpy(x).to(device) for x in (sigma, depth, delta, omega)
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    for n, s in SHAPES:
        A, sigma, depth, delta, omega = _state(n, s, n + s, 2, DTYPES[dtype], cuda)
        got_s, got_d = ops.frontier_spmm(A, sigma, depth, 2)
        want_s, want_d = ref.frontier_spmm_ref(A, sigma, depth, 2)
        torch.testing.assert_close(got_s, want_s, rtol=1e-6, atol=0.0)
        assert torch.equal(got_d, want_d)
        torch.testing.assert_close(
            ops.dependency_spmm(A, sigma, depth, delta, omega, 1),
            ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1),
            rtol=1e-5, atol=1e-6,
        )


def test_cuda_tensors_go_to_the_kernel_never_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(ref, "frontier_spmm_ref", refuse)
    monkeypatch.setattr(ref, "dependency_spmm_ref", refuse)
    monkeypatch.setattr(ref, "frontier_partial_ref", refuse)
    monkeypatch.setattr(ref, "dependency_partial_ref", refuse)
    monkeypatch.setattr(ref, "frontier_sparse_ref", refuse)
    monkeypatch.setattr(ref, "dependency_sparse_ref", refuse)
    monkeypatch.setattr(ref, "segment_bag_ref", refuse)
    monkeypatch.setattr(operators, "_arc_sum", refuse)
    A, sigma, depth, delta, omega = _state(64, 8, 1, 2, torch.float32, cuda)
    tiles, rows, cols = _tile_list(5, 4, 8, 16, 0, cuda)
    ops.reset_launches()
    ops.frontier_spmm(A, sigma, depth, 2)
    ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
    ops.frontier_spmm_partial(A[:40].contiguous(), sigma, depth, 2)
    ops.dependency_spmm_partial(A[:40].contiguous(), sigma, depth, delta, omega, 1)
    index = nonzero_index(tiles, rows, cols, 40)
    ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=40, index=index)
    ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=40, index=index)
    ops.segment_bag(sigma, torch.zeros((3, 2), dtype=torch.int32, device=cuda))
    n, _, _, _, plan = _arc_case("pieces", cuda)
    ops.arc_product(_arc_operand(n, 8, 0, cuda), plan, n)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"frontier_spmm": 1, "dependency_spmm": 1,
                            "frontier_spmm_partial": 1, "dependency_spmm_partial": 1,
                            "frontier_spmm_sparse": 1, "dependency_spmm_sparse": 1,
                            "frontier_spmm_partial_acc": 0, "dependency_spmm_partial_acc": 0,
                            "frontier_spmm_sparse_acc": 0, "dependency_spmm_sparse_acc": 0,
                            "segment_bag": 1, "arc_product": 1}


def test_sparse_wrappers_on_the_card_need_the_tiles_own_index(cuda):
    """K5/K6 read the index, not the tiles: on the card the wrappers
    refuse a call without it, or with the index of other or changed
    tiles, and launch nothing."""
    _, sigma, depth, delta, omega = _state(64, 8, 1, 2, torch.float32, cuda)
    tiles, rows, cols = _tile_list(5, 4, 8, 16, 0, cuda)
    index = nonzero_index(tiles, rows, cols, 40)
    ops.reset_launches()
    with pytest.raises(ValueError, match="nonzero index"):
        ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=40)
    with pytest.raises(ValueError, match="not built from these tiles"):
        ops.dependency_spmm_sparse(tiles.clone(), rows, cols, sigma, depth, delta, omega, 1,
                                   m=40, index=index)
    tiles.mul_(2)
    with pytest.raises(ValueError, match="not built from these tiles"):
        ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=40, index=index)
    assert ops.LAUNCHES["frontier_spmm_sparse"] == ops.LAUNCHES["dependency_spmm_sparse"] == 0


def test_cuda_wrappers_reject_mixed_devices(cuda):
    A, sigma, depth, delta, omega = _state(16, 4, 2, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="one device"):
        ops.frontier_spmm(A, sigma.cpu(), depth, 2)
    with pytest.raises(ValueError, match="one device"):
        ops.dependency_spmm(A, sigma, depth, delta, omega.cpu(), 1)


# (m, k, s): ragged rectangular blocks, neither side a multiple of 128
PARTIAL_SHAPES = [(8, 16, 4), (130, 70, 33), (300, 1000, 192), (1000, 260, 128), (257, 129, 130)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_partial_kernels_match_plain_versions(cuda, dtype):
    for m, k, s in PARTIAL_SHAPES:
        A, sigma, depth, delta, omega = _state(max(m, k), s, m + k + s, 2, DTYPES[dtype], cuda)
        A = A[:m, :k].contiguous()
        sigma, depth, delta, omega = sigma[:k], depth[:k], delta[:k], omega[:k]
        acc = torch.randint(0, 7, (m, s), device=cuda).to(torch.float32)
        for t_in in (None, acc):
            got = ops.frontier_spmm_partial(A, sigma, depth, 2, acc=t_in)
            assert torch.equal(got, ref.frontier_partial_ref(A, sigma, depth, 2, t_in))
            torch.testing.assert_close(
                ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1, acc=t_in),
                ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1, t_in),
                rtol=1e-5, atol=1e-6,
            )


def _at_offset(A):
    """A copy of A whose base lies one element past a 16-byte boundary
    (a contiguous view into a larger buffer)."""
    buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=A.device)
    view = buf[1:].view(A.shape)
    view.copy_(A)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# K1-K4's main loop: widths that reach each column tile (64, 128, 192, and
# ragged ones over several tiles), contraction lengths whose A rows are and
# are not a multiple of 16 bytes
DEP_WIDTHS = [64, 128, 192, 130, 257]
DEP_KDIMS = [33, 130, 260, 4096]


@pytest.mark.parametrize("s", DEP_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dependency_kernels_reach_every_column_tile_and_copy_path(cuda, dtype, s):
    """K2 at n = kdim and K4 (plain and acc) on a [200, kdim] block, with A
    aligned and at an offset, against their plain versions (δ / t rtol
    1e-5 / atol 1e-6); every path of the copies is taken."""
    paths = set()
    for kdim in DEP_KDIMS:
        A, sigma, depth, delta, omega = _state(kdim, s, kdim + s, 2, DTYPES[dtype], cuda)
        blk = A[:200].contiguous()
        acc = torch.randint(0, 7, (blk.shape[0], s), device=cuda).to(torch.float32)
        for a, b in ((A, blk), (_at_offset(A), _at_offset(blk))):
            paths.add(fast_copies(a))
            torch.testing.assert_close(
                ops.dependency_spmm(a, sigma, depth, delta, omega, 1),
                ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1), rtol=1e-5, atol=1e-6)
            for t_in in (None, acc):
                torch.testing.assert_close(
                    ops.dependency_spmm_partial(b, sigma, depth, delta, omega, 1, acc=t_in),
                    ref.dependency_partial_ref(blk, sigma, depth, delta, omega, 1, t_in),
                    rtol=1e-5, atol=1e-6)
    torch.cuda.synchronize()
    assert paths == {True, False}


def test_dependency_kernels_are_bitwise_reproducible(cuda):
    """No atomics and no split-k: two launches give the same bits."""
    for dtype in DTYPES.values():
        for n, s in ((4096, 192), (1000, 130), (260, 64)):
            A, sigma, depth, delta, omega = _state(n, s, n + s, 2, dtype, cuda)
            runs = [(ops.dependency_spmm(A, sigma, depth, delta, omega, 1),
                     ops.dependency_spmm_partial(A[:n // 2].contiguous(), sigma, depth, delta,
                                                 omega, 1)) for _ in range(2)]
            assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_dependency_kernels_launch_above_48_kb_of_shared_memory(cuda):
    """The main loop's ring is dynamic shared memory past the 48 KB default
    (the launcher raises the limit): those launches run and agree."""
    lib = _build.library()
    for dtype, is_bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
        for s in (128, 192):
            assert lib.level_gemm_shared_bytes(column_tile(s), is_bf16) > 48 * 1024
            A, sigma, depth, delta, omega = _state(512, s, s, 2, dtype, cuda)
            got = ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref.dependency_spmm_ref(A, sigma, depth, delta,
                                                                    omega, 1),
                                       rtol=1e-5, atol=1e-6)
    assert lib.level_gemm_shared_bytes(96, 0) == -1


@pytest.mark.parametrize("s", DEP_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_frontier_kernels_reach_every_column_tile_and_copy_path(cuda, dtype, s):
    """K1 at n = kdim and K3 (plain and acc) on a [200, kdim] block, with A
    aligned and at an offset, against their plain versions: depth, σ and
    K3's integer-valued t exact (integer path counts sum exactly in f32);
    every path of the copies is taken."""
    paths = set()
    for kdim in DEP_KDIMS:
        A, sigma, depth, _, _ = _state(kdim, s, kdim + s, 2, DTYPES[dtype], cuda)
        blk = A[:200].contiguous()
        acc = torch.randint(0, 7, (blk.shape[0], s), device=cuda).to(torch.float32)
        want_s, want_d = ref.frontier_spmm_ref(A, sigma, depth, 2)
        for a, b in ((A, blk), (_at_offset(A), _at_offset(blk))):
            paths.add(fast_copies(a))
            got_s, got_d = ops.frontier_spmm(a, sigma, depth, 2)
            assert torch.equal(got_d, want_d) and torch.equal(got_s, want_s)
            for t_in in (None, acc):
                assert torch.equal(ops.frontier_spmm_partial(b, sigma, depth, 2, acc=t_in),
                                   ref.frontier_partial_ref(blk, sigma, depth, 2, t_in))
    torch.cuda.synchronize()
    assert paths == {True, False}


def test_frontier_kernels_are_bitwise_reproducible(cuda):
    """No atomics and no split-k: two launches give the same bits."""
    for dtype in DTYPES.values():
        for n, s in ((4096, 128), (1000, 130), (260, 64), (300, 192)):
            A, sigma, depth, _, _ = _state(n, s, n + s, 2, dtype, cuda)
            runs = [(*ops.frontier_spmm(A, sigma, depth, 2),
                     ops.frontier_spmm_partial(A[:n // 2].contiguous(), sigma, depth, 2))
                    for _ in range(2)]
            assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_frontier_kernels_launch_above_48_kb_of_shared_memory(cuda):
    """K1/K3 run the same ring past the 48 KB default: those launches run
    and agree."""
    lib = _build.library()
    for dtype, is_bf16 in ((torch.float32, 0), (torch.bfloat16, 1)):
        for s in (128, 192):
            assert lib.level_gemm_shared_bytes(column_tile(s), is_bf16) > 48 * 1024
            A, sigma, depth, _, _ = _state(512, s, s, 2, dtype, cuda)
            got_s, got_d = ops.frontier_spmm(A, sigma, depth, 2)
            got_t = ops.frontier_spmm_partial(A[:300].contiguous(), sigma, depth, 2)
            torch.cuda.synchronize()
            want_s, want_d = ref.frontier_spmm_ref(A, sigma, depth, 2)
            assert torch.equal(got_s, want_s) and torch.equal(got_d, want_d)
            assert torch.equal(got_t, ref.frontier_partial_ref(A[:300], sigma, depth, 2))


def _tile_list(num_tr, num_tc, bm, bk, seed, device, pad=3, complete=True):
    """A row-sorted random BCSR tile list: 0–3 distinct tiles per tile-row,
    an all-zero filler in an empty row when ``complete`` (else the row
    stays empty), and ``pad`` zero tiles trailing on the last row."""
    rng = np.random.default_rng(seed)
    rows, cols, data = [], [], []
    for r in range(num_tr):
        picks = np.sort(rng.choice(num_tc, size=min(num_tc, int(rng.integers(0, 4))),
                                   replace=False))
        if picks.size == 0 and complete:
            rows.append(r), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
        for c in picks:
            rows.append(r), cols.append(int(c))
            data.append((rng.random((bm, bk)) < 0.3).astype(np.float32))
    for _ in range(pad):
        rows.append(num_tr - 1), cols.append(0), data.append(np.zeros((bm, bk), np.float32))
    return tuple(torch.from_numpy(x).to(device) for x in
                 (np.stack(data), np.array(rows, np.int32), np.array(cols, np.int32)))


# (tile-rows, tile-cols, bm, bk, s): bm != bk, each of the kernel's row
# blocks (32, 64, 128) and a tile-row split over two blocks (200), ragged s
SPARSE_SHAPES = [(6, 5, 5, 8, 33), (4, 7, 8, 5, 130), (9, 3, 32, 128, 4), (3, 4, 128, 32, 192),
                 (5, 6, 64, 20, 128), (2, 3, 200, 8, 257)]


@pytest.mark.parametrize("complete", [True, False], ids=["row-complete", "empty-rows"])
def test_sparse_kernels_match_plain_versions(cuda, complete):
    for num_tr, num_tc, bm, bk, s in SPARSE_SHAPES:
        tiles, rows, cols = _tile_list(num_tr, num_tc, bm, bk, num_tr + s, cuda,
                                       complete=complete)
        m, kdim = num_tr * bm, num_tc * bk
        _, sigma, depth, delta, omega = _state(kdim, s, kdim + s, 2, torch.float32, cuda)
        acc = torch.randint(0, 7, (m, s), device=cuda).to(torch.float32)
        index = nonzero_index(tiles, rows, cols, m)
        for t_in in (None, acc):
            got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in,
                                           index=index)
            want = ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m, t_in)
            assert torch.equal(got, want), (num_tr, num_tc, bm, bk, s)
            torch.testing.assert_close(
                ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1,
                                           m=m, acc=t_in, index=index),
                ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m,
                                          t_in),
                rtol=1e-5, atol=1e-6,
            )


def _operands(k, s, seed, device):
    """(σ, d, δ, ω) of _state without its adjacency (k may be large)."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(-1, 5, size=(k, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(rng.integers(0, 5, size=(k, s)), 1), 0)
    delta = rng.random((k, s)) * (depth >= 0)
    omega = rng.integers(0, 3, size=k)
    return tuple(torch.from_numpy(np.asarray(x, dtype)).to(device) for x, dtype in (
        (sigma, np.float32), (depth, np.int32), (delta, np.float32), (omega, np.float32)))


def _skewed_list(device, num_tc=160, seed=0):
    """Tile-row 0: num_tc 128 x 128 tiles whose first row is all ones (one
    row of num_tc·128 nonzeros, many segments long) over 2 % random
    entries; tile-rows 1-3 one random tile each; a trailing zero pad."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tiles = (torch.rand((num_tc + 4, 128, 128), generator=gen, device=device) < 0.02).float()
    tiles[:num_tc, 0, :] = 1.0
    tiles[-1] = 0.0
    rows = torch.tensor([0] * num_tc + [1, 2, 3, 3], dtype=torch.int32, device=device)
    cols = torch.tensor(list(range(num_tc)) + [5, 6, 7, 0], dtype=torch.int32, device=device)
    return tiles, rows, cols


@pytest.mark.parametrize("s", [128, 192, 33])
def test_sparse_kernels_sum_a_row_of_20480_nonzeros_in_segments(cuda, s):
    tiles, rows, cols = _skewed_list(cuda)
    m, kdim = 4 * 128, 160 * 128
    index = nonzero_index(tiles, rows, cols, m)
    assert int(index.ptr[1] - index.ptr[0]) >= 20_000 > SEGMENT
    assert int(index.long_ptr[1]) == -(-int(index.ptr[1]) // SEGMENT)
    sigma, depth, delta, omega = _operands(kdim, s, s, cuda)
    acc = torch.randint(0, 7, (m, s), device=cuda).to(torch.float32)
    for t_in in (None, acc):
        got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in,
                                       index=index)
        assert torch.equal(got, ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m,
                                                        t_in))
        torch.testing.assert_close(
            ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m,
                                       acc=t_in, index=index),
            ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m, t_in),
            rtol=1e-5, atol=1e-6,
        )


def test_sparse_kernels_are_bitwise_reproducible(cuda):
    tiles, rows, cols = _skewed_list(cuda, seed=1)
    m, kdim, s = 4 * 128, 160 * 128, 192
    sigma, depth, delta, omega = _operands(kdim, s, 4, cuda)
    acc = torch.rand((m, s), device=cuda)
    index = nonzero_index(tiles, rows, cols, m)
    for t_in in (None, acc):
        runs = [ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m,
                                           acc=t_in, index=index) for _ in range(3)]
        assert all(torch.equal(runs[0], r) for r in runs[1:])
        runs = [ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in,
                                         index=index) for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


def test_sparse_kernels_carry_non_binary_tile_values(cuda):
    for num_tr, num_tc, bm, bk, s in SPARSE_SHAPES:
        tiles, rows, cols = _tile_list(num_tr, num_tc, bm, bk, num_tr + s, cuda)
        tiles = tiles * torch.randn(tiles.shape, generator=torch.Generator(device=cuda)
                                    .manual_seed(s), device=cuda)
        m, kdim = num_tr * bm, num_tc * bk
        _, sigma, depth, delta, omega = _state(kdim, s, kdim + s, 2, torch.float32, cuda)
        acc = torch.randint(0, 7, (m, s), device=cuda).to(torch.float32)
        index = nonzero_index(tiles, rows, cols, m)
        for t_in in (None, acc):
            # σ, g and acc are >= 0, so the plain version on |A| gives Σ|a·x|,
            # the scale of a sum's rounding error (cancellation does not shrink it)
            got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in,
                                           index=index)
            want = ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m, t_in)
            scale = ref.frontier_sparse_ref(tiles.abs(), rows, cols, sigma, depth, 2, m, t_in)
            assert ((got - want).abs() <= 1e-5 * scale).all()
            got = ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1,
                                             m=m, acc=t_in, index=index)
            want = ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m,
                                             t_in)
            scale = ref.dependency_sparse_ref(tiles.abs(), rows, cols, sigma, depth, delta, omega,
                                              1, m, t_in)
            assert ((got - want).abs() <= 1e-5 * scale).all()


def test_sparse_kernels_skip_zero_entries_on_a_non_finite_operand(cuda):
    """The changed edge case: K5 gives what the gather-sum over the index
    gives (no 0·inf = NaN from a tile's zero entries), not the tile
    product's NaN."""
    tiles, rows, cols = _tile_list(4, 3, 8, 8, 7, cuda)
    m, kdim, s = 32, 24, 5
    _, sigma, depth, _, _ = _state(kdim, s, 7, 2, torch.float32, cuda)
    depth[:] = 1
    sigma[int(cols[0]) * 8 + 3, 0] = float("inf")
    index = nonzero_index(tiles, rows, cols, m)
    got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, index=index)
    torch.testing.assert_close(got, ref.frontier_index_ref(index, sigma, depth, 2), rtol=0,
                               atol=0, equal_nan=True)
    assert ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m).isnan().any()
    assert not got.isnan().any()


def test_nonzero_index_of_tiles_past_2_to_the_31_elements(cuda):
    """131 200 tiles of 128 x 128 (2.15e9 elements, 8.6 GB): the index is
    read in chunks, holds the entry of every tile, the last ones too, and
    K5 over it equals the tile product."""
    if torch.cuda.get_device_properties(cuda).total_memory < 24 * 2**30:
        pytest.skip("needs 24 GiB of device memory")
    num_tr, num_tc = 1025, 128
    t = torch.arange(num_tr * num_tc, device=cuda)
    assert t.numel() * 128 * 128 > 2**31
    tiles = torch.zeros((t.numel(), 128, 128), device=cuda)
    tiles[t, t % 128, (7 * t) % 128] = 1.0 + (t % 3).float()
    rows = (t // num_tc).to(torch.int32)
    cols = (t % num_tc).to(torch.int32)
    m, kdim, s = num_tr * 128, num_tc * 128, 8
    index = nonzero_index(tiles, rows, cols, m)
    assert index.col.numel() == t.numel()
    last = t[-1]
    assert int(index.col[-1]) == int(cols[-1]) * 128 + int((7 * last) % 128)
    assert float(index.val[-1]) == float(1 + last % 3)
    sigma, depth, _, _ = _operands(kdim, s, 9, cuda)
    got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, index=index)
    assert torch.equal(got, ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m))
    del tiles
    torch.cuda.empty_cache()


# the ABFT lane's widths: the main path's s = 128 / 192 plus the lane
LANE_WIDTHS = [129, 193]


@pytest.mark.parametrize("s", LANE_WIDTHS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_checked_steps_at_the_lane_widths_match_plain_versions(cuda, dtype, s):
    """The fused operator's checked steps run K3/K4 on the square A with
    the checksum lane as column s + 1 (s real columns): σ and depth
    exact, δ rtol 1e-5 / atol 1e-6 against the same steps' plain
    versions on the host, A aligned and at an offset; residual under
    CHECKSUM_TOL; one K3 and one K4 launch, no K1/K2."""
    from repro_torch.core.driver import CHECKSUM_TOL
    from repro_torch.core.operators import FusedDenseOperator

    A, sigma, depth, delta, omega = _state(4096, s - 1, s, 2, DTYPES[dtype], cuda)
    host = FusedDenseOperator(A.cpu())
    want_s, want_d, _, _ = host.forward_level_checked(2, sigma.cpu(), depth.cpu())
    want_dl, _ = host.backward_level_checked(1, sigma.cpu(), depth.cpu(), omega.cpu(),
                                             delta.cpu())
    for a in (A, _at_offset(A)):
        op = FusedDenseOperator(a)
        ops.reset_launches()
        got_s, got_d, alive, err = op.forward_level_checked(2, sigma, depth)
        got_dl, berr = op.backward_level_checked(1, sigma, depth, omega, delta)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["frontier_spmm_partial"] == ops.LAUNCHES["dependency_spmm_partial"] == 1
        assert ops.LAUNCHES["frontier_spmm"] == ops.LAUNCHES["dependency_spmm"] == 0
        assert torch.equal(got_d.cpu(), want_d) and torch.equal(got_s.cpu(), want_s)
        torch.testing.assert_close(got_dl.cpu(), want_dl, rtol=1e-5, atol=1e-6)
        assert bool(alive) and 0.0 <= float(err) < CHECKSUM_TOL and float(berr) < CHECKSUM_TOL


@pytest.mark.parametrize("s", LANE_WIDTHS)
def test_operand_scratch_pad_columns_are_zero(cuda, monkeypatch, s):
    """K3/K4's operand pass writes the whole [k, ld] scratch: the pad
    columns past s stay zero (a NaN-filled scratch comes back clean), so
    they add nothing to the lane's column sum."""
    import importlib

    from repro_torch.kernels.level_gemm import operand_layout, operand_stride

    # the launcher modules (the package's names are the ops wrappers)
    k13 = importlib.import_module("repro_torch.kernels.frontier_spmm")
    k24 = importlib.import_module("repro_torch.kernels.dependency_spmm")

    seen = []

    def spy(adjacency, sigma):
        operand, ld, bs, fast = operand_layout(adjacency, sigma)
        operand.fill_(float("nan"))
        seen.append(operand)
        return operand, ld, bs, fast

    monkeypatch.setattr(k13, "operand_layout", spy)
    monkeypatch.setattr(k24, "operand_layout", spy)
    A, sigma, depth, delta, omega = _state(1000, s, s, 2, torch.float32, cuda)
    ops.frontier_spmm_partial(A, sigma, depth, 2)
    ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1)
    torch.cuda.synchronize()
    ld = operand_stride(s)
    assert ld > s and len(seen) == 2
    for operand in seen:
        assert operand.shape == (1000, ld)
        assert bool(torch.isfinite(operand).all())
        assert bool((operand[:, s:] == 0).all())


def test_checkpoint_round_trip_of_a_card_run(cuda, tmp_path):
    """A card run stopped after two blocks resumes on the card, and the
    card-written snapshot resumes on the host too, both to the unbroken
    run's BC (rtol 1e-5 / atol 1e-5)."""
    from repro_torch.distributed import BCCheckpoint
    from repro_torch.serving import BlockBudgetStop

    g = pg.rmat_graph(9, 8, seed=2)
    kw = dict(batch_size=64, engine_kind="fused", sampling="fixed", sample_k=320)
    full = pbc.betweenness_centrality(g, **kw)
    for name, device in (("card.npz", None), ("host.npz", "cpu")):
        path = str(tmp_path / name)
        part = pbc.betweenness_centrality(g, checkpoint=BCCheckpoint(path),
                                          stop_rule=BlockBudgetStop(2), **kw)
        assert part.rounds_run == 2
        rest = pbc.betweenness_centrality(g, checkpoint=BCCheckpoint(path), device=device, **kw)
        assert rest.rounds_run == len(full.schedule.rounds) - 2
        np.testing.assert_allclose(rest.bc, full.bc, rtol=1e-5, atol=1e-5)


def test_a_fused_round_without_its_padding_derived_slots_gives_the_same_bits(cuda, monkeypatch):
    """R-MAT 12 under h0, batch 128: every derived slot is padding, so the
    driver ships none and K2 runs at s = 128 (the 128 column tile) where
    the whole round runs it at s = 192 (the 192 tile).  Each column's δ is
    bit-equal between the two (a column's sum over A's rows runs in the
    same order under either tile), the padding columns' δ is 0, n_s, the
    roots and the depth are equal, and K2 launches once a backward step in
    both."""
    from repro_torch.core import driver as pdriver

    g = pg.rmat_graph(12, 16, seed=1)
    schedule, _, residual, omega_np = build_schedule(g, batch_size=128, heuristics="h0")
    rnd = schedule.rounds[0]
    assert rnd.derived.shape == (64, 3) and (rnd.derived[:, 0] < 0).all()
    op = pbc.make_operator(residual, "fused", cuda)
    omega = torch.from_numpy(omega_np).to(device=cuda, dtype=torch.float32)
    sources = torch.from_numpy(rnd.sources).to(cuda)
    deltas = []
    real = pdriver.engine.backward_accumulation
    monkeypatch.setattr(pdriver.engine, "backward_accumulation",
                        lambda *a, **k: deltas.append(real(*a, **k)) or deltas[-1])
    runs = []
    for derived in (rnd.derived, rnd.derived[:0]):
        ops.reset_launches()
        out = pdriver.traversal_round(op, sources, torch.from_numpy(derived).to(cuda), omega)
        torch.cuda.synchronize()
        runs.append((out, ops.LAUNCHES["dependency_spmm"]))
    (whole, k2_whole), (trimmed, k2_trimmed) = runs
    assert deltas[0].shape[1] == 192 and deltas[1].shape[1] == 128
    assert torch.equal(deltas[0][:, :128], deltas[1])
    assert not bool(deltas[0][:, 128:].any())
    assert torch.equal(whole[1][:128], trimmed[1]) and torch.equal(whole[2][:128], trimmed[2])
    assert whole[3] == trimmed[3] > 2
    assert k2_whole == k2_trimmed == whole[3] - 2
    torch.testing.assert_close(trimmed[0], whole[0], rtol=1e-6, atol=0.0)


def test_serve_bc_defaults_to_the_card(cuda, tmp_path, capsys):
    from repro_torch.launch import serve_bc

    ops.reset_launches()
    serve_bc.main(["--grid", "8x8", "--engine", "fused", "--batch-size", "16",
                   "--sample-frac", "1.0", "--ckpt-dir", str(tmp_path)])
    assert ops.LAUNCHES["frontier_spmm"] > 0 and ops.LAUNCHES["dependency_spmm"] > 0
    assert "served" in capsys.readouterr().out


def test_serve_bc_mesh_1x1_under_torchrun_on_the_card(cuda, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", "repro_torch.launch.serve_bc", "--grid", "8x8", "--mesh", "1x1",
           "--engine", "fused_sparse", "--batch-size", "16", "--sample-frac", "1.0",
           "--ckpt-dir", str(tmp_path)]
    for expect in ("slice 1", "resumed serving"):
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert expect in proc.stdout + proc.stderr and "served" in proc.stdout


@pytest.fixture
def nccl_1x1(cuda, tmp_path):
    """A world-size-1 NCCL process group: the 1×1 grid one card can hold."""
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield GridGroups(1, 1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine,kw", [
    ("sparse", {}), ("fused", {}), ("fused_bf16", {}), ("fused_sparse", {}),
    ("fused_sparse", dict(tile=(32, 16))), ("fused_hybrid", dict(hybrid_threshold=0.0)),
    ("fused_hybrid", dict(hybrid_threshold=1e9)),
], ids=["sparse", "fused", "fused_bf16", "fused_sparse", "fused_sparse-32x16",
        "fused_hybrid-dense", "fused_hybrid-bcsr"])
def test_2d_path_on_a_1x1_nccl_grid_matches_dense(nccl_1x1, engine, kw):
    g = pg.rmat_graph(8, 8, seed=1)
    want = pbc.betweenness_centrality(g, batch_size=32, heuristics="h3", engine_kind="dense")
    ops.reset_launches()
    res = distributed_betweenness_centrality(
        g, nccl_1x1, batch_size=32, heuristics="h3", engine_kind=engine, full_result=True, **kw
    )
    dense = engine in ("fused", "fused_bf16") or kw.get("hybrid_threshold") == 0.0
    tiled = engine == "fused_sparse" or kw.get("hybrid_threshold") == 1e9
    for kname in ("frontier_spmm_partial", "dependency_spmm_partial"):
        assert (ops.LAUNCHES[kname] > 0) == dense
    for kname in ("frontier_spmm_sparse", "dependency_spmm_sparse"):
        assert (ops.LAUNCHES[kname] > 0) == tiled
    assert ops.LAUNCHES["frontier_spmm"] == ops.LAUNCHES["dependency_spmm"] == 0
    assert res.round_levels == want.round_levels
    np.testing.assert_allclose(res.bc, want.bc, rtol=1e-5, atol=1e-5)


def test_straggler_policy_and_auto_watchdog_on_a_1x1_nccl_grid(nccl_1x1):
    """One replica holds no straggler policy (refused before any collective);
    the "auto" watchdog, a retry budget and the numeric guard leave the BC
    of the fused run as it was, with K3/K4 launched."""
    g = pg.rmat_graph(8, 8, seed=1)
    kw = dict(batch_size=32, heuristics="h3", engine_kind="fused", full_result=True)
    with pytest.raises(ValueError, match="replicas"):
        distributed_betweenness_centrality(g, nccl_1x1, straggler="steal", **kw)
    want = distributed_betweenness_centrality(g, nccl_1x1, **kw)
    ops.reset_launches()
    res = distributed_betweenness_centrality(g, nccl_1x1, dispatch_deadline_s="auto",
                                             max_retries=1, numeric_guard=True, **kw)
    assert ops.LAUNCHES["frontier_spmm_partial"] > 0 and ops.LAUNCHES["dependency_spmm_partial"] > 0
    np.testing.assert_array_equal(res.bc, want.bc)
    assert res.recovery_stats["integrity"]["watchdog_trips"] == 0


@pytest.mark.parametrize("overlap", ["expand", "expand+fold"])
@pytest.mark.parametrize("engine,kw", [
    ("sparse", {}), ("fused", {}), ("fused_bf16", {}), ("fused_sparse", {}),
    ("fused_hybrid", dict(hybrid_threshold=0.0)), ("fused_hybrid", dict(hybrid_threshold=1e9)),
], ids=["sparse", "fused", "fused_bf16", "fused_sparse", "fused_hybrid-dense",
        "fused_hybrid-bcsr"])
def test_2d_ring_path_on_a_1x1_nccl_grid_matches_dense(nccl_1x1, engine, kw, overlap):
    """Under a ring the fused engines launch only the acc modes of K3/K4
    (dense cells) or K5/K6 (tiled cells), and no K1/K2."""
    g = pg.rmat_graph(8, 8, seed=1)
    want = pbc.betweenness_centrality(g, batch_size=32, heuristics="h3", engine_kind="dense")
    ops.reset_launches()
    res = distributed_betweenness_centrality(
        g, nccl_1x1, batch_size=32, heuristics="h3", engine_kind=engine, overlap=overlap,
        full_result=True, **kw
    )
    dense = engine in ("fused", "fused_bf16") or kw.get("hybrid_threshold") == 0.0
    tiled = engine == "fused_sparse" or kw.get("hybrid_threshold") == 1e9
    for kname in ("frontier_spmm_partial", "dependency_spmm_partial"):
        assert ops.LAUNCHES[kname] == 0 and (ops.LAUNCHES[kname + "_acc"] > 0) == dense
    for kname in ("frontier_spmm_sparse", "dependency_spmm_sparse"):
        assert ops.LAUNCHES[kname] == 0 and (ops.LAUNCHES[kname + "_acc"] > 0) == tiled
    assert ops.LAUNCHES["frontier_spmm"] == ops.LAUNCHES["dependency_spmm"] == 0
    assert res.round_levels == want.round_levels
    np.testing.assert_allclose(res.bc, want.bc, rtol=1e-5, atol=1e-5)


def test_ring_slab_and_slot_chain_equals_the_barrier_partial(cuda):
    """Cell (0, 0) of a 4x2 grid: K3/K4 chained in acc mode over the R
    column slabs, and K5/K6 over the R tile slots (each with its own
    nonzero index), with the operand's chunks in ring order, equal the
    barrier partial of the whole cell: K3/K5 exact, K4/K6 rtol 1e-5 /
    atol 1e-6."""
    from repro_torch.graphs.partition import partition_2d

    g = pg.rmat_graph(9, 8, seed=1)
    part = partition_2d(g, 4, 2)
    R, chunk, m = part.R, part.chunk, part.C * part.chunk
    s = 40
    _, sigma, depth, delta, omega = _state(R * chunk, s, 3, 2, torch.float32, cuda)
    block = part.cell_dense_block(0, 0, torch.float32, cuda)
    slabs = part.cell_dense_slabs(0, 0, torch.float32, cuda)
    tiles, rows, cols = part.cell_blocked_sparse(0, 0, 16, 16, device=cuda)
    full_index = nonzero_index(tiles, rows, cols, m)
    slots = [slot + (nonzero_index(*slot, m),)
             for slot in part.cell_ring_blocked_sparse(0, 0, 16, 16, device=cuda)]
    ops.reset_launches()
    want_f = ops.frontier_spmm_partial(block, sigma, depth, 2)
    want_b = ops.dependency_spmm_partial(block, sigma, depth, delta, omega, 1)
    want_fs = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, index=full_index)
    want_bs = ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m,
                                         index=full_index)
    acc = {k: torch.zeros((m, s), device=cuda) for k in ("f", "b", "fs", "bs")}
    for t in range(R):
        r = (0 - t) % R  # the chunk rank (0, 0) holds at ring step t
        part_r = slice(r * chunk, (r + 1) * chunk)
        sg, dp, dl, om = (x[part_r].contiguous() for x in (sigma, depth, delta, omega))
        acc["f"] = ops.frontier_spmm_partial(slabs[r], sg, dp, 2, acc["f"])
        acc["b"] = ops.dependency_spmm_partial(slabs[r], sg, dp, dl, om, 1, acc["b"])
        st, sr, sc, six = slots[r]
        acc["fs"] = ops.frontier_spmm_sparse(st, sr, sc, sg, dp, 2, m=m, acc=acc["fs"],
                                             index=six)
        acc["bs"] = ops.dependency_spmm_sparse(st, sr, sc, sg, dp, dl, om, 1, m=m,
                                               acc=acc["bs"], index=six)
    torch.cuda.synchronize()
    assert torch.equal(acc["f"], want_f) and torch.equal(acc["fs"], want_fs)
    torch.testing.assert_close(acc["b"], want_b, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc["bs"], want_bs, rtol=1e-5, atol=1e-6)
    for kname in ("frontier_spmm_partial", "dependency_spmm_partial", "frontier_spmm_sparse",
                  "dependency_spmm_sparse"):
        assert ops.LAUNCHES[kname] == 1 and ops.LAUNCHES[kname + "_acc"] == R


#: the arc product's widths: the s23 cell's forward and backward (16, 24),
#: with the checksum lane (17, 25), a split backward's half (12), and 1, 40
ARC_WIDTHS = [1, 12, 16, 17, 24, 25, 40]


def _arc_case(layout, device):
    """(n, src, pieces, counts, plan) of an R-MAT arc list sorted by
    destination (``_arc_operands``' on the card: ``src`` the plan's int32
    index), with empty rows and padding arcs n → n into the sentinel
    row: scale 12 has 79 rows longer than a piece ("pieces"), scale 10 at
    edge factor 2 none, nor a sentinel row past one piece ("no-pieces")."""
    graph, pad = {"pieces": (pg.rmat_graph(12, 16, seed=1), 600),
                  "no-pieces": (pg.rmat_graph(10, 2, seed=1), 100)}[layout]
    n = graph.n
    src, dst = (torch.cat([torch.from_numpy(a).long(), torch.full((pad,), n)]).to(device)
                for a in (graph.src, graph.dst))
    src, _, _, lengths = operators._by_destination(src, dst, None, n)
    src, pieces, counts, plan = operators._arc_operands(src, lengths, n)
    assert (pieces is None) == (layout == "no-pieces") and plan is not None
    assert src is plan.src and src.dtype == torch.int32
    return n, src, pieces, counts, plan


def _arc_operand(rows, s, seed, device):
    """f32 [rows + 1, s], the sentinel row zero: half the entries ±2^60,
    half of order 2^-10 .. 2^10, so that which small terms a float64 sum
    keeps while the big ones cancel, and so its f32 bits, depend on its
    order."""
    rng = np.random.default_rng(seed)
    small = rng.standard_normal((rows + 1, s)) * 2.0 ** rng.integers(-10, 11, (rows + 1, s))
    big = rng.choice([-(2.0**60), 2.0**60], (rows + 1, s))
    x = np.where(rng.random((rows + 1, s)) < 0.5, big, small)
    x[rows] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(device)


def _torch_arc_product(x, src, pieces, counts, rows, plan=None):
    """``operators._arc_product`` as the torch version computes it on any
    device (the plan ignored): the card tests' reference."""
    out = operators._arc_sum(x.reshape(x.shape[0], -1), src, pieces, counts, rows)
    return out.reshape((rows,) + tuple(x.shape[1:]))


@pytest.mark.parametrize("layout", ["pieces", "no-pieces"])
def test_arc_product_kernel_equals_the_torch_version_bitwise(cuda, layout, monkeypatch):
    """At every width the card's callers use, the kernel's rows equal the
    torch version's on the same card tensors bit for bit (in one pass and
    in four column passes), and the CPU's; two launches give the same
    bits, and each call launches once."""
    n, src, pieces, counts, plan = _arc_case(layout, cuda)
    for s in ARC_WIDTHS:
        x = _arc_operand(n, s, s, cuda)
        ops.reset_launches()
        got = operators._arc_product(x, src, pieces, counts, n, plan)
        again = operators._arc_product(x, src, pieces, counts, n, plan)
        assert ops.LAUNCHES["arc_product"] == 2
        want = operators._arc_sum(x, src, pieces, counts, n)
        monkeypatch.setattr(operators, "_ARC_PASS_BYTES", 0)
        passes = operators._arc_sum(x, src, pieces, counts, n)
        monkeypatch.undo()
        torch.cuda.synchronize()
        assert got.shape == (n, s) and torch.equal(got, want), s
        assert torch.equal(again, got) and torch.equal(passes, want), s
        cpu = operators._arc_sum(x.cpu(), src.cpu(), *(None if t is None else t.cpu()
                                                        for t in (pieces, counts)), n)
        assert torch.equal(got.cpu(), cpu), s


def test_arc_product_kernel_holds_no_arcs_by_width_transient(cuda):
    """A call on 4 Mi arcs at s = 24 grows the card's allocation by its
    output, its f64 scratch and 64 MiB at most: the torch version's
    [arcs, 24] messages alone are 384 MiB."""
    n, arcs, s = 1 << 16, 1 << 22, 24
    gen = torch.Generator(device=cuda).manual_seed(0)
    dst = torch.randint(0, n, (arcs,), device=cuda, generator=gen)
    dst[:5000] = 7  # a row of 20 pieces
    src = torch.randint(0, n, (arcs,), device=cuda, generator=gen)
    src, _, _, lengths = operators._by_destination(src, dst, None, n)
    src, pieces, counts, plan = operators._arc_operands(src, lengths, n)
    x = torch.randn((n, s), device=cuda, generator=gen)
    operators._arc_product(x, src, pieces, counts, n, plan)  # the library's first load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = operators._arc_product(x, src, pieces, counts, n, plan)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert plan.n_long_seg >= 20 and arcs * s * 4 > 4 * (64 << 20)
    assert grown <= out.nbytes + plan.n_long_seg * s * 8 + (64 << 20), grown


def test_arc_product_on_the_card_refuses_what_the_kernel_does_not_take(cuda):
    n, src, pieces, counts, plan = _arc_case("pieces", cuda)
    x = _arc_operand(n, 16, 0, cuda)
    ops.reset_launches()
    with pytest.raises(TypeError, match="float32"):
        ops.arc_product(x.double(), plan, n)
    with pytest.raises(ValueError, match="contiguous"):
        ops.arc_product(_arc_operand(n, 32, 0, cuda)[:, ::2], plan, n)
    with pytest.raises(ValueError, match="one device"):
        ops.arc_product(x.cpu(), plan, n)
    with pytest.raises(ValueError, match="work list"):  # no plan: no torch version on the card
        operators._arc_product(x, src, pieces, counts, n)
    assert ops.LAUNCHES["arc_product"] == 0


@pytest.mark.parametrize("mode", ["barrier", "split", "ring", "checksum"])
def test_2d_sparse_operator_through_the_arc_kernel_equals_the_torch_version(nccl_1x1, mode,
                                                                            monkeypatch):
    """The 1×1 grid's sparse operator at the s23 cell's widths: the barrier
    schedule, the split backward's halves, the expand+fold ring (the
    kernel's rows added into the ring's accumulator) and the checksum
    lane's s + 1, each bit-equal to the torch version."""
    from repro_torch.core.distributed import distributed_graph_arrays, make_distributed_operator
    from repro_torch.graphs.partition import partition_2d

    part = partition_2d(pg.rmat_graph(12, 16, seed=1), 1, 1)
    overlap = "expand+fold" if mode == "ring" else "none"
    args = distributed_graph_arrays(part, "sparse", 0, 0, torch.device("cuda"), overlap=overlap)

    def run():
        op = make_distributed_operator("sparse", args, chunk=part.chunk, groups=nccl_1x1,
                                       split_backward=mode == "split", overlap=overlap)
        outs = []
        for s in (16, 24):
            x = _arc_operand(part.chunk - 1, s, s, torch.device("cuda"))
            if mode == "checksum":
                x = ops.checksum_append(x)
            outs.append(op.apply_backward(x) if mode == "split" else op.apply(x))
        torch.cuda.synchronize()
        return outs

    ops.reset_launches()
    got = run()
    assert ops.LAUNCHES["arc_product"] == (4 if mode == "split" else 2)
    monkeypatch.setattr(operators, "_arc_product", _torch_arc_product)
    for g, w in zip(got, run()):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["one-device", "1x1", "1x1-checksum", "1x1-expand+fold"])
def test_sparse_bc_through_the_arc_kernel_equals_the_torch_version(nccl_1x1, case, monkeypatch):
    """Whole sparse BC runs, one device and the 1×1 NCCL grid (barrier,
    checksum lane, ring), launch the kernel and give the torch version's
    BC bit for bit."""
    g = pg.rmat_graph(10, 8, seed=1)

    def run():
        kw = dict(batch_size=32, heuristics="h3", engine_kind="sparse")
        if case == "one-device":
            res = pbc.betweenness_centrality(g, **kw)
        else:
            extra = {"1x1": {}, "1x1-checksum": dict(integrity="checksum"),
                     "1x1-expand+fold": dict(overlap="expand+fold")}[case]
            res = distributed_betweenness_centrality(g, nccl_1x1, full_result=True, **kw,
                                                     **extra)
        return res.bc, res.round_levels

    ops.reset_launches()
    got, levels = run()
    assert ops.LAUNCHES["arc_product"] > 0
    monkeypatch.setattr(operators, "_arc_product", _torch_arc_product)
    ops.reset_launches()
    want, want_levels = run()
    assert ops.LAUNCHES["arc_product"] == 0
    assert levels == want_levels
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, brandes_reference(g), rtol=1e-5, atol=1e-5)


def _bucket_hooks_on_the_card(monkeypatch) -> list:
    """Wrap the weighted operators' bucket hooks to record, per call,
    whether every tensor in and out was on the card."""
    seen = []
    for cls in (WeightedSparseOperator, WeightedDenseOperator, DistributedWeightedOperator,
                DistributedWeightedDenseOperator):
        for hook in ("relax", "sigma_step", "delta_step"):
            def wrapped(self, *args, _orig=getattr(cls, hook), **kw):
                out = _orig(self, *args, **kw)
                seen.append(all(t.is_cuda for t in args + (out,) if isinstance(t, torch.Tensor)))
                return out

            monkeypatch.setattr(cls, hook, wrapped)
    return seen


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_weighted_engines_on_the_card_match_the_cpu(cuda, engine, monkeypatch):
    """A weighted call on the card equals the same call on the CPU, launches
    no kernel (the weighted path has none) and keeps every bucket step on
    the card."""
    g = pg.rmat_graph(8, 8, seed=1, weights="dyadic")
    kw = dict(batch_size=32, engine_kind=engine, weighted=True)
    want = pbc.betweenness_centrality(g, device="cpu", **kw)
    seen = _bucket_hooks_on_the_card(monkeypatch)
    ops.reset_launches()
    got = pbc.betweenness_centrality(g, **kw)
    assert seen and all(seen)
    assert not any(ops.LAUNCHES.values())
    assert got.round_levels == want.round_levels
    np.testing.assert_allclose(got.bc, want.bc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["sparse", "fused", "fused_sparse"])
def test_weighted_2d_path_on_a_1x1_nccl_grid_matches_one_device(nccl_1x1, engine, monkeypatch):
    g = pg.road_like_graph(6, 6, seed=1, weights="dyadic")
    want = pbc.betweenness_centrality(g, batch_size=32, heuristics="h1", weighted=True)
    seen = _bucket_hooks_on_the_card(monkeypatch)
    ops.reset_launches()
    res = distributed_betweenness_centrality(g, nccl_1x1, batch_size=32, heuristics="h1",
                                             engine_kind=engine, weighted=True, full_result=True)
    assert seen and all(seen)
    assert not any(ops.LAUNCHES.values())
    assert res.round_levels == want.round_levels
    np.testing.assert_allclose(res.bc, want.bc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("engine", ["fused", "fused_bf16"])
@pytest.mark.parametrize("heuristics", ["h0", "h3t"])
def test_fused_engines_on_the_card_match_the_oracle(cuda, engine, heuristics):
    g = pg.road_like_graph(6, 6, seed=1)
    ops.reset_launches()
    got = pbc.betweenness_centrality(g, batch_size=16, heuristics=heuristics, engine_kind=engine)
    assert ops.LAUNCHES["frontier_spmm"] > 0 and ops.LAUNCHES["dependency_spmm"] > 0
    np.testing.assert_allclose(got.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)


def test_cli_mesh_1x1_under_torchrun_on_the_card(cuda, tmp_path):
    out = tmp_path / "bc.npy"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "repro_torch.launch.bc", "--grid", "6x6", "--mesh", "1x1", "--engine", "fused",
         "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(
        np.load(out), brandes_reference(pg.grid_graph(6, 6)), rtol=1e-5, atol=1e-5
    )


def test_cli_defaults_to_the_card(cuda, tmp_path):
    from repro_torch.launch import bc as cli

    out = tmp_path / "bc.npy"
    ops.reset_launches()
    cli.main(["--grid", "6x6", "--engine", "fused", "--out", str(out)])
    assert ops.LAUNCHES["frontier_spmm"] > 0
    np.testing.assert_allclose(
        np.load(out), brandes_reference(pg.grid_graph(6, 6)), rtol=1e-5, atol=1e-5
    )


# (V, D, B, L): the JAX test grid, ragged D (odd, not a multiple of 4 or
# 8, one above a full warp's 16-byte columns), L = 1 and L = 0
BAG_SHAPES = [(32, 8, 4, 3), (64, 128, 8, 5), (128, 96, 16, 10), (1000, 64, 32, 26),
              (50, 13, 6, 4), (300, 7, 100, 1), (64, 260, 9, 3), (10, 64, 1000, 1), (10, 8, 5, 0)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_segment_bag_kernel_matches_plain_version(cuda, dtype, weighted):
    rtol, atol = (2e-2, 1e-5) if dtype == "bf16" else (1e-6, 1e-6)
    for V, D, b, L in BAG_SHAPES:
        rng = np.random.default_rng(V + D + b + L)
        table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(
            device=cuda, dtype=DTYPES[dtype])
        idx = torch.from_numpy(rng.integers(-1, V, size=(b, L)).astype(np.int32)).to(cuda)
        idx[0] = -1  # a bag of nothing but padding
        w = (torch.from_numpy(rng.random((b, L)).astype(np.float32)).to(cuda)
             if weighted else None)
        ops.reset_launches()
        got = ops.segment_bag(table, idx, w)
        assert ops.LAUNCHES["segment_bag"] == 1
        torch.testing.assert_close(got, ref.segment_bag_ref(table, idx, w), rtol=rtol, atol=atol)
        assert float(got[0].abs().sum()) == 0.0
    # a table view that starts off the 16-byte alignment takes the scalar path
    base = torch.randn(101 * 8 + 1, device=cuda).to(DTYPES[dtype])
    table = base[1:].view(101, 8)
    idx = torch.randint(-1, 101, (33, 4), device=cuda, dtype=torch.int32)
    torch.testing.assert_close(ops.segment_bag(table, idx), ref.segment_bag_ref(table, idx),
                               rtol=rtol, atol=atol)


def test_segment_bag_reads_rows_past_2_to_the_31_elements(cuda):
    """A [35 000 000, 64] f32 table (2.24e9 elements, 9 GB): row·D overflows
    32 bits for every row above 33 554 431."""
    V, D = 35_000_000, 64
    if torch.cuda.get_device_properties(cuda).total_memory < 12 * 2**30:
        pytest.skip("needs 12 GiB of device memory")
    table = torch.empty((V, D), device=cuda)
    rows = torch.arange(V - 4096, V, device=cuda, dtype=torch.int32)  # all above 2^25
    table[rows.long()] = torch.randn((rows.numel(), D), device=cuda)
    table[:4096] = 0.0
    idx = torch.stack([rows, rows.flip(0), torch.full_like(rows, -1)], dim=1)  # [4096, 3]
    got = ops.segment_bag(table, idx)
    want = ref.segment_bag_ref(table, idx)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[:, :1], (table[rows.long()] + table[rows.flip(0).long()])[:, :1],
                               rtol=1e-6, atol=1e-6)
    del table
    torch.cuda.empty_cache()


def test_reduced_dlrm_on_the_card_matches_the_cpu(cuda):
    import dataclasses

    resolve_device("cuda")  # TF32 off
    cfg = dataclasses.replace(get_arch("dlrm-rm2").arch, rows_per_table=1000, hot_size=3)
    cpu = DLRM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = DLRM(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    dense = torch.from_numpy(rng.standard_normal((64, cfg.n_dense)).astype(np.float32))
    sparse = torch.from_numpy(
        rng.integers(-1, cfg.rows_per_table, (64, cfg.n_sparse, cfg.hot_size)).astype(np.int32))
    with torch.inference_mode():
        want_logit, want_feats = cpu(dense, sparse)
        ops.reset_launches()
        logit, feats = gpu(dense.to(cuda), sparse.to(cuda))
        assert ops.LAUNCHES["segment_bag"] == 1
    torch.testing.assert_close(feats.cpu(), want_feats, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logit.cpu(), want_logit, rtol=1e-5, atol=1e-5)


def test_segment_bag_gradient_on_the_card_matches_the_plain_autograd(cuda):
    """K7's autograd Function on the card: the forward is K7 (one launch,
    equal to the plain version: the same sum in the same order); the
    table gradient is the order-fixed float64 sum rounded once, within
    rtol 1e-6 (atol 1e-9: the float64 sum's own rounding) of autograd
    through the plain version in float64, and within rtol 1e-5 of the
    plain version's float32 autograd (``index_add_``'s atomics) plus the
    bound of any float32 summation order, (n - 1)·2^-24·Σ|t| for an
    entry's n terms (the hot row's ~2 000 cancel: rtol alone cannot hold
    them); two backward passes give the same bits."""
    rng = np.random.default_rng(11)
    V, D, nb, L = 2000, 64, 4096, 3
    idx = torch.from_numpy(((rng.zipf(1.2, size=(nb, L)) - 1) % V).astype(np.int32)).to(cuda)
    idx[::9, -1] = -1
    table_np = rng.standard_normal((V, D)).astype(np.float32)
    up = torch.from_numpy(rng.standard_normal((nb, D)).astype(np.float32)).to(cuda)
    table = torch.tensor(table_np, device=cuda, requires_grad=True)
    grads = []
    for _ in range(2):
        table.grad = None
        ops.reset_launches()
        out = ops.segment_bag(table, idx)
        (out * up).sum().backward()
        torch.cuda.synchronize()
        assert ops.LAUNCHES["segment_bag"] == 1  # the forward; the backward is torch ops
        grads.append(table.grad.clone())
    assert torch.equal(grads[0], grads[1])
    t64 = torch.tensor(table_np, dtype=torch.float64, device=cuda, requires_grad=True)
    (ref.segment_bag_ref(t64, idx) * up.double()).sum().backward()
    torch.testing.assert_close(grads[0].double(), t64.grad, rtol=1e-6, atol=1e-9)
    plain = torch.tensor(table_np, device=cuda, requires_grad=True)
    want = ref.segment_bag_ref(plain, idx)
    assert torch.equal(out.detach(), want.detach())
    (want * up).sum().backward()
    valid = idx >= 0
    rows = idx[valid].long()
    terms = torch.bincount(rows, minlength=V).double()
    bags = torch.nonzero(valid)[:, 0]
    scale = torch.zeros((V, D), dtype=torch.float64, device=cuda).index_add_(
        0, rows, up[bags].abs().double())
    bound = (terms - 1).clamp(min=0)[:, None] * 2.0**-24 * scale
    assert bool(((plain.grad.double() - t64.grad).abs() <= bound + 1e-12).all())
    assert bool(((grads[0] - plain.grad).abs().double()
                 <= 1e-5 * plain.grad.abs().double() + bound + 1e-12).all())


def _two_lane_fused(graph, batch, device):
    schedule, prep, residual, omega_np = build_schedule(graph, batch_size=batch)
    op = pbc.make_operator(residual, "fused", device)
    fn = pbc.make_round_fn(op, torch.from_numpy(omega_np).to(device=device, dtype=torch.float32))
    return fn, schedule, prep


@pytest.mark.parametrize("policy", ["steal", "redeal"])
def test_two_lane_fused_driver_under_a_straggler_policy_equals_the_static_loop(cuda, policy):
    """Two lanes of K1/K2 rounds on one card, dealt by the multi-ledger loop
    (deep path rounds beside shallow clique rounds, an odd count so that the
    steal tail runs a duplicate): the BC of the static loop and the oracle."""
    g = pg.disjoint_union(pg.skewed_depth_graph(4, 64), pg.path_graph(64))  # 9 rounds
    fn, schedule, prep = _two_lane_fused(g, 64, cuda)
    static = BCDriver(fn, schedule, n=g.n, device=cuda, prep=prep, rounds_per_dispatch=2).run()
    ops.reset_launches()
    res = BCDriver(fn, schedule, n=g.n, device=cuda, prep=prep, rounds_per_dispatch=2,
                   straggler=policy).run()
    assert ops.LAUNCHES["frontier_spmm"] > 0 and ops.LAUNCHES["dependency_spmm"] > 0
    np.testing.assert_allclose(res.bc, static.bc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)
    stats = res.straggler_stats
    assert res.rounds_run == 9 and sum(stats["per_replica_rounds"]) == 9
    if policy == "steal":
        assert stats["duplicates_discarded"] == stats["duplicates_dispatched"] >= 1
    else:
        assert stats["redeal_events"] >= 1


def test_profile_fills_block_times_on_the_card(cuda):
    g = pg.rmat_graph(8, 8, seed=1)
    fn, schedule, prep = _two_lane_fused(g, 32, cuda)
    res = BCDriver(fn, schedule, n=g.n, device=cuda, prep=prep, rounds_per_dispatch=2,
                   profile=True).run()
    assert len(res.block_times) == -(-len(schedule.rounds) // 2)
    assert min(res.block_times) > 0 and res.recovery_stats["quarantined_blocks"] == 0
    np.testing.assert_allclose(res.bc, brandes_reference(g), rtol=1e-5, atol=1e-5)


def test_bc_cell_round_on_a_1x1_nccl_grid_matches_one_device(nccl_1x1):
    """The bc-rmat cell at R-MAT scale 12 (the arch's batch 16, h3, 12
    levels) on the card: its first round, at the static bound and with
    the liveness loop, against the single-device sparse round of the same
    residual, ω and inputs (rtol 1e-5 / atol 1e-5), under the work
    counter (memory-bound, 23 level products of the static round)."""
    from repro_torch.configs import ArchBundle, BCShape
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline import WorkCounter, roofline_terms

    arch = get_arch("bc-rmat").arch
    cell = build_cell(ArchBundle(arch, {"s12": BCShape("s12", 12, 16)}), "s12", nccl_1x1, seed=1)
    sources, derived = cell.round_inputs(0)
    with WorkCounter() as counter:
        static = cell.fn(sources, derived)
    live = cell.fn(sources, derived, num_levels=None)
    op = pbc.make_operator(cell.residual, "sparse", torch.device("cuda"))
    omega = torch.from_numpy(cell.omega.astype(np.float32)).cuda()
    one = pbc.make_round_fn(op, omega)(torch.from_numpy(sources).cuda(),
                                       torch.from_numpy(derived).cuda())
    n = cell.residual.n
    assert static[0].is_cuda and int(live[3][0]) == one[3][0] == int(static[3][0])
    for got in (static, live):
        np.testing.assert_allclose(got[0][0, :n].cpu().numpy(), one[0][0].cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert counter.by_name()["arc_sum"]["calls"] == 2 * arch.max_levels - 1
    terms = roofline_terms(counter.terms(), 1, cell.static_meta["model_flops"])
    assert terms.bottleneck == "memory" and terms.collective_s == 0.0


LM_ARCHS = ["gemma-7b", "codeqwen1.5-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b"]
LM_DECODE_MARGIN = 8 << 20


@pytest.mark.parametrize("name", LM_ARCHS)
def test_reduced_lm_on_the_card_matches_the_cpu(cuda, name):
    resolve_device(cuda)  # TF32 off, bf16 GEMMs reduced in f32
    cfg = reduced_lm(get_arch(name).arch, layers=2, d_model=128, vocab=512)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = TransformerLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 264))
                              .astype(np.int32))
    runs = []
    for model in (cpu, card):
        t = tokens.to(model.device)
        logits, cache = model.prefill(t[:, :256], max_seq=264)
        steps = [logits]
        for i in range(8):  # teacher-forced
            logits, cache = model.decode_step(cache, t[:, 256 + i], 256 + i)
            steps.append(logits)
        runs.append((torch.stack(steps).cpu(), {k: v.cpu().float() for k, v in cache.items()}))
    (lw, cw), (lg, cg) = runs
    err = ((lg - lw).abs().amax(dim=-1) / lw.abs().amax(dim=-1)).max().item()
    assert err <= 5e-2, err
    for key in ("k", "v"):
        rows = (cg[key] - cw[key]).abs().amax(dim=(-2, -1))
        off = (rows > 2e-2 * cw[key].abs().max()).float().mean().item()
        assert off <= (0.01 if cfg.moe is not None else 0.0), (key, off)


@pytest.mark.parametrize("name,batch", [("granite-moe-1b-a400m", 1), ("granite-moe-1b-a400m", 5),
                                        ("gemma-7b", 3)])
def test_graph_replayed_decode_equals_the_eager_step_bitwise(cuda, name, batch):
    cfg = reduced_lm(get_arch(name).arch, layers=2, d_model=256, vocab=512)
    model = TransformerLM(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (batch, 72), device=cuda, dtype=torch.int32,
                           generator=torch.Generator(device=cuda).manual_seed(2))
    _, eager = model.prefill(tokens[:, :64], max_seq=72)
    graph = {k: v.clone() for k, v in eager.items()}
    for i in range(8):
        want, _ = model.decode_step(eager, tokens[:, 64 + i], 64 + i, graph=False)
        got, _ = model.decode_step(graph, tokens[:, 64 + i], torch.tensor(64 + i, device=cuda))
        assert torch.equal(got, want), i
    assert torch.equal(graph["k"], eager["k"]) and torch.equal(graph["v"], eager["v"])
    assert model._graph is not None and model._graph.fits(graph, tokens[:, 0])


def test_score_product_takes_bf16_operands_to_an_f32_result(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    cache = torch.randn((3, 1000, 8, 64), generator=gen, device=cuda).bfloat16()
    q = torch.randn((3, 2, 64), generator=gen, device=cuda).bfloat16()
    got = bmm_f32(q, cache[:, :, 5].transpose(1, 2))  # a strided head of the cache
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2, 1000)
    want = torch.bmm(q.float(), cache[:, :, 5].transpose(1, 2).float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_lm_decode_makes_no_f32_copy_of_the_cache(cuda):
    cfg = reduced_lm(get_arch("granite-moe-1b-a400m").arch, layers=2, d_model=256, vocab=512)
    model = TransformerLM(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    for batch in (1, 4):  # B <= K: a product a sequence; B > K: a product a kv head
        cache = model.empty_cache(batch, 1 << 16)
        for c in cache.values():
            c.normal_()
        tokens = torch.zeros(batch, dtype=torch.int32, device=cuda)
        model.decode_step(cache, tokens, (1 << 16) - 1, graph=False)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()  # op by op: a graph's pool holds the same buffers
        logits, _ = model.decode_step(cache, tokens, (1 << 16) - 1, graph=False)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        layer_f32 = cache["k"][0].numel() * 4
        assert bool(torch.isfinite(logits).all())
        assert extra <= LM_DECODE_MARGIN < layer_f32 // 2, (batch, extra, layer_f32)
        del cache


# ------------------------------------------------------------- LM training
def _pinned(model, routes):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_lm_routes import port_routes  # imports no JAX

    return port_routes(model, routes)


def test_bmm_f32_backward_on_the_card_matches_the_cpu(cuda):
    """The score product's autograd Function: the card's f32-result product
    and its f32 cotangent products against the CPU's upcast ones."""
    resolve_device(cuda)  # TF32 off: the cotangent products are f32 products
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((8, 256, 64), generator=gen).bfloat16()  # [B·K, G·q_chunk, hd]
    b = torch.randn((8, 64, 512), generator=gen).bfloat16()  # [B·K, hd, S]
    g = torch.randn((8, 256, 512), generator=gen)
    grads = []
    for where in ("cpu", cuda):
        ta = a.to(where, copy=True).requires_grad_()  # a leaf on each device
        tb = b.to(where, copy=True).requires_grad_()
        out = bmm_f32(ta, tb)
        assert out.dtype == torch.float32 and out.grad_fn is not None
        out.backward(g.to(where))
        grads.append((out.detach().cpu(), ta.grad.cpu(), tb.grad.cpu()))
    (out_c, ga_c, gb_c), (out_g, ga_g, gb_g) = grads
    torch.testing.assert_close(out_g, out_c, rtol=1e-5, atol=1e-5)
    assert ga_g.dtype == gb_g.dtype == torch.bfloat16
    # one bf16 unit of the value, plus 1e-5 of Σ|terms| (f32 sums in another
    # order; cancellation does not shrink their rounding)
    scales = (torch.bmm(g.abs(), b.float().abs().transpose(1, 2)),
              torch.bmm(a.float().abs().transpose(1, 2), g.abs()))
    for (got, want), scale in zip(((ga_g, ga_c), (gb_g, gb_c)), scales):
        err = (got.float() - want.float()).abs()
        assert bool((err <= 2.0**-7 * want.float().abs() + 1e-5 * scale).all())


def _lm_grads(model, tokens, routes=None):
    from repro_torch.models.transformer import lm_loss

    model.zero_grad(set_to_none=True)
    with _pinned(model, routes) as used:
        loss, metrics = lm_loss(model, tokens.to(model.device))
        loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), metrics["aux"].item(), grads, used


@pytest.mark.parametrize("name", LM_ARCHS)
def test_reduced_lm_loss_backward_on_the_card_matches_the_cpu(cuda, name):
    """lm_loss and every gradient of a reduced LM (255 tokens: a chunk and a
    tail, remat on), card against CPU on the CPU's expert routes, at the
    CPU tests' tolerances against the JAX package: the loss 1e-2
    relative, each gradient 5 % of its largest value."""
    resolve_device(cuda)
    cfg = reduced_lm(get_arch(name).arch, layers=2, d_model=128, vocab=512)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                        trainable=True)
    card = TransformerLM(cfg, device=cuda, trainable=True)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 256))
                              .astype(np.int32))
    loss_c, aux_c, grads_c, routes = _lm_grads(cpu, tokens)
    loss_g, aux_g, grads_g, _ = _lm_grads(card, tokens, routes or None)
    assert abs(loss_g - loss_c) <= 1e-2 * abs(loss_c)
    assert abs(aux_g - aux_c) <= 1e-2 * max(abs(aux_c), 1e-30) or aux_c == aux_g == 0.0
    for key, want in grads_c.items():
        got = grads_g[key]
        assert got.dtype == want.dtype
        err = (got.double() - want.double()).abs().max() / want.double().abs().max()
        assert err <= 5e-2, (key, err.item())


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"])
def test_reduced_train_cell_step_on_the_card_matches_the_cpu(cuda, name):
    """One train-cell step (AdamW / Adafactor) from the same weights on the
    card and on the CPU, the card on the CPU's routes: the loss 1e-2
    relative, the optimizer's first moments 5 % and second moments 10 % of
    their largest value, each parameter within 2·lr plus one unit, and
    each parameter's update against the CPU's by norms over the leaf
    (tests/torch_lm_routes.py:update_gap, the CPU tests' bounds)."""
    from repro_torch.configs import ArchBundle, LMShape
    from repro_torch.launch.steps import build_lm_cell
    from torch_lm_routes import UPDATE_TOL_DIR, UPDATE_TOL_NORM, leaves, update_gap

    resolve_device(cuda)
    cfg = reduced_lm(get_arch(name).arch, layers=2, d_model=128, vocab=512)
    bundle = ArchBundle(cfg, {"t": LMShape("t", "train", 128, 2)})
    cpu = build_lm_cell(bundle, "t", device="cpu", seed=0)
    card = build_lm_cell(bundle, "t", device=cuda, seed=0)
    assert cpu.optimizer.param_groups[0]["lr"] == 1e-4  # the reference cell's
    card.load_train_state(cpu.train_state())
    start = {k: p.detach().double().clone() for k, p in leaves(cpu.train_state()["params"])}
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    with _pinned(cpu.model, None) as routes:
        want = cpu.fn({"tokens": tokens})
    with _pinned(card.model, routes or None):
        got = card.fn({"tokens": tokens})
    assert abs(got["loss"].item() - want["loss"].item()) <= 1e-2 * abs(want["loss"].item())
    lr = cpu.optimizer.param_groups[0]["lr"]
    sw, sg = cpu.train_state(), card.train_state()
    for key, p in [("embed", sw["params"]["embed"]), ("ln_f", sw["params"]["ln_f"]),
                   *sw["params"]["layers"].items()]:
        q = sg["params"][key] if key in ("embed", "ln_f") else sg["params"]["layers"][key]
        unit = 2.0**-7 if p.dtype == torch.bfloat16 else 2.0**-22
        diff = (q.detach().cpu().double() - p.detach().double()).abs()
        assert bool((diff <= 2 * lr + unit * p.detach().double().abs()).all()), key
        base = start[key if key in ("embed", "ln_f") else f"layers/{key}"]
        gap_dir, gap_norm = update_gap(q.detach().cpu().double().numpy(),
                                       p.detach().double().numpy(), base.numpy())
        assert gap_dir <= UPDATE_TOL_DIR and abs(gap_norm) <= UPDATE_TOL_NORM, (
            key, gap_dir, gap_norm)
    assert int(sg["opt"]["step"]) == int(sw["opt"]["step"]) == 1
    for slot in sw["opt"]:
        if slot == "step":
            continue
        tol = 5e-2 if slot == "mu" else 1e-1
        for key in ("embed", "ln_f"):
            want_v, got_v = sw["opt"][slot][key], sg["opt"][slot][key].cpu()
            if want_v.abs().max() > 0:
                assert (got_v - want_v).abs().max() <= tol * want_v.abs().max(), (slot, key)
        for key, want_v in sw["opt"][slot]["layers"].items():
            got_v = sg["opt"][slot]["layers"][key].cpu()
            if want_v.abs().max() > 0:
                assert (got_v - want_v).abs().max() <= tol * want_v.abs().max(), (slot, key)


# ------------------------------------------------------------------- GNN
GNN_CASES = {"gat-cora": "full", "gin-tu": "full", "graphcast": "full", "meshgraphnet": "full",
             "gin-tu-molecule": "molecule", "gat-cora-minibatch": "minibatch"}


def _gnn_case(case):
    """(reduced cfg, flat batch, shape kind) of tests/test_dist_gnn2d.py's cases."""
    import dataclasses

    from repro_torch.data import (
        NeighborSampler,
        block_budget,
        full_graph_batch,
        minibatch_batch,
        molecule_batch,
    )

    kind = GNN_CASES[case]
    name = case.rsplit("-", 1)[0] if kind != "full" else case
    cfg = dataclasses.replace(get_arch(name).arch, n_layers=2, d_hidden=8, n_vars=5)
    if kind == "molecule":
        return cfg, molecule_batch(cfg, n_graphs=6, nodes_per=8, edges_per=16, n_nodes_pad=64,
                                   n_edges_pad=128, d_feat=10, d_out=2, n_classes=2,
                                   seed=2), "batched_graphs", 2, 6
    if kind == "minibatch":
        g = pg.gnp_graph(120, 0.08, seed=5)
        feats = np.random.default_rng(0).standard_normal((120, 12)).astype(np.float32)
        n_blk, e_blk = block_budget(8, (4, 3))
        return cfg, minibatch_batch(cfg, g, feats, NeighborSampler(g, (4, 3), seed=1),
                                    np.arange(8), n_blk + 8, e_blk + 8,
                                    n_classes=5), "minibatch", 5, 0
    d_out = 5 if cfg.kind == "graphcast" else (3 if cfg.kind == "meshgraphnet" else 7)
    return cfg, full_graph_batch(cfg, pg.gnp_graph(40, 0.15, seed=3), 48, 256, 12, d_out,
                                 n_classes=7, seed=1), "full_graph", d_out, 0


def _gnn_loss_grads(loss_of, params):
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.detach().cpu() for k, g in zip(params, grads)}


def _gnn_close(got, want, loss_rtol, rtol, atol):
    assert abs(got[0] - want[0]) <= loss_rtol * abs(want[0]), (got[0], want[0])
    for key, w in want[1].items():
        torch.testing.assert_close(got[1][key], w, rtol=rtol, atol=atol, msg=key)


@pytest.mark.parametrize("case", sorted(GNN_CASES))
def test_reduced_gnn_on_the_card_matches_the_cpu(nccl_1x1, case):
    """The flat path on the card and the 2-D path on the 1x1 NCCL grid
    (f32 payloads), from the CPU's parameters and batch, against the CPU's
    flat loss and gradients."""
    from repro_torch.data import to_2d_batch
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.models.gnn2d import gnn2d_local_batch, make_gnn2d_loss_fn

    dev = torch.device("cuda")
    cfg, batch, kind, d_out, n_graphs = _gnn_case(case)
    d_feat = batch["node_feat"].shape[1]
    params = gnn_mod.init_params(cfg, d_feat, d_out, torch.Generator().manual_seed(0))
    card = {k: v.detach().to(dev).requires_grad_(True) for k, v in params.items()}
    flat = {k: torch.from_numpy(v) for k, v in batch.items()}
    flat_card = {k: v.to(dev) for k, v in flat.items()}
    want = _gnn_loss_grads(lambda p: gnn_mod.gnn_loss(cfg, p, flat, kind)[0], params)
    got = _gnn_loss_grads(lambda p: gnn_mod.gnn_loss(cfg, p, flat_card, kind)[0], card)
    _gnn_close(got, want, 1e-5, 1e-4, 1e-6)
    n = batch["node_feat"].shape[0]
    b2d = to_2d_batch(batch, n, 1, 1)
    loss_fn = make_gnn2d_loss_fn(cfg, nccl_1x1, kind, chunk=n, max_arcs=b2d["src_local"].shape[2],
                                 n_graphs=n_graphs)
    local = gnn2d_local_batch(b2d, nccl_1x1, dev)
    _gnn_close(_gnn_loss_grads(lambda p: loss_fn(p, local), card), want, 1e-4, 1e-3, 1e-5)


def test_gin_train_cell_at_published_width_on_the_card(nccl_1x1):
    """gin-tu (5 x 64) on full_graph_sm through build_gnn_cell on the 1x1
    NCCL grid: the first step's loss within 1e-2 of the CPU's flat loss
    of the same parameters and graph, three steps' losses finite and
    falling, and no kernel of ours launched."""
    from repro_torch.launch.steps import build_gnn_cell, gnn_cell_batch
    from repro_torch.models import gnn as gnn_mod

    bundle = get_arch("gin-tu")
    shape = bundle.shapes["full_graph_sm"]
    launches = dict(ops.LAUNCHES)
    cell = build_gnn_cell(bundle, shape.name, nccl_1x1, seed=0)
    assert cell.batch["node_feat"].is_cuda and cell.batch["src_local"].dtype == torch.int32
    params = {k: v.detach().cpu() for k, v in cell.params.items()}
    flat = gnn_cell_batch(bundle.arch, shape, seed=0)
    with torch.no_grad():
        want = gnn_mod.gnn_loss(bundle.arch, params, {k: torch.from_numpy(v)
                                                      for k, v in flat.items()},
                                "full_graph")[0].item()
    losses = [cell.fn()["loss"].item() for _ in range(3)]
    assert abs(losses[0] - want) <= 1e-2 * abs(want), (losses[0], want)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert dict(ops.LAUNCHES) == launches
