"""The port's level kernels: K1 frontier_spmm and K2 dependency_spmm on a
square adjacency, K3 frontier_spmm_partial and K4 dependency_spmm_partial
on a rectangular 2-D block.

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's Pallas kernels in interpret mode on the same
numpy inputs, over the shapes of tests/test_kernels.py and both
adjacency types.  Tolerances are the JAX kernel tests' own: σ rtol 1e-6
and depth exact (integer path counts are exact in f32 either way); δ
rtol 1e-5 / atol 1e-6 (g is fractional, and the two products sum in
different orders).  K3's partial is an integer-valued sum and is held
exactly; K4's at rtol 1e-6.  The CUDA kernels themselves are tested on
the card by tests/test_torch_gpu.py.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import gnp_graph
from repro.kernels import ops as jops
from repro_torch.core import engine
from repro_torch.core.operators import DenseOperator
from repro_torch.core.scheduler import COLUMN_TILE
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.dependency_spmm import (
    COLUMN_TILES,
    column_tile,
    fast_copies,
    operand_stride,
)
from repro_torch.kernels.level_gemm import operand_layout

SHAPES = [(8, 4), (16, 16), (64, 8), (128, 128), (130, 33), (256, 64)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bc_state(n, s, seed, lvl):
    """A plausible mid-traversal BC state (as in tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    g = gnp_graph(n, min(0.3, 8.0 / n), seed=seed)
    A = g.dense_adjacency(np.float32)
    sigma = rng.integers(0, 5, size=(n, s)).astype(np.float32)
    depth = rng.integers(-1, lvl + 3, size=(n, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(sigma, 1.0), 0.0).astype(np.float32)
    delta = (rng.random((n, s)).astype(np.float32) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=n).astype(np.float32)
    return A, sigma, depth, delta, omega


def _torch(A, dt, *arrays, device="cpu"):
    return (torch.from_numpy(A).to(device=device, dtype=dt),) + tuple(
        torch.from_numpy(x).to(device) for x in arrays
    )


@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_frontier_spmm_matches_jax_kernel(n, s, dtype):
    lvl = 2
    A, sigma, depth, _, _ = _bc_state(n, s, seed=n + s, lvl=lvl)
    tdt, jdt = DTYPES[dtype]
    want_s, want_d = jops.frontier_spmm(
        jnp.asarray(A, jdt), jnp.asarray(sigma), jnp.asarray(depth), lvl, interpret=True
    )
    At, st, dt_ = _torch(A, tdt, sigma, depth)
    got_s, got_d = ops.frontier_spmm(At, st, dt_, lvl)
    assert got_s.dtype == torch.float32 and got_d.dtype == torch.int32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("n,s", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dependency_spmm_matches_jax_kernel(n, s, dtype):
    lvl = 1
    A, sigma, depth, delta, omega = _bc_state(n, s, seed=2 * n + s, lvl=lvl)
    tdt, jdt = DTYPES[dtype]
    want = jops.dependency_spmm(
        jnp.asarray(A, jdt), jnp.asarray(sigma), jnp.asarray(depth),
        jnp.asarray(delta), jnp.asarray(omega), lvl, interpret=True,
    )
    got = ops.dependency_spmm(*_torch(A, tdt, sigma, depth, delta, omega), lvl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,s", SHAPES)
def test_dependency_operand_matches_the_jax_kernel_formula(n, s):
    """The operand pass's plain version (K2/K4 write g once a launch) is
    the JAX kernel's g (src/repro/kernels/dependency_spmm.py:58-63)
    evaluated in numpy float32, bit for bit: the same IEEE operations in
    the same order.  The state holds σ ≤ 0 entries at d == lvl+1 (σ̂ = 1)
    and d != lvl+1 entries (g = 0)."""
    lvl = 1
    _, sigma, depth, delta, omega = _bc_state(n, s, seed=2 * n + s, lvl=lvl)
    rng = np.random.default_rng(n + s)
    hit = rng.random((n, s)) < 0.25
    sigma = np.where(hit, -rng.integers(0, 2, size=(n, s)), sigma).astype(np.float32)
    depth = np.where(hit, lvl + 1, depth).astype(np.int32)
    safe = np.where(sigma > 0, sigma, np.float32(1.0))
    want = np.where(depth == lvl + 1, (1.0 + delta + omega[:, None]) / safe, np.float32(0.0))
    assert want.dtype == np.float32
    assert (depth == lvl + 1).any() and (depth != lvl + 1).any()
    assert ((sigma <= 0) & (depth == lvl + 1)).any()
    got = ref._dependency_operand(*_torch(sigma, torch.float32, depth, delta, omega)[:4], lvl)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,s", SHAPES)
def test_frontier_operand_matches_the_jax_kernel_formula(n, s):
    """The operand pass's plain version (K1/K3 write the masked frontier
    once a launch, [k, ld] with zero pad columns) is the JAX kernel's
    frontier (src/repro/kernels/frontier_spmm.py:60) bit for bit, in its
    first s columns; the pad columns past s hold +0.  The kernel selects
    where the JAX kernel multiplies by the mask: the two agree bitwise
    because σ ≥ 0 in a BC state."""
    lvl = 2
    _, sigma, depth, _, _ = _bc_state(n, s, seed=n + s, lvl=lvl)
    want = np.asarray(jnp.asarray(sigma) * (jnp.asarray(depth) == lvl - 1).astype(jnp.float32))
    assert (depth == lvl - 1).any() and (depth != lvl - 1).any()
    ld = operand_stride(s)
    got = ref._frontier_operand(*_torch(sigma, torch.float32, depth)[:2], lvl, ld).numpy()
    assert got.shape == (n, ld) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :s].view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got[:, s:].view(np.int32), 0)


@pytest.mark.parametrize("s", [64, 128])
def test_forward_widths_run_one_column_tile(s):
    """K1/K3's launch layout at the forward widths: one column tile of the
    batch's own width, an operand scratch of [k, s] (no pad column), and
    the 16-byte copies for an aligned f32 A."""
    A, sigma, _, _, _ = _bc_state(96, s, seed=s, lvl=2)
    At, st = _torch(A, torch.float32, sigma)
    operand, ld, bs, fast = operand_layout(At, st)
    assert column_tile(s) == bs == ld == s
    assert operand.shape == (96, s) and operand.dtype == torch.float32
    assert fast == 1


@pytest.mark.parametrize("s", [1, 4, 33, 64, 100, 128, 130, 192, 200, 256, 257, 384])
def test_column_tile_leaves_the_fewest_dead_columns(s):
    """K2/K4's column tile: no tile gives fewer padded columns, ties go to
    the wider tile, and the main path's widths (128 forward, 192 backward
    under h0/h1/h1t) run with no dead column."""
    bs = column_tile(s)
    padded = {t: -(-s // t) * t for t in COLUMN_TILES}
    assert bs in COLUMN_TILES
    assert padded[bs] == min(padded.values())
    assert bs == max(t for t in COLUMN_TILES if padded[t] == padded[bs])
    if s in (64, 128, 192):
        assert bs == s and padded[bs] == s


def test_column_tiles_match_kernel_source():
    """The wrapper picks only column tiles the main loop instantiates."""
    src = (Path(_build.CSRC) / "level_gemm.cuh").read_text()
    cases = re.findall(r"case (\d+):\s*return fast", src)
    assert tuple(int(t) for t in cases) == COLUMN_TILES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operand_stride_and_copy_path(dtype):
    """The operand scratch's rows are 16-byte aligned; A takes the 16-byte
    copies only with 16-byte aligned rows and base (a view at an offset,
    or kdim·size not a multiple of 16, takes the element-wise loads)."""
    assert [operand_stride(s) for s in (1, 4, 5, 128, 130, 192, 257)] == [
        4, 4, 8, 128, 132, 192, 260]
    per_chunk = 16 // torch.empty((), dtype=dtype).element_size()
    for kdim in (33, 130, 260, 4096):
        A = torch.zeros(kdim + 1, kdim, dtype=dtype)
        assert fast_copies(A[:kdim]) == (kdim % per_chunk == 0)
        assert not fast_copies(A.view(-1)[1:1 + kdim * kdim].view(kdim, kdim))


def test_frontier_spmm_full_level_sequence():
    """Kernel levels chained end-to-end reproduce the engine's forward."""
    g = gnp_graph(48, 0.12, seed=11)
    A = torch.from_numpy(g.dense_adjacency(np.float32))
    n, s = 48, 8
    onehot = (torch.arange(n)[:, None] == torch.arange(s)[None, :]).to(torch.float32)
    want = engine.forward_counting(DenseOperator(A), onehot)
    sigma, depth = onehot, torch.where(onehot > 0, 0, -1).to(torch.int32)
    for lvl in range(1, 20):
        sigma, depth = ops.frontier_spmm(A, sigma, depth, lvl)
    np.testing.assert_allclose(sigma.numpy(), want.sigma.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(depth.numpy(), want.depth.numpy())
    bare = engine.forward_counting(lambda x: A @ x, onehot)  # a bare A @ x closure
    assert torch.equal(bare.sigma, want.sigma) and bare.max_depth == want.max_depth


# (m, k, s): ragged rectangular blocks — m != k, neither a multiple of 128,
# s not a multiple of 128 — plus the square case and a 2x4-grid-like block
PARTIAL_SHAPES = [(8, 16, 4), (130, 70, 33), (40, 200, 24), (257, 129, 130), (64, 64, 8)]


def _partial_state(m, k, s, seed, lvl):
    """A [m, k] block of a gnp adjacency and a [k, s] gathered state."""
    A, sigma, depth, delta, omega = _bc_state(max(m, k), s, seed=seed, lvl=lvl)
    acc = np.random.default_rng(seed + 1).integers(0, 7, size=(m, s)).astype(np.float32)
    return (np.ascontiguousarray(A[:m, :k]), sigma[:k], depth[:k], delta[:k], omega[:k], acc)


@pytest.mark.parametrize("m,k,s", PARTIAL_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_acc", [False, True], ids=["plain", "acc"])
def test_frontier_partial_matches_jax_kernel(m, k, s, dtype, with_acc):
    lvl = 2
    A, sigma, depth, _, _, acc = _partial_state(m, k, s, seed=m + k + s, lvl=lvl)
    tdt, jdt = DTYPES[dtype]
    want = jops.frontier_spmm_partial(
        jnp.asarray(A, jdt), jnp.asarray(sigma), jnp.asarray(depth), lvl,
        acc=jnp.asarray(acc) if with_acc else None, interpret=True,
    )
    At, st, dt_, acc_t = _torch(A, tdt, sigma, depth, acc)
    got = ops.frontier_spmm_partial(At, st, dt_, lvl, acc=acc_t if with_acc else None)
    assert got.dtype == torch.float32 and got.shape == (m, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,s", PARTIAL_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_acc", [False, True], ids=["plain", "acc"])
def test_dependency_partial_matches_jax_kernel(m, k, s, dtype, with_acc):
    lvl = 1
    A, sigma, depth, delta, omega, acc = _partial_state(m, k, s, seed=2 * m + k + s, lvl=lvl)
    tdt, jdt = DTYPES[dtype]
    want = jops.dependency_spmm_partial(
        jnp.asarray(A, jdt), jnp.asarray(sigma), jnp.asarray(depth), jnp.asarray(delta),
        jnp.asarray(omega), lvl, acc=jnp.asarray(acc) if with_acc else None, interpret=True,
    )
    At, st, dt_, dl, om, acc_t = _torch(A, tdt, sigma, depth, delta, omega, acc)
    got = ops.dependency_spmm_partial(At, st, dt_, dl, om, lvl, acc=acc_t if with_acc else None)
    assert got.dtype == torch.float32 and got.shape == (m, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_partials_fold_to_the_fused_level():
    """Column blocks' K3/K4 partials summed, then the epilogue, give K1/K2:
    the 2-D fold reassembles the single-device level."""
    A, sigma, depth, delta, omega = _bc_state(96, 12, seed=5, lvl=2)
    At, st, dt_, dl, om = _torch(A, torch.float32, sigma, depth, delta, omega)
    cols = [slice(0, 40), slice(40, 96)]
    t = sum(ops.frontier_spmm_partial(At[:, c].contiguous(), st[c], dt_[c], 2) for c in cols)
    newly = (t > 0) & (dt_ < 0)
    want_s, want_d = ops.frontier_spmm(At, st, dt_, 2)
    assert torch.equal(torch.where(newly, 2, dt_), want_d)
    assert torch.equal(st + torch.where(newly, t, 0.0), want_s)
    t = None
    for c in cols:  # the ring schedule's running combine (acc mode)
        t = ops.dependency_spmm_partial(At[:, c].contiguous(), st[c], dt_[c], dl[c], om[c], 1,
                                        acc=t)
    torch.testing.assert_close(dl + torch.where(dt_ == 1, st * t, 0.0),
                               ops.dependency_spmm(At, st, dt_, dl, om, 1), rtol=1e-6, atol=1e-6)


def _bad_partial_operands():
    m, k, s = 6, 8, 4
    A = torch.zeros(m, k)
    sg = torch.zeros(k, s)
    dp = torch.zeros(k, s, dtype=torch.int32)
    dl = torch.zeros(k, s)
    om = torch.zeros(k)
    acc = torch.zeros(m, s)
    return {
        "A_int": ((A.to(torch.int32), sg, dp), (A.to(torch.int32), sg, dp, dl, om)),
        "A_3d": ((A[None], sg, dp), (A[None], sg, dp, dl, om)),
        "k_mismatch": ((A, sg[:7], dp[:7]), (A, sg[:7], dp[:7], dl[:7], om[:7])),
        "omega_rows": ((A, sg, dp.long()), (A, sg, dp, dl, om[:m])),
        "acc_shape": ((A, sg, dp, 1, acc[:5]), (A, sg, dp, dl, om, 1, acc[:, :3])),
        "acc_f64": ((A, sg, dp, 1, acc.double()), (A, sg, dp, dl, om, 1, acc.double())),
        "acc_strided": ((A, sg, dp, 1, torch.zeros(s, m).t()),
                        (A, sg, dp, dl, om, 1, torch.zeros(s, m).t())),
    }


@pytest.mark.parametrize("case", sorted(_bad_partial_operands()))
def test_partial_wrappers_reject_bad_operands(case):
    fwd_args, bwd_args = _bad_partial_operands()[case]
    with pytest.raises((TypeError, ValueError)):
        ops.frontier_spmm_partial(*fwd_args, *(() if len(fwd_args) > 3 else (1,)))
    with pytest.raises((TypeError, ValueError)):
        ops.dependency_spmm_partial(*bwd_args, *(() if len(bwd_args) > 5 else (1,)))


def _bad_operands():
    n, s = 8, 4
    A = torch.zeros(n, n)
    sg = torch.zeros(n, s)
    dp = torch.zeros(n, s, dtype=torch.int32)
    dl = torch.zeros(n, s)
    om = torch.zeros(n)
    return {
        "A_int": ((A.to(torch.int32), sg, dp), (A.to(torch.int32), sg, dp, dl, om)),
        "A_f16": ((A.half(), sg, dp), (A.half(), sg, dp, dl, om)),
        "A_rect": ((A[:, :6].contiguous(), sg, dp), (A[:, :6].contiguous(), sg, dp, dl, om)),
        "sigma_f64": ((A, sg.double(), dp), (A, sg.double(), dp, dl, om)),
        "depth_i64": ((A, sg, dp.long()), (A, sg, dp.long(), dl, om)),
        "rows": ((A, sg[:7], dp[:7]), (A, sg[:7], dp[:7], dl[:7], om)),
        "cols": ((A, sg, dp[:, :3].contiguous()), (A, sg, dp, dl[:, :3].contiguous(), om)),
        "strided": ((A.t(), sg, dp), (A, sg, dp, torch.zeros(s, n).t(), om)),
        "omega_shape": ((A, sg, dp[:, :2].contiguous()), (A, sg, dp, dl, om[:5])),
        "meta_device": (
            (A.to("meta"), sg.to("meta"), dp.to("meta")),
            (A.to("meta"), sg.to("meta"), dp.to("meta"), dl.to("meta"), om.to("meta")),
        ),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_wrappers_reject_bad_operands(case):
    fwd_args, bwd_args = _bad_operands()[case]
    with pytest.raises((TypeError, ValueError)):
        ops.frontier_spmm(*fwd_args, 1)
    with pytest.raises((TypeError, ValueError)):
        ops.dependency_spmm(*bwd_args, 1)


def test_cpu_wrappers_count_no_launches():
    A, sigma, depth, delta, omega = _bc_state(16, 4, seed=3, lvl=1)
    before = dict(ops.LAUNCHES)
    ops.frontier_spmm(*_torch(A, torch.float32, sigma, depth), 1)
    ops.dependency_spmm(*_torch(A, torch.float32, sigma, depth, delta, omega), 1)
    ops.frontier_spmm_partial(*_torch(A, torch.float32, sigma, depth), 1)
    ops.dependency_spmm_partial(*_torch(A, torch.float32, sigma, depth, delta, omega), 1)
    assert ops.LAUNCHES == before


def test_plain_versions_are_the_wrappers_cpu_path():
    A, sigma, depth, delta, omega = _bc_state(24, 5, seed=4, lvl=2)
    args = _torch(A, torch.bfloat16, sigma, depth)
    for got, want in zip(ops.frontier_spmm(*args, 2), ref.frontier_spmm_ref(*args, 2)):
        assert torch.equal(got, want)
    args = _torch(A, torch.bfloat16, sigma, depth, delta, omega)
    assert torch.equal(ops.dependency_spmm(*args, 2), ref.dependency_spmm_ref(*args, 2))
    blk = (args[0][:10].contiguous(),) + args[1:]
    acc = torch.ones(10, 5)
    assert torch.equal(ops.frontier_spmm_partial(*blk[:3], 2, acc=acc),
                       ref.frontier_partial_ref(*blk[:3], 2, acc))
    assert torch.equal(ops.dependency_spmm_partial(*blk, 2, acc=acc),
                       ref.dependency_partial_ref(*blk, 2, acc))


def test_column_tile_matches_kernel_source():
    """The scheduler's padding hint uses the kernels' real padding: the
    smallest column tile the main loop instantiates."""
    src = (Path(_build.CSRC) / "level_gemm.cuh").read_text()
    cases = [int(t) for t in re.findall(r"case (\d+):\s*return fast", src)]
    assert min(cases) == COLUMN_TILE


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """A finished build is reused without nvcc; a changed source misses."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    lib = tmp_path / _build._source_hash() / _build.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    assert _build.build() == lib
    monkeypatch.setattr(_build, "COMPILE_FLAGS", _build.COMPILE_FLAGS + ["-lineinfo"])
    assert _build._source_hash() != lib.parent.name
