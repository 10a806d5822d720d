"""The port's fused level kernels (K1 frontier_spmm, K2 dependency_spmm).

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's Pallas kernels in interpret mode on the same
numpy inputs, over the shapes of tests/test_kernels.py and both
adjacency types.  Tolerances are the JAX kernel tests' own: σ rtol 1e-6
and depth exact (integer path counts are exact in f32 either way); δ
rtol 1e-5 / atol 1e-6 (g is fractional, and the two products sum in
different orders).  The CUDA kernels themselves are tested on
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
    assert ops.LAUNCHES == before


def test_plain_versions_are_the_wrappers_cpu_path():
    A, sigma, depth, delta, omega = _bc_state(24, 5, seed=4, lvl=2)
    args = _torch(A, torch.bfloat16, sigma, depth)
    for got, want in zip(ops.frontier_spmm(*args, 2), ref.frontier_spmm_ref(*args, 2)):
        assert torch.equal(got, want)
    args = _torch(A, torch.bfloat16, sigma, depth, delta, omega)
    assert torch.equal(ops.dependency_spmm(*args, 2), ref.dependency_spmm_ref(*args, 2))


def test_column_tile_matches_kernel_source():
    """The scheduler's padding hint uses the kernels' real column tile."""
    src = (Path(_build.CSRC) / "level_tile.cuh").read_text()
    bs = int(re.search(r"constexpr int BS = (\d+);", src).group(1))
    assert bs == COLUMN_TILE


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
