"""The port's CUDA kernels and fused engines on the card.

Every test here is marked ``gpu`` and skips itself without a CUDA card.
The file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: depth exact, σ rtol 1e-6 (exact integer path counts), δ rtol
1e-5 / atol 1e-6 (fractional g summed in another order than the plain
version's matmul), BC rtol 1e-5 / atol 1e-5 against the numpy oracle or
the single-device dense engine.  K3's and K5's partials are integer-valued
sums and are held exactly.
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
from repro_torch.distributed import GridGroups
from repro_torch.kernels import ops, ref

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
    A, sigma, depth, delta, omega = _state(64, 8, 1, 2, torch.float32, cuda)
    tiles, rows, cols = _tile_list(5, 4, 8, 16, 0, cuda)
    ops.reset_launches()
    ops.frontier_spmm(A, sigma, depth, 2)
    ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
    ops.frontier_spmm_partial(A[:40].contiguous(), sigma, depth, 2)
    ops.dependency_spmm_partial(A[:40].contiguous(), sigma, depth, delta, omega, 1)
    ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=40)
    ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=40)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"frontier_spmm": 1, "dependency_spmm": 1,
                            "frontier_spmm_partial": 1, "dependency_spmm_partial": 1,
                            "frontier_spmm_sparse": 1, "dependency_spmm_sparse": 1}


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
        for t_in in (None, acc):
            got = ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in)
            want = ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m, t_in)
            assert torch.equal(got, want), (num_tr, num_tc, bm, bk, s)
            torch.testing.assert_close(
                ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1,
                                           m=m, acc=t_in),
                ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m,
                                          t_in),
                rtol=1e-5, atol=1e-6,
            )


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
