#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``.  It exits non-zero without a card, outside a
checkout of this repository, or when any phase fails; nothing is caught.

Phases (run in the order 1–5, 8, 6, 7: phase 8 shares phase 5's NCCL
process group, and phase 7's kernel table carries phase 8's launches):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build K1–K6 from kernels/csrc with nvcc, one process per source
     (ptxas report, build seconds);
  3. kernel parity on the card against the plain PyTorch versions, f32 and
     bf16 adjacency: K1/K2 at the unit-test shapes and the main-path
     shapes (depth exact, σ rtol 1e-6, δ rtol 1e-5 / atol 1e-6); K3/K4 in
     plain and acc mode at ragged rectangular shapes, at the 1×1 grid's
     [65536, 65536] block and at the [32768, 16384] block of a 2×4 grid
     (K3's integer-valued partial exact, K4 rtol 1e-5 / atol 1e-6); K5/K6
     in plain and acc mode on random tile lists (bm, bk in {5, 8, 32,
     128}, bm != bk, ragged s, fillers, empty tile-rows, trailing pad
     tiles) and on the real 1×1 cell layouts of phase 8 (R-MAT scale 16 at
     tiles 128 and 32, the strip graph at tile 128): K5 exact, K6 rtol
     1e-5 / atol 1e-6;
  4. the main path at full width through ``betweenness_centrality``:
     rmat_graph(16, 16, seed=1) (n = 65536, the paper's edge factor),
     batch 128, h0, sampling="fixed" with 512 roots (4 rounds), on the
     fused_bf16, fused and dense engines; the fused runs must launch
     K1 and K2 and match dense to rtol 1e-5 / atol 1e-5; then one more
     fused_bf16 run under torch.profiler for device time per kernel;
  5. the 2-D decomposed path at full width through
     ``distributed_betweenness_centrality`` on a 1×1 grid (one NCCL rank:
     one card holds no larger grid), same graph and roots, engines
     fused_bf16, fused and sparse; the fused runs must launch K3 and K4
     and not K1/K2, and every run must match the single-device dense BC
     to rtol 1e-5 / atol 1e-5; then the fused run once under
     torch.profiler (device busy share, K3/K4/NCCL shares);
  6. exact BC against the port's numpy oracle (rmat 10, road 20x20; h0
     and h3t; rtol 1e-5 / atol 1e-5) and h3 on rmat 13 against dense;
  7. kernel times with CUDA events at the main-path shapes (K3/K4 also at
     the 2×4 block, K5/K6 at phase 8's three layouts), beside the plain
     versions, one library call as the yardstick (torch.matmul for
     K1–K4, torch.sparse.mm of the cell as a CSR tensor for K5/K6), and
     the bound (larger of bytes / 3.35 TB/s and FLOP / 67 TFLOP/s f32);
  8. the BCSR path at full width through
     ``distributed_betweenness_centrality`` on the 1×1 NCCL grid:
     (a) phase 4's graph and roots on fused_sparse at the default tile
     (128) and at 32×32, and on fused_hybrid at threshold 1.0 (the bytes
     model picks BCSR for this cell), each matching the single-device
     dense BC (rtol 1e-5 / atol 1e-5); (b) 86 disjoint 3×1024 lattices
     (n = 264 192, a long-diameter road-like graph whose 260 GiB dense
     block no card holds): the memory guard must refuse ``fused`` before
     allocating, then fused_sparse, h0, one round of 128 fixed roots,
     matching the arc-list engine (rtol 1e-5 / atol 1e-5); every
     run launches K5 and K6 and none of K1–K4; then (b) once under
     torch.profiler (busy share, K5/K6/NCCL shares).
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense, no tensor cores for f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

MAIN_N_SCALE, MAIN_EF = 16, 16
MAIN_BATCH, MAIN_SAMPLE_K = 128, 512
TEST_SHAPES = [(8, 4), (16, 16), (64, 8), (128, 128), (130, 33), (256, 64)]
# (m, k, s) ragged rectangular blocks for K3/K4: m != k, neither a
# multiple of 128, s not a multiple of 128
PARTIAL_SHAPES = [(8, 16, 4), (130, 70, 33), (300, 1000, 192), (1000, 260, 128), (257, 129, 130)]
BLOCK_GRID = (2, 4)  # K3/K4 are also checked and timed at this grid's per-device block
# (tile-rows, tile-cols, bm, bk, s) random BCSR lists for K5/K6: bm != bk,
# each of the kernel's row blocks (32, 64, 128), ragged s
SPARSE_SHAPES = [(6, 5, 5, 8, 33), (4, 7, 8, 5, 130), (40, 30, 32, 128, 128),
                 (20, 50, 128, 32, 192), (12, 9, 128, 8, 257)]
# phase 8 (b): 86 disjoint 3 x 1024 lattices (n = 264 192, ~10^3 levels),
# one round of 128 roots.  Not one 512 x 512 lattice: its path counts reach
# C(1022, 511) ~ 1e306 and overflow f32 σ (BC turns non-finite in the port
# and the JAX package alike); a 3-row strip keeps every count <= C(1025, 2)
# < 2^24, exact in f32.
STRIPS, STRIP_SHAPE, STRIP_SAMPLE_K = 86, (3, 1024), 128
SPARSE_TILE = 32  # phase 8 (a) also runs fused_sparse at this square tile


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> tuple[bool, float]:
    """(all |got - want| <= atol + rtol·|want|, max abs error)."""
    diff = (got.double() - want.double()).abs()
    ok = bool((diff <= atol + rtol * want.double().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gpu_clocks() -> str:
    """SM clock, power draw and temperature now (beside a timing window)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def trace_run(tag: str, run, shares: dict[str, str] | None = None) -> None:
    """``run()`` once more under torch.profiler: device time per kernel and
    the device's busy share of the traced wall time (the untraced runs give
    the end-to-end numbers).  ``shares`` maps a label to a substring (or a
    tuple of substrings, all required) of kernel names whose summed share
    of device time is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device activities only, as the profiler's own table sums them: a host
    # op (aten::copy_) and a user annotation on the device timeline
    # (nccl:_all_gather_base) repeat the device time of what they enclose.
    # The annotations still give the collectives' share.
    events = [(ev.key, ev.count, ev.self_device_time_total,
               getattr(ev, "is_user_annotation", False)) for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows = [r[:3] for r in events if not r[3]]
    busy_us = sum(r[2] for r in rows)
    check(busy_us > 0, f"the traced {tag} run recorded no device time")
    print(f"{tag} traced: wall {wall_us / 1e6:.3f}s, device busy "
          f"{busy_us / 1e6:.3f}s ({100 * busy_us / wall_us:.1f}%), idle "
          f"{100 * (1 - busy_us / wall_us):.1f}%")
    for label, needle in (shares or {}).items():
        needles = (needle,) if isinstance(needle, str) else needle  # all must match
        mine = [r for r in events if all(x in r[0] for x in needles)]
        us = sum(r[2] for r in mine)
        n = sum(r[1] for r in mine)
        print(f"{tag}   share {label}: {us / 1e3:.3f} ms, {100 * us / busy_us:.1f}% of "
              f"device time, x{n}")
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"{tag}   {us / 1e3:10.3f} ms {100 * us / busy_us:5.1f}%  x{count:<4d} {key[:90]}")


def partial_bytes(A, sigma, depth, delta=None, omega=None, acc=None) -> int:
    """Bytes a K3/K4 call must move: each input read once, t written once."""
    ins = [A, sigma, depth] + [x for x in (delta, omega, acc) if x is not None]
    return sum(x.nbytes for x in ins) + A.shape[0] * sigma.shape[1] * 4


def tile_list(num_tr: int, num_tc: int, bm: int, bk: int, seed: int, dev, complete: bool,
              pad: int = 3):
    """A row-sorted random BCSR list: 0–3 distinct tiles per tile-row, an
    all-zero filler in an empty row when ``complete`` (else the row stays
    empty), and ``pad`` zero tiles trailing on the last row."""
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
    return tuple(torch.from_numpy(x).to(dev) for x in
                 (np.stack(data), np.array(rows, np.int32), np.array(cols, np.int32)))


def sparse_bytes(tiles, rows, cols, row_ptr, sigma, depth, delta=None, omega=None) -> int:
    """Bytes a K5/K6 call must move: each input read once, t written once."""
    ins = [tiles, rows, cols, row_ptr, sigma, depth] + [x for x in (delta, omega) if x is not None]
    m = (row_ptr.numel() - 1) * tiles.shape[1]
    return sum(x.nbytes for x in ins) + m * sigma.shape[1] * 4


def level_state(n: int, s: int, seed: int, lvl: int, dev):
    """A plausible mid-traversal state (as tests/test_kernels.py builds it)."""
    rng = np.random.default_rng(seed)
    sigma = rng.integers(0, 5, size=(n, s)).astype(np.float32)
    depth = rng.integers(-1, lvl + 3, size=(n, s)).astype(np.int32)
    sigma = np.where(depth >= 0, np.maximum(sigma, 1.0), 0.0).astype(np.float32)
    delta = (rng.random((n, s)).astype(np.float32) * (depth >= 0)).astype(np.float32)
    omega = rng.integers(0, 3, size=n).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (sigma, depth, delta, omega))


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no repro_torch package under {SRC}: run from a checkout of the repository")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist

    from repro_torch.core.bc import device_adjacency, betweenness_centrality
    from repro_torch.core.brandes_ref import brandes_reference
    from repro_torch.core.distributed import (
        check_device_memory,
        distributed_betweenness_centrality,
    )
    from repro_torch.device import resolve_device
    from repro_torch.distributed import GridGroups
    from repro_torch.graphs import (
        disjoint_union,
        gnp_graph,
        grid_graph,
        partition_2d,
        rmat_graph,
        road_like_graph,
    )
    from repro_torch.kernels import _build, ops, ref

    t_all = time.perf_counter()
    dev = resolve_device("cuda")  # also switches TF32 off for matmul and cuDNN

    # ------------------------------------------------------ 1. environment
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"[1] device {kind}, count {torch.cuda.device_count()}, "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ------------------------------------------------------------ 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"[2] built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f}s")
    print(_build.build_log())
    _build.library()

    # --------------------------------------------------- 3. kernel parity
    t3 = time.perf_counter()
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for n, s in TEST_SHAPES:
        A32 = torch.from_numpy(
            gnp_graph(n, min(0.3, 8.0 / n), seed=n + s).dense_adjacency(np.float32)
        ).to(dev)
        sigma, depth, delta, omega = level_state(n, s, n + s, 2, dev)
        for tag, dt in dtypes.items():
            A = A32.to(dt)
            sg, dp = ops.frontier_spmm(A, sigma, depth, 2)
            sg_r, dp_r = ref.frontier_spmm_ref(A, sigma, depth, 2)
            dl = ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
            dl_r = ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
            ok_s, err_s = close(sg, sg_r, 1e-6, 0.0)
            ok_d, err_d = close(dl, dl_r, 1e-5, 1e-6)
            ok_dp = bool(torch.equal(dp, dp_r))
            print(f"[3] n={n} s={s} A={tag}: K1 σ err {err_s:.3g} depth exact {ok_dp}; "
                  f"K2 δ err {err_d:.3g}")
            check(ok_s and ok_dp and ok_d, f"kernel parity at n={n} s={s} A={tag}")

    graph = rmat_graph(MAIN_N_SCALE, MAIN_EF, seed=1)
    n_main = graph.n
    s_fwd = MAIN_BATCH
    s_bwd = MAIN_BATCH + MAIN_BATCH // 2  # explicit + derived columns of a round
    A_main = {"f32": device_adjacency(graph, torch.float32, dev)}
    A_main["bf16"] = A_main["f32"].to(torch.bfloat16)
    states = {s: level_state(n_main, s, s, 2, dev) for s in (s_fwd, s_bwd)}
    err_main: dict[tuple[str, str], float] = {}
    for tag in dtypes:
        A = A_main[tag]
        sigma, depth, _, _ = states[s_fwd]
        sg, dp = ops.frontier_spmm(A, sigma, depth, 2)
        sg_r, dp_r = ref.frontier_spmm_ref(A, sigma, depth, 2)
        ok_s, err_main[("frontier_spmm", tag)] = close(sg, sg_r, 1e-6, 0.0)
        check(ok_s and bool(torch.equal(dp, dp_r)), f"K1 parity at n={n_main} A={tag}")
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = states[s]
            dl = ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
            dl_r = ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
            ok_d, err = close(dl, dl_r, 1e-5, 1e-6)
            check(ok_d, f"K2 parity at n={n_main} s={s} A={tag}")
            if s == s_bwd:
                err_main[("dependency_spmm", tag)] = err
        del sg, dp, sg_r, dp_r, dl, dl_r
        print(f"[3] n={n_main} A={tag}: K1 σ err {err_main[('frontier_spmm', tag)]:.3g} "
              f"(s={s_fwd}), K2 δ err {err_main[('dependency_spmm', tag)]:.3g} (s={s_bwd})")

    def partial_parity(A, sigma, depth, delta, omega, acc, where) -> tuple[float, float]:
        """K3/K4 against their plain versions in plain and acc mode; returns
        the largest K3 and K4 errors."""
        e3 = e4 = 0.0
        for t_in in (None, acc):
            mode = "plain" if t_in is None else "acc"
            ok3, err3 = close(ops.frontier_spmm_partial(A, sigma, depth, 2, acc=t_in),
                              ref.frontier_partial_ref(A, sigma, depth, 2, t_in), 0.0, 0.0)
            e3 = max(e3, err3)
            ok4, err4 = close(ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1,
                                                          acc=t_in),
                              ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1, t_in),
                              1e-5, 1e-6)
            check(ok3, f"K3 parity ({mode}) at {where}")
            check(ok4, f"K4 parity ({mode}) at {where}: err {err4:.3g}")
            e4 = max(e4, err4)
        return e3, e4

    for m, k, s in PARTIAL_SHAPES:
        A32 = torch.from_numpy(np.ascontiguousarray(
            gnp_graph(max(m, k), min(0.3, 8.0 / max(m, k)), seed=m + k + s)
            .dense_adjacency(np.float32)[:m, :k])).to(dev)
        sigma, depth, delta, omega = level_state(k, s, m + k + s, 2, dev)
        acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
        for tag, dt in dtypes.items():
            _, e4 = partial_parity(A32.to(dt), sigma, depth, delta, omega, acc,
                                   f"m={m} k={k} s={s} A={tag}")
            print(f"[3] K3/K4 m={m} k={k} s={s} A={tag}: K3 exact, K4 δ-side err {e4:.3g} "
                  f"(plain and acc)")
    # the 1×1 grid's block is the whole adjacency
    for tag in dtypes:
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = states[s]
            acc = torch.randint(0, 7, (n_main, s), device=dev).to(torch.float32)
            e3, e4 = partial_parity(A_main[tag], sigma, depth, delta, omega, acc,
                                    f"1x1 block n={n_main} s={s} A={tag}")
            err_main[("partial_1x1", tag, s)] = (e3, e4)
            del acc
        print(f"[3] K3/K4 1x1 block [{n_main}, {n_main}] A={tag}: K3 exact, K4 err "
              f"{err_main[('partial_1x1', tag, s_bwd)][1]:.3g} (s={s_bwd})")
    del A_main
    torch.cuda.empty_cache()
    # the [C·chunk, R·chunk] block of cell (0, 0) of a 2×4 grid, from the main graph
    part = partition_2d(graph, *BLOCK_GRID)
    m_blk, k_blk = part.C * part.chunk, part.R * part.chunk
    A_blk = {"f32": part.cell_dense_block(0, 0, torch.float32, dev)}
    A_blk["bf16"] = A_blk["f32"].to(torch.bfloat16)
    blk_states = {s: level_state(k_blk, s, s + 7, 2, dev) for s in (s_fwd, s_bwd)}
    for tag in dtypes:
        for s in (s_fwd, s_bwd):
            sigma, depth, delta, omega = blk_states[s]
            acc = torch.randint(0, 7, (m_blk, s), device=dev).to(torch.float32)
            err_main[("partial_blk", tag, s)] = partial_parity(
                A_blk[tag], sigma, depth, delta, omega, acc,
                f"2x4 block [{m_blk}, {k_blk}] s={s} A={tag}")
        print(f"[3] K3/K4 2x4 block [{m_blk}, {k_blk}] A={tag}: K3 exact, K4 err "
              f"{err_main[('partial_blk', tag, s_bwd)][1]:.3g} (s={s_bwd}), "
              f"{err_main[('partial_blk', tag, s_fwd)][1]:.3g} (s={s_fwd})")
    del A_blk
    torch.cuda.empty_cache()

    def sparse_parity(layout, m, st, acc, where) -> tuple[float, float]:
        """K5/K6 against their plain versions in plain and acc mode; returns
        the largest K5 and K6 errors."""
        tiles, rows, cols, row_ptr = layout
        sigma, depth, delta, omega = st
        e5 = e6 = 0.0
        for t_in in (None, acc):
            mode = "plain" if t_in is None else "acc"
            ok5, err5 = close(
                ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m, acc=t_in,
                                         row_ptr=row_ptr),
                ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m, t_in), 0.0, 0.0)
            ok6, err6 = close(
                ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta, omega, 1, m=m,
                                           acc=t_in, row_ptr=row_ptr),
                ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta, omega, 1, m,
                                          t_in), 1e-5, 1e-6)
            check(ok5, f"K5 parity ({mode}) at {where}: err {err5:.3g}")
            check(ok6, f"K6 parity ({mode}) at {where}: err {err6:.3g}")
            e5, e6 = max(e5, err5), max(e6, err6)
        return e5, e6

    for num_tr, num_tc, bm, bk, s in SPARSE_SHAPES:
        m, kdim = num_tr * bm, num_tc * bk
        st = level_state(kdim, s, kdim + s, 2, dev)
        acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
        for complete in (True, False):  # fillers, or empty tile-rows
            layout = tile_list(num_tr, num_tc, bm, bk, num_tr + s, dev, complete) + (None,)
            _, e6 = sparse_parity(layout, m, st, acc, f"{layout[0].shape[0]} tiles of {bm}x{bk}, "
                                  f"m={m} k={kdim} s={s} complete={complete}")
        print(f"[3] K5/K6 random list {num_tr}x{num_tc} tiles of {bm}x{bk}, s={s}: K5 exact, K6 "
              f"err {e6:.3g} (plain and acc; filler rows and empty rows)")
    # the 1×1 cell layouts of phase 8, built as the engine builds them
    part_1x1 = partition_2d(graph, 1, 1)
    strips = disjoint_union(*[grid_graph(*STRIP_SHAPE)] * STRIPS)
    part_strips = partition_2d(strips, 1, 1)
    strip_states = {s: level_state(strips.n, s, s + 11, 2, dev) for s in (s_fwd, s_bwd)}
    strip_tag = f"strips {STRIPS}x{STRIP_SHAPE[0]}x{STRIP_SHAPE[1]} 1x1 tile 128"
    layouts = {  # phase 8 run tag -> (graph, partition, tile, states)
        "rmat16 1x1 tile 128": (graph, part_1x1, (None, None), states),
        f"rmat16 1x1 tile {SPARSE_TILE}": (graph, part_1x1, (SPARSE_TILE, SPARSE_TILE), states),
        strip_tag: (strips, part_strips, (None, None), strip_states),
    }
    for tag, (_, part_l, tile, st_map) in layouts.items():
        layout = part_l.cell_blocked_sparse(0, 0, *tile, device=dev)
        m = part_l.C * part_l.chunk
        for s in (s_fwd, s_bwd):
            acc = torch.randint(0, 7, (m, s), device=dev).to(torch.float32)
            err_main[("sparse", tag, s)] = sparse_parity(layout, m, st_map[s], acc, f"{tag} s={s}")
            del acc
        print(f"[3] K5/K6 {tag}: {layout[0].shape[0]} stored tiles of "
              f"{layout[0].shape[1]}x{layout[0].shape[2]} ({layout[0].nbytes / 2**30:.2f} GiB), "
              f"K5 exact, K6 err {err_main[('sparse', tag, s_bwd)][1]:.3g} (s={s_bwd})")
        del layout
        torch.cuda.empty_cache()
    print(f"[3] parity ok in {time.perf_counter() - t3:.1f}s")

    # ------------------------------------------------ 4. main path, full width
    print(f"[4] graph rmat_graph({MAIN_N_SCALE}, {MAIN_EF}, seed=1): n={graph.n} "
          f"m={graph.num_edges}; batch {MAIN_BATCH}, h0, sampling fixed k={MAIN_SAMPLE_K}")
    print(f"[4] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    results, launches = {}, {}
    for engine in ("fused_bf16", "fused", "dense"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t = time.perf_counter()
        res = betweenness_centrality(
            graph, batch_size=MAIN_BATCH, heuristics="h0", engine_kind=engine,
            sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, device="cuda",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[engine] = dict(ops.LAUNCHES)
        results[engine] = res
        check(res.bc.shape == (graph.n,) and bool(np.isfinite(res.bc).all()),
              f"{engine}: BC must be finite of shape ({graph.n},)")
        check(res.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH, f"{engine}: expected 4 rounds")
        print(f"[4] {engine}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), "
              f"{res.rounds_run} rounds, levels per round {res.round_levels}, "
              f"launches {launches[engine]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"GTEPS_bc (m·n/s, as the CLI reports it) "
              f"{graph.num_edges * graph.n / wall / 1e9:.3f}, GTEPS over the "
              f"{res.roots_accumulated} roots run of {res.sampling_stats['num_eligible']} "
              f"eligible (m·k/s) {graph.num_edges * res.roots_accumulated / wall / 1e9:.4f}")
        if engine != "dense":
            check(launches[engine]["frontier_spmm"] > 0 and launches[engine]["dependency_spmm"] > 0,
                  f"{engine}: the main path did not launch K1 and K2")
        del res
        torch.cuda.empty_cache()
    for engine in ("fused_bf16", "fused"):
        ok, err = close(torch.from_numpy(results[engine].bc),
                        torch.from_numpy(results["dense"].bc), 1e-5, 1e-5)
        print(f"[4] {engine} vs dense: max abs err {err:.3g}")
        check(ok, f"{engine} BC disagrees with dense at full width")
    trace_run("[4] fused_bf16", lambda: betweenness_centrality(
        graph, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="fused_bf16",
        sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, device="cuda"))

    # ------------------------------------- 5. 2-D path, 1×1 grid, full width
    t5 = time.perf_counter()
    launches_2d = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            groups = GridGroups(1, 1, 1)
            # NCCL sets a communicator up at a group's first collective:
            # pay that once here, outside the timed runs
            t = time.perf_counter()
            warm = torch.zeros(1, device=dev)
            for g in (None, groups.column, groups.row, groups.grid, groups.replica):
                dist.all_reduce(warm, group=g)
            torch.cuda.synchronize()
            print(f"[5] NCCL communicators of the default and the four grid groups set up "
                  f"in {time.perf_counter() - t:.3f}s")

            def run_2d(engine):
                return distributed_betweenness_centrality(
                    graph, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind=engine,
                    sampling="fixed", sample_k=MAIN_SAMPLE_K, sample_seed=0, full_result=True,
                )

            for engine in ("fused_bf16", "fused", "sparse"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launches()
                t = time.perf_counter()
                res = run_2d(engine)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches_2d[engine] = dict(ops.LAUNCHES)
                check(res.bc.shape == (graph.n,) and bool(np.isfinite(res.bc).all()),
                      f"2-D {engine}: BC must be finite of shape ({graph.n},)")
                check(res.rounds_run == MAIN_SAMPLE_K // MAIN_BATCH,
                      f"2-D {engine}: expected 4 rounds")
                ok, err = close(torch.from_numpy(res.bc), torch.from_numpy(results["dense"].bc),
                                1e-5, 1e-5)
                print(f"[5] 2-D 1x1 {engine}: wall {wall:.3f}s (round loop {res.wall_s:.3f}s), "
                      f"{res.rounds_run} rounds, levels per round {res.round_levels}, "
                      f"launches {launches_2d[engine]}, peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, GTEPS_bc (m·n/s) "
                      f"{graph.num_edges * graph.n / wall / 1e9:.3f}, GTEPS over the "
                      f"{res.roots_accumulated} roots run (m·k/s) "
                      f"{graph.num_edges * res.roots_accumulated / wall / 1e9:.4f}; "
                      f"vs single-device dense: max abs err {err:.3g}")
                check(ok, f"2-D {engine} BC disagrees with the single-device dense engine")
                check(res.round_levels == results["dense"].round_levels,
                      f"2-D {engine}: levels per round differ from the single-device run")
                k12 = launches_2d[engine]["frontier_spmm"] + launches_2d[engine]["dependency_spmm"]
                check(k12 == 0, f"2-D {engine}: launched the single-device kernels K1/K2")
                fused = engine != "sparse"
                for kname in ("frontier_spmm_partial", "dependency_spmm_partial"):
                    check((launches_2d[engine][kname] > 0) == fused,
                          f"2-D {engine}: {kname} launches {launches_2d[engine][kname]}")
                del res
                torch.cuda.empty_cache()
            trace_run("[5] 2-D 1x1 fused", lambda: run_2d("fused"), {
                "K3": "FrontierOperand", "K4": "DependencyOperand", "NCCL": "nccl"})
            print(f"[5] 2-D path ok in {time.perf_counter() - t5:.1f}s")

            # ------------------------- 8. the BCSR path, 1×1 grid, full width
            t8 = time.perf_counter()
            total_mem = torch.cuda.get_device_properties(0).total_memory
            print(f"[8] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
            k14 = ("frontier_spmm", "dependency_spmm", "frontier_spmm_partial",
                   "dependency_spmm_partial")

            def run_8(tag, g, want, **kw):
                """One BCSR run, checked against ``want`` (a BCResult)."""
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()  # held by this script, not the run
                ops.reset_launches()
                t = time.perf_counter()
                res = distributed_betweenness_centrality(
                    g, groups, batch_size=MAIN_BATCH, heuristics="h0", sampling="fixed",
                    sample_seed=0, full_result=True, hbm_limit_bytes=total_mem, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches_2d[tag] = dict(ops.LAUNCHES)
                check(res.bc.shape == (g.n,) and bool(np.isfinite(res.bc).all()),
                      f"[8] {tag}: BC must be finite of shape ({g.n},)")
                ok, err = close(torch.from_numpy(res.bc), torch.from_numpy(want.bc), 1e-5, 1e-5)
                lay = res.layout_stats
                foot = lay["footprint"]
                print(f"[8] {tag} ({kw['engine_kind']}): wall {wall:.3f}s (round loop "
                      f"{res.wall_s:.3f}s), {res.rounds_run} rounds, levels per round "
                      f"{res.round_levels}, tile {lay['tile']}, stored tiles "
                      f"{lay['stored_tiles_max']} ({lay['nnz_tiles_total']} nonzero)"
                      + (f", dense cells {lay['dense_cells']}" if "dense_cells" in lay else "")
                      + f", footprint {foot['total_bytes'] / 2**30:.2f} GiB (adjacency "
                      f"{foot['adjacency_bytes'] / 2**30:.2f}) vs peak allocated by the run "
                      f"{(torch.cuda.max_memory_allocated() - live) / 2**30:.2f} GiB (above "
                      f"{live / 2**30:.2f} GiB live before it), launches "
                      f"{launches_2d[tag]}; max abs err {err:.3g}")
                check(ok, f"[8] {tag}: BC disagrees with its reference")
                check(res.round_levels == want.round_levels, f"[8] {tag}: levels per round differ")
                check(sum(launches_2d[tag][k] for k in k14) == 0, f"[8] {tag}: launched K1-K4")
                check(launches_2d[tag]["frontier_spmm_sparse"] > 0
                      and launches_2d[tag]["dependency_spmm_sparse"] > 0,
                      f"[8] {tag}: the run did not launch K5 and K6")
                return res

            # (a) the main-path graph and roots, against single-device dense
            a_kw = dict(sample_k=MAIN_SAMPLE_K)
            for tag, kw in (("rmat16 1x1 tile 128", dict(engine_kind="fused_sparse")),
                            (f"rmat16 1x1 tile {SPARSE_TILE}",
                             dict(engine_kind="fused_sparse", tile=(SPARSE_TILE, SPARSE_TILE))),
                            ("rmat16 1x1 hybrid", dict(engine_kind="fused_hybrid",
                                                       hybrid_threshold=1.0))):
                res = run_8(tag, graph, results["dense"], **a_kw, **kw)
                if kw["engine_kind"] == "fused_hybrid":
                    check(res.layout_stats["dense_cells"] == [[0]],
                          "[8] the bytes model should pick BCSR for the 1x1 R-MAT cell")
                del res
                torch.cuda.empty_cache()
            # (b) a graph whose dense block no card holds
            b_kw = dict(sample_k=STRIP_SAMPLE_K)
            before = torch.cuda.memory_allocated()
            try:
                check_device_memory(part_strips, "fused", MAIN_BATCH, total_mem)
                fail("[8] the memory guard let fused through on the strip graph")
            except MemoryError as err:
                check("fused_sparse" in str(err), "[8] the guard did not suggest fused_sparse")
                check(torch.cuda.memory_allocated() == before, "[8] the guard allocated")
                print(f"[8] {STRIPS} disjoint grid_graph{STRIP_SHAPE} strips, n={strips.n}, "
                      f"m={strips.num_edges}: memory guard (budget = total_memory "
                      f"{total_mem / 2**30:.2f} GiB) refused fused before allocating: {err}")
            t = time.perf_counter()
            arc = distributed_betweenness_centrality(
                strips, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="sparse",
                sampling="fixed", sample_seed=0, full_result=True, **b_kw)
            print(f"[8] {strip_tag} sparse (arc list, the reference): wall "
                  f"{time.perf_counter() - t:.3f}s (round loop {arc.wall_s:.3f}s), levels per "
                  f"round {arc.round_levels}")
            check(arc.bc.shape == (strips.n,) and bool(np.isfinite(arc.bc).all()),
                  "[8] the arc-list BC of the strip graph must be finite")
            run_8(strip_tag, strips, arc, engine_kind="fused_sparse", **b_kw)
            torch.cuda.empty_cache()
            trace_run(f"[8] {strip_tag} fused_sparse", lambda: distributed_betweenness_centrality(
                strips, groups, batch_size=MAIN_BATCH, heuristics="h0", engine_kind="fused_sparse",
                sampling="fixed", sample_seed=0, **b_kw), {
                "K5": ("bcsr_spmm_kernel", "FrontierOperand"),
                "K6": ("bcsr_spmm_kernel", "DependencyOperand"), "NCCL": "nccl"})
            print(f"[8] BCSR path ok in {time.perf_counter() - t8:.1f}s")
        finally:
            dist.destroy_process_group()

    # ------------------------------------------------------- 6. exact BC
    t6 = time.perf_counter()
    for name, g in (("rmat_graph(10, 16, seed=1)", rmat_graph(10, 16, seed=1)),
                    ("road_like_graph(20, 20, seed=1)", road_like_graph(20, 20, seed=1))):
        want = brandes_reference(g)
        for heur in ("h0", "h3t"):
            for engine in ("fused", "fused_bf16"):
                got = betweenness_centrality(g, batch_size=MAIN_BATCH, heuristics=heur,
                                             engine_kind=engine, device="cuda").bc
                ok, err = close(torch.from_numpy(got), torch.from_numpy(want), 1e-5, 1e-5)
                print(f"[6] {name} {heur} {engine} vs oracle: max abs err {err:.3g}")
                check(ok, f"{name} {heur} {engine} disagrees with brandes_reference")
    g13 = rmat_graph(13, 16, seed=1)
    dense13 = betweenness_centrality(g13, batch_size=MAIN_BATCH, heuristics="h3",
                                     engine_kind="dense", device="cuda").bc
    for engine in ("fused", "fused_bf16"):
        got = betweenness_centrality(g13, batch_size=MAIN_BATCH, heuristics="h3",
                                     engine_kind=engine, device="cuda").bc
        ok, err = close(torch.from_numpy(got), torch.from_numpy(dense13), 1e-5, 1e-5)
        print(f"[6] rmat_graph(13, 16, seed=1) h3 {engine} vs dense: max abs err {err:.3g}")
        check(ok, f"rmat 13 h3 {engine} disagrees with dense")
    print(f"[6] exact BC ok in {time.perf_counter() - t6:.1f}s")

    # ------------------------------------------------------------ 7. times
    A_main = {"f32": device_adjacency(graph, torch.float32, dev)}
    A_main["bf16"] = A_main["f32"].to(torch.bfloat16)
    engine_of = {"f32": "fused", "bf16": "fused_bf16"}
    print(f"[7] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    entries = []
    for kname, s, src, replaces in (
        ("frontier_spmm", s_fwd, "src/repro_torch/kernels/csrc/frontier_spmm.cu",
         "src/repro/kernels/frontier_spmm.py:40"),
        ("dependency_spmm", s_bwd, "src/repro_torch/kernels/csrc/dependency_spmm.cu",
         "src/repro/kernels/dependency_spmm.py:36"),
    ):
        sigma, depth, delta, omega = states[s]
        for tag in dtypes:
            A = A_main[tag]
            if kname == "frontier_spmm":
                kern = lambda: ops.frontier_spmm(A, sigma, depth, 2)
                plain = lambda: ref.frontier_spmm_ref(A, sigma, depth, 2)
                operand = sigma * (depth == 1)
                io_bytes = 2 * (sigma.nbytes + depth.nbytes)  # σ, d in; σ', d' out
            else:
                kern = lambda: ops.dependency_spmm(A, sigma, depth, delta, omega, 1)
                plain = lambda: ref.dependency_spmm_ref(A, sigma, depth, delta, omega, 1)
                operand = torch.where(depth == 2, (1.0 + delta + omega[:, None])
                                      / torch.where(sigma > 0, sigma, 1.0), 0.0)
                io_bytes = sigma.nbytes + depth.nbytes + 2 * delta.nbytes + omega.nbytes
            ms = cuda_time_ms(kern)
            plain_ms = cuda_time_ms(plain)
            # one library call computing the same product: only for an f32
            # adjacency (a bf16 matmul would round σ)
            lib_ms = (cuda_time_ms(lambda: torch.matmul(A, operand))
                      if tag == "f32" else None)
            flops = 2.0 * n_main * n_main * s
            nbytes = A.nbytes + io_bytes
            t_ops, t_bytes = flops / PEAK_F32_FLOP_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            entries.append({
                "name": f"{kname}[{tag} A]",
                "route": "cuda",
                "source": src,
                "replaces": replaces,
                "launches": launches[engine_of[tag]][kname],
                "max_abs_err": err_main[(kname, tag)],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_ms,
            })
            print(f"[7] {kname} A={tag} n={n_main} s={s}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, torch.matmul {lib_ms if lib_ms is None else f'{lib_ms:.3f}'} ms, "
                  f"bound {bound:.3f} ms ({entries[-1]['bound_by']}; ops {t_ops:.3f} / bytes "
                  f"{t_bytes:.3f}), {100 * bound / ms:.1f}% of bound")
            del operand
        if kname == "dependency_spmm":  # K2 also at the forward width, for comparison
            sigma, depth, delta, omega = states[s_fwd]
            for tag in dtypes:
                A = A_main[tag]
                ms = cuda_time_ms(lambda: ops.dependency_spmm(A, sigma, depth, delta, omega, 1))
                print(f"[7] dependency_spmm A={tag} n={n_main} s={s_fwd}: kernel {ms:.3f} ms")
    # K3/K4 at the 1×1 grid's block (the 2-D main path's shape) and at the
    # per-device block of a 2×4 grid, each at its main-path width
    A_blk = {"f32": part.cell_dense_block(0, 0, torch.float32, dev)}
    A_blk["bf16"] = A_blk["f32"].to(torch.bfloat16)
    partial_engine = {"f32": "fused", "bf16": "fused_bf16"}
    for kname, s, replaces in (
        ("frontier_spmm_partial", s_fwd, "src/repro/kernels/frontier_spmm.py:149"),
        ("dependency_spmm_partial", s_bwd, "src/repro/kernels/dependency_spmm.py:139"),
    ):
        for shape_tag, blocks, st, err_key in (
            ("1x1", A_main, states, "partial_1x1"), ("2x4", A_blk, blk_states, "partial_blk"),
        ):
            sigma, depth, delta, omega = st[s]
            for tag in dtypes:
                A = blocks[tag]
                m, k = A.shape
                if kname == "frontier_spmm_partial":
                    kern = lambda: ops.frontier_spmm_partial(A, sigma, depth, 2)
                    plain = lambda: ref.frontier_partial_ref(A, sigma, depth, 2)
                    operand = sigma * (depth == 1)
                    nbytes = partial_bytes(A, sigma, depth)
                    err = err_main[(err_key, tag, s)][0]
                else:
                    kern = lambda: ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1)
                    plain = lambda: ref.dependency_partial_ref(A, sigma, depth, delta, omega, 1)
                    operand = torch.where(depth == 2, (1.0 + delta + omega[:, None])
                                          / torch.where(sigma > 0, sigma, 1.0), 0.0)
                    nbytes = partial_bytes(A, sigma, depth, delta, omega)
                    err = err_main[(err_key, tag, s)][1]
                ms = cuda_time_ms(kern)
                plain_ms = cuda_time_ms(plain)
                lib_ms = (cuda_time_ms(lambda: torch.matmul(A, operand))
                          if tag == "f32" else None)
                t_ops = 2.0 * m * k * s / PEAK_F32_FLOP_PER_S * 1e3
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                bound = max(t_ops, t_bytes)
                entries.append({
                    "name": f"{kname}[{tag} A, {shape_tag} block {m}x{k}]",
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/partial_spmm.cu",
                    "replaces": replaces,
                    "launches": launches_2d[partial_engine[tag]][kname],
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": lib_ms,
                })
                print(f"[7] {kname} A={tag} {shape_tag} block [{m}, {k}] s={s}: kernel "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.matmul "
                      f"{lib_ms if lib_ms is None else f'{lib_ms:.3f}'} ms, bound {bound:.3f} ms "
                      f"({entries[-1]['bound_by']}; ops {t_ops:.3f} / bytes {t_bytes:.3f}), "
                      f"{100 * bound / ms:.1f}% of bound")
                del operand
    sigma, depth, delta, omega = blk_states[s_fwd]  # K4 on the block at the forward width
    for tag in dtypes:
        A = A_blk[tag]
        ms = cuda_time_ms(lambda: ops.dependency_spmm_partial(A, sigma, depth, delta, omega, 1))
        print(f"[7] dependency_spmm_partial A={tag} 2x4 block s={s_fwd}: kernel {ms:.3f} ms")
    del A_main, A_blk
    torch.cuda.empty_cache()
    # K5/K6 at phase 8's three cell layouts, each at its main-path width
    for tag, (g_l, part_l, tile, st_map) in layouts.items():
        tiles, rows, cols, row_ptr = part_l.cell_blocked_sparse(0, 0, *tile, device=dev)
        num_tiles, bm, bk = tiles.shape
        m = part_l.C * part_l.chunk
        # the library yardstick: the same 1x1 cell (A[dst, src] = 1) as a CSR tensor
        idx = torch.from_numpy(np.stack([g_l.dst, g_l.src])).to(dev, torch.int64)
        csr = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1], device=dev),
                                      (m, m)).coalesce().to_sparse_csr()
        del idx
        for kname, s, replaces in (
            ("frontier_spmm_sparse", s_fwd, "src/repro/kernels/blocked_spmm.py:143"),
            ("dependency_spmm_sparse", s_bwd, "src/repro/kernels/blocked_spmm.py:145"),
        ):
            sigma, depth, delta, omega = st_map[s]
            if kname == "frontier_spmm_sparse":
                kern = lambda: ops.frontier_spmm_sparse(tiles, rows, cols, sigma, depth, 2, m=m,
                                                        row_ptr=row_ptr)
                plain = lambda: ref.frontier_sparse_ref(tiles, rows, cols, sigma, depth, 2, m)
                operand = sigma * (depth == 1)
                nbytes = sparse_bytes(tiles, rows, cols, row_ptr, sigma, depth)
                err = err_main[("sparse", tag, s)][0]
            else:
                kern = lambda: ops.dependency_spmm_sparse(tiles, rows, cols, sigma, depth, delta,
                                                          omega, 1, m=m, row_ptr=row_ptr)
                plain = lambda: ref.dependency_sparse_ref(tiles, rows, cols, sigma, depth, delta,
                                                          omega, 1, m)
                operand = torch.where(depth == 2, (1.0 + delta + omega[:, None])
                                      / torch.where(sigma > 0, sigma, 1.0), 0.0)
                nbytes = sparse_bytes(tiles, rows, cols, row_ptr, sigma, depth, delta, omega)
                err = err_main[("sparse", tag, s)][1]
            ms = cuda_time_ms(kern)
            plain_ms = cuda_time_ms(plain)
            lib_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, operand))
            t_ops = 2.0 * num_tiles * bm * bk * s / PEAK_F32_FLOP_PER_S * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            entries.append({
                "name": f"{kname}[{tag}: {num_tiles} tiles of {bm}x{bk}]",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/sparse_spmm.cu",
                "replaces": replaces,
                "launches": launches_2d[tag][kname],
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_ms,
            })
            print(f"[7] {kname} {tag} ({num_tiles} tiles of {bm}x{bk}) s={s}: kernel {ms:.3f} "
                  f"ms, plain {plain_ms:.3f} ms, torch.sparse.mm (CSR, {csr.values().numel()} "
                  f"nonzeros) {lib_ms:.3f} ms, bound {bound:.3f} ms ({entries[-1]['bound_by']}; "
                  f"ops {t_ops:.3f} / bytes {t_bytes:.3f}), {100 * bound / ms:.1f}% of bound")
            del operand
        del tiles, rows, cols, row_ptr, csr
        torch.cuda.empty_cache()
    print(f"[7] clocks.sm, clocks.max.sm, power.draw, temperature: {gpu_clocks()}")
    print(f"[7] total {time.perf_counter() - t_all:.1f}s")

    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
