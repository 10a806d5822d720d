"""BC launcher: exact (or source-sampled) betweenness centrality on one
device or on a 2-D grid of devices.

    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 10 --edge-factor 16 \
        --heuristics h3 --batch-size 128 --engine fused
    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 16 --edge-factor 16 \
        --engine fused_bf16 --batch-size 128 --sampling fixed --sample-k 512
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 8x8 --device cpu --out bc.npy
    # the paper's 2-D decomposition (R×C grid, or FR×R×C with sub-clusters):
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 5x5 --mesh 2x4 --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.bc \
        --rmat-scale 16 --edge-factor 16 --mesh 2x4 --engine fused
    # blocked-sparse (BCSR) tiles, or a per-cell dense/BCSR choice:
    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 8 --mesh 2x4 \
        --engine fused_hybrid --tile 8 --device cpu

The graphs are the JAX launcher's, with the same seeds (R-MAT, grid and
road-like; seed 1), so both launchers score the same graph.  ``--engine``
picks one of ``ENGINE_KINDS`` (``fused``/``fused_bf16`` are the CUDA
level kernels); ``--device`` defaults to the CUDA card and the run fails
without one unless ``--device cpu`` is given.  TEPS is reported per the
paper's Eq. 7 (m·n / seconds).

``--engine fused_sparse`` (K5/K6 over the stored BCSR tiles of each
block) and ``fused_hybrid`` (dense or BCSR per cell) are distributed
engines and need ``--mesh``; ``--tile BM[xBK]`` shapes their tiles,
``--hybrid-threshold`` moves the hybrid's break-even, and ``--hbm-gb``
arms the memory guard, which refuses an engine whose per-device
footprint exceeds that budget before anything is allocated.  The
footprint and the stored-tile count are printed either way.

``--mesh`` runs :func:`~repro_torch.core.distributed.distributed_betweenness_centrality`
with one process per grid device.  On cards, run the launcher under
``torchrun`` (NCCL, the device from ``LOCAL_RANK``).  With ``--device
cpu`` and no ``torchrun`` environment the launcher spawns the FR·R·C gloo
processes itself.  As in the JAX launcher, the arc-list engines (``dense``,
``sparse``) map to the distributed ``sparse`` engine; rank 0 prints the
summary and writes ``--out``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch.distributed as dist

from ..core.bc import ENGINE_KINDS, betweenness_centrality
from ..core.distributed import DIST_ENGINE_KINDS, distributed_betweenness_centrality
from ..core.scheduler import HEURISTICS_MODES
from ..distributed.groups import GridGroups, run_gloo
from ..graphs import grid_graph, rmat_graph, road_like_graph
from ..serving.sampling import SAMPLING_MODES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=None)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--grid", default=None, help="RxC grid graph")
    ap.add_argument("--road", default=None, help="RxC road-like graph")
    ap.add_argument("--heuristics", default="h0", choices=list(HEURISTICS_MODES))
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument(
        "--engine", default="dense", choices=sorted(set(ENGINE_KINDS) | set(DIST_ENGINE_KINDS))
    )
    ap.add_argument(
        "--mesh",
        default=None,
        help="RxC or FRxRxC: the 2-D decomposed path on FR·R·C ranks "
        "(torchrun on the card; spawned gloo processes with --device cpu)",
    )
    ap.add_argument(
        "--tile",
        default=None,
        help="BCSR tile shape BM or BMxBK (fused_sparse / fused_hybrid; both must "
        "divide the partition chunk; default: largest divisor <= 128, multiples "
        "of 8 preferred)",
    )
    ap.add_argument(
        "--hybrid-threshold",
        type=float,
        default=1.0,
        help="fused_hybrid break-even: a cell streams BCSR tiles when their bytes "
        "are under this fraction of its dense-block bytes (0 forces every cell "
        "dense, a large value every cell sparse; the choice is logged)",
    )
    ap.add_argument(
        "--hbm-gb",
        type=float,
        default=0.0,
        help="per-device memory budget (GiB) arming the fail-fast memory guard "
        "(e.g. 80 for an H100); the footprint is always printed",
    )
    ap.add_argument(
        "--sampling",
        default="off",
        choices=list(SAMPLING_MODES),
        help="'fixed' runs a seeded k-root subset and rescales by N/k "
        "(needs --heuristics h0); 'adaptive' is not ported yet",
    )
    ap.add_argument("--sample-frac", type=float, default=None)
    ap.add_argument("--sample-k", type=int, default=None)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument(
        "--device", default=None, help="'cuda' (default) or 'cpu' (plain PyTorch versions)"
    )
    ap.add_argument("--out", default=None, help="save the BC scores (.npy)")
    ap.add_argument("--top", type=int, default=10)
    return ap


def _mesh_rank(groups: GridGroups, graph, kwargs: dict):
    """One rank of a ``--mesh`` run: (bc, rounds, sampling stats, seconds)
    on rank 0, None elsewhere.  Module-level, so spawned gloo processes
    import only this package."""
    t0 = time.perf_counter()
    res = distributed_betweenness_centrality(graph, groups, full_result=True, **kwargs)
    dt = time.perf_counter() - t0  # the result is on the host: the run has synchronised
    if groups.rank != 0:
        return None
    return res.bc, res.rounds_run, res.sampling_stats, res.layout_stats, dt


def _run_mesh(graph, mesh_shape: tuple[int, ...], kwargs: dict):
    """Rank 0's ``_mesh_rank`` result (None on the other ranks)."""
    fr, R, C = (1,) * (3 - len(mesh_shape)) + tuple(mesh_shape)
    world = fr * R * C
    on_cpu = kwargs["device"] == "cpu"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(
                f"--mesh {'x'.join(map(str, mesh_shape))} needs {world} ranks, "
                f"torchrun started {os.environ['WORLD_SIZE']}"
            )
        dist.init_process_group("gloo" if on_cpu else "nccl", init_method="env://")
        try:
            return _mesh_rank(GridGroups(fr, R, C), graph, kwargs)
        finally:
            dist.destroy_process_group()
    if on_cpu:
        return run_gloo(_mesh_rank, fr, R, C, (graph, kwargs))[0]
    raise SystemExit(
        f"--mesh on the card runs one process per device: launch with "
        f"torchrun --standalone --nproc-per-node {world}"
    )


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    if args.rmat_scale is not None:
        graph = rmat_graph(args.rmat_scale, args.edge_factor, seed=1)
        name = f"rmat_s{args.rmat_scale}_ef{args.edge_factor}"
    elif args.grid:
        r, c = map(int, args.grid.split("x"))
        graph = grid_graph(r, c)
        name = f"grid_{r}x{c}"
    elif args.road:
        r, c = map(int, args.road.split("x"))
        graph = road_like_graph(r, c, seed=1)
        name = f"road_{r}x{c}"
    else:
        raise SystemExit("pick --rmat-scale, --grid or --road")
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(d) for d in args.mesh.split("x"))
        except ValueError:
            mesh_shape = ()
        if len(mesh_shape) not in (2, 3) or min(mesh_shape) < 1:
            raise SystemExit("--mesh takes RxC or FRxRxC (positive integers)")
    if args.engine in ("fused_sparse", "fused_hybrid") and mesh_shape is None:
        raise SystemExit(f"{args.engine} is a distributed engine; pass --mesh RxC")
    tile = None
    if args.tile:
        if mesh_shape is None:
            raise SystemExit("--tile shapes the blocked-sparse/hybrid layouts; pass --mesh RxC")
        try:
            dims = tuple(int(d) for d in args.tile.split("x"))
        except ValueError:
            dims = ()
        if len(dims) not in (1, 2) or min(dims) < 1:
            raise SystemExit("--tile takes BM or BMxBK (positive integers)")
        tile = (dims[0], dims[-1])

    sampling_kw: dict = {}
    if args.sampling != "off":
        sampling_kw = {
            "sampling": args.sampling,
            "sample_frac": args.sample_frac,
            "sample_k": args.sample_k,
            "sample_seed": args.sample_seed,
        }
    elif args.sample_frac is not None or args.sample_k is not None:
        raise SystemExit(
            "--sample-frac/--sample-k size a sampled run; pass --sampling fixed"
        )

    kwargs = dict(batch_size=args.batch_size, heuristics=args.heuristics,
                  device=args.device, **sampling_kw)
    is_rank0 = int(os.environ.get("RANK", 0)) == 0
    if is_rank0:
        print(
            f"{name}: n={graph.n} m={graph.num_edges} heuristics={args.heuristics} "
            f"engine={args.engine} sampling={args.sampling} device={args.device or 'cuda'}"
            + (f" mesh={args.mesh}" if mesh_shape else "")
        )
    t0 = time.time()
    if mesh_shape is not None:
        # the arc-list engines map to the distributed arc-list engine
        engine = "sparse" if args.engine in ("dense", "sparse") else args.engine
        hbm = args.hbm_gb * 2**30 if args.hbm_gb > 0 else None
        out = _run_mesh(graph, mesh_shape, dict(
            kwargs, engine_kind=engine, tile=tile, hybrid_threshold=args.hybrid_threshold,
            hbm_limit_bytes=hbm))
        if out is None:  # not rank 0 of a torchrun grid
            return
        bc, rounds, samp, layout, dt = out
        foot = layout["footprint"]
        print(f"per-device footprint ({engine}): adjacency "
              f"{foot['adjacency_bytes'] / 2**30:.4g} GiB + state "
              f"{foot['state_bytes'] / 2**30:.4g} GiB = {foot['total_bytes'] / 2**30:.4g} GiB")
        if "tile" in layout:
            bm, bk = layout["tile"]
            print(f"BCSR tile {bm}x{bk}: stored tiles max {layout['stored_tiles_max']} per "
                  f"rank, {layout['stored_tiles_total']} in all "
                  f"({layout['nnz_tiles_total']} nonzero)"
                  + (f"; dense cells {layout['dense_cells']}" if "dense_cells" in layout
                     else ""))
    else:
        res = betweenness_centrality(graph, engine_kind=args.engine, **kwargs)
        dt = time.time() - t0  # the result is on the host: the run has synchronised
        bc, rounds, samp = res.bc, res.rounds_run, res.sampling_stats
    teps = graph.num_edges * graph.n / max(dt, 1e-9)
    print(f"done in {dt:.2f}s — {rounds} rounds, {teps/1e9:.3f} GTEPS_bc")
    if samp:
        print(
            f"sampling[{samp['mode']}]: "
            f"{samp['roots_accumulated']}/{samp['num_eligible']} roots "
            f"(planned k={samp['k_planned']}, seed {samp['seed']}), "
            f"estimates rescaled x{samp['scale']:.3f}"
        )
    for v in np.argsort(bc)[::-1][: args.top]:
        print(f"  v{int(v):>8d}  BC = {bc[int(v)]:.1f}")
    if args.out:
        np.save(args.out, bc)
        print("scores ->", args.out)


if __name__ == "__main__":
    main()
