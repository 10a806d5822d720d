"""BC launcher: exact (or source-sampled) betweenness centrality on one device.

    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 10 --edge-factor 16 \
        --heuristics h3 --batch-size 128 --engine fused
    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 16 --edge-factor 16 \
        --engine fused_bf16 --batch-size 128 --sampling fixed --sample-k 512
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 8x8 --device cpu --out bc.npy

The graphs are the JAX launcher's, with the same seeds (R-MAT, grid and
road-like; seed 1), so both launchers score the same graph.  ``--engine``
picks one of ``ENGINE_KINDS`` (``fused``/``fused_bf16`` are the CUDA
level kernels); ``--device`` defaults to the CUDA card and the run fails
without one unless ``--device cpu`` is given.  TEPS is reported per the
paper's Eq. 7 (m·n / seconds).
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from ..core.bc import ENGINE_KINDS, betweenness_centrality
from ..core.scheduler import HEURISTICS_MODES
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
    ap.add_argument("--engine", default="dense", choices=list(ENGINE_KINDS))
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

    print(
        f"{name}: n={graph.n} m={graph.num_edges} heuristics={args.heuristics} "
        f"engine={args.engine} sampling={args.sampling} device={args.device or 'cuda'}"
    )
    t0 = time.time()
    res = betweenness_centrality(
        graph,
        batch_size=args.batch_size,
        heuristics=args.heuristics,
        engine_kind=args.engine,
        device=args.device,
        **sampling_kw,
    )
    dt = time.time() - t0  # the result is on the host: the run has synchronised
    bc = res.bc
    teps = graph.num_edges * graph.n / max(dt, 1e-9)
    print(f"done in {dt:.2f}s — {res.rounds_run} rounds, {teps/1e9:.3f} GTEPS_bc")
    samp = res.sampling_stats
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
