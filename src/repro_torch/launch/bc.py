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
    # the ring-pipelined collective schedules (--overlap expand | expand+fold | auto):
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 5x5 --mesh 2x4 --engine fused \
        --overlap expand+fold --device cpu
    # blocked-sparse (BCSR) tiles, or a per-cell dense/BCSR choice:
    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 8 --mesh 2x4 \
        --engine fused_hybrid --tile 8 --device cpu
    # durable: a rerun with the same --ckpt-dir resumes past the committed rounds
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 8x8 --device cpu --ckpt-dir ck
    # weighted BC (bucketed delta-stepping) on generator weights:
    PYTHONPATH=src python -m repro_torch.launch.bc --road 4x5 --weights dyadic --weighted \
        --device cpu
    # straggler scheduling over FR replicas, self-checking rounds, the watchdog:
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 5x5 --mesh 2x2x2 --straggler steal \
        --integrity audit --dispatch-deadline auto --numeric-guard --device cpu
    # measured-cost autotuning (a rerun with the same cache file measures nothing):
    PYTHONPATH=src python -m repro_torch.launch.bc --rmat-scale 8 --mesh 2x2 \
        --engine fused_hybrid --overlap auto --autotune measure --autotune-cache tune.json \
        --device cpu
    # deterministic fault injection, recovered and reported:
    PYTHONPATH=src python -m repro_torch.launch.bc --grid 5x5 --mesh 2x2x2 --straggler steal \
        --chaos "seed=7;transient@1x2;poison@3:nan;kill@5:r1" --device cpu

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

``--overlap`` picks the 2-D path's collective schedule (needs ``--mesh``):
``none`` (the barrier all_gather / reduce_scatter), ``expand`` (the
expand as R−1 point-to-point ring hops overlapped with the block
compute, paper Fig. 2), ``expand+fold`` (the fold as a C−1-hop reduce
ring too) or ``auto`` (picked from the roofline level times, logged as
"overlap='auto' -> ...").

``--weights unit|dyadic`` attaches generator weights to the graph (a
``--grid`` through ``weighted_copy``, seed 1), ``--weighted`` runs the
bucketed weighted traversal on them (heuristics h0/h1/h1t) and
``--delta`` sets its bucket width (default: ``auto_delta``).

``--straggler steal|redeal`` runs the multi-ledger round loop over the FR
replicas of an FRxRxC ``--mesh`` (FR > 1; ``--straggler-factor`` is the
EWMA ratio that flags a straggler under ``redeal``).  ``--integrity
audit|checksum`` audits every block, ``--dispatch-deadline SECONDS|auto``
arms the dispatch watchdog, ``--max-retries`` / ``--retry-backoff`` size
the retry budget and ``--numeric-guard`` forces the non-finite guard on
(all on ``--mesh``, as in the JAX launcher); a "recovery: ..." line
reports any retry, quarantine or re-mesh.

``--autotune cache|measure`` puts measurements in place of the roofline's
guesses behind the tile, hybrid-cell, ``--overlap auto`` and straggler
prior choices (``cache`` reads the measured-cost cache only, ``measure``
times a candidate on a miss and records it), kept across runs in
``--autotune-cache PATH``; it also packs rounds by root eccentricity.
``--chaos SPEC`` injects a deterministic fault plan at the round and
file-write seams (``kind@at[xcount][:arg]`` entries: ``transient``,
``poison``, ``kill:rI``, ``crash``, ``torn``, ``cache``, ``flip``,
``stall``; repro_torch/distributed/chaos.py); the recovery line is then
always printed.  Both need ``--mesh``.

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

from ..autotune import AUTOTUNE_MODES
from ..core.bc import ENGINE_KINDS, betweenness_centrality
from ..core.distributed import DIST_ENGINE_KINDS, distributed_betweenness_centrality
from ..core.driver import INTEGRITY_MODES, STRAGGLER_POLICIES
from ..core.operators import OVERLAP_POLICIES
from ..core.scheduler import HEURISTICS_MODES
from ..distributed.fault_tolerance import BCCheckpoint
from ..distributed.groups import GridGroups, run_gloo
from ..graphs import WEIGHT_MODES, grid_graph, rmat_graph, road_like_graph, weighted_copy
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
        "--overlap",
        default="none",
        choices=list(OVERLAP_POLICIES) + ["auto"],
        help="distributed collective schedule (ring pipelining; needs --mesh; "
        "'auto' picks from the roofline estimate)",
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
        "--straggler",
        default="none",
        choices=list(STRAGGLER_POLICIES),
        help="sub-cluster straggler policy (needs an FRxRxC --mesh, FR > 1): 'steal' pulls "
        "rounds into replicas whose queue ran dry; 'redeal' re-packs all pending rounds "
        "when one replica's EWMA per-round wall exceeds --straggler-factor x the fastest's",
    )
    ap.add_argument(
        "--straggler-factor",
        type=float,
        default=2.0,
        help="EWMA per-round-wall ratio over the fastest replica that triggers a re-deal "
        "(straggler=redeal only; steal is queue-driven and ignores it)",
    )
    ap.add_argument(
        "--autotune",
        default="off",
        choices=list(AUTOTUNE_MODES),
        help="measured-cost autotuning (needs --mesh): 'cache' consults the measured-cost "
        "cache and falls back to the roofline on a miss; 'measure' micro-benches candidate "
        "configs on a miss and records them (measure-once: the next run with the same graph "
        "stats + mesh hits the cache).  Also switches the scheduler to eccentricity-packed "
        "rounds",
    )
    ap.add_argument(
        "--autotune-cache",
        default=None,
        help="path of the persistent measured-cost cache JSON (default: in-memory for this "
        "run only)",
    )
    ap.add_argument(
        "--chaos",
        default=None,
        help="deterministic fault-injection plan (needs --mesh): 'kind@at[xcount][:arg]' "
        "entries separated by ';', plus 'seed=N' — kinds transient | poison[:nan|:inf] | "
        "kill:rI | crash | torn | cache | flip[:rI|:dI|:neg] (finite silent corruption; pair "
        "with --integrity) | stall[:MS] (delay a dispatch; pair with --dispatch-deadline), "
        "e.g. 'seed=7;transient@1x2;poison@3:nan;kill@4:r1;flip@5'.  Reproduces any failure "
        "from the CLI; recovery is reported (see repro_torch/distributed/chaos.py)",
    )
    ap.add_argument(
        "--integrity",
        default="off",
        choices=list(INTEGRITY_MODES),
        help="self-checking rounds (needs --mesh): 'audit' checks each block against its "
        "claimed sum and output bounds; 'checksum' adds the ABFT lane to every level "
        "product.  Failed blocks are quarantined and re-dispatched",
    )
    ap.add_argument(
        "--dispatch-deadline",
        default=None,
        help="dispatch watchdog deadline in seconds, or 'auto' for max(60, 50 x the "
        "roofline round prior) (needs --mesh).  A block past it is re-dispatched, then "
        "escalated to a replica loss the straggler loop re-meshes around",
    )
    ap.add_argument(
        "--max-retries",
        type=int,
        default=None,
        help="retry budget per dispatch block (transient errors, watchdog trips, "
        "quarantined blocks; default 2)",
    )
    ap.add_argument(
        "--retry-backoff",
        type=float,
        default=None,
        help="base seconds of the exponential backoff between transient retries "
        "(default 0.05)",
    )
    ap.add_argument(
        "--numeric-guard",
        action="store_true",
        help="force the per-block non-finite bc/ns guard on (automatic under a straggler "
        "policy and whenever a fallback round function exists)",
    )
    ap.add_argument(
        "--sampling",
        default="off",
        choices=list(SAMPLING_MODES),
        help="'fixed' runs a seeded k-root subset and rescales by N/k "
        "(needs --heuristics h0); 'adaptive' also stops once the top-k ranks "
        "stabilise (logs 'stop rule fired after B dispatch blocks')",
    )
    ap.add_argument("--sample-frac", type=float, default=None)
    ap.add_argument("--sample-k", type=int, default=None)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument(
        "--weighted",
        action="store_true",
        help="weighted BC through the bucketed (delta-stepping) traversal; needs "
        "--weights; --heuristics h0, h1 or h1t",
    )
    ap.add_argument(
        "--weights",
        default="none",
        choices=list(WEIGHT_MODES),
        help="edge weights of the generated graph: 'unit' (all 1.0) or 'dyadic' "
        "(k/4, k = 1..16: exact f32 distance sums); pair with --weighted",
    )
    ap.add_argument(
        "--delta",
        type=float,
        default=None,
        help="bucket width of the weighted traversal (needs --weighted; default: "
        "derived from the weights, repro_torch.core.operators.auto_delta)",
    )
    ap.add_argument(
        "--device", default=None, help="'cuda' (default) or 'cpu' (plain PyTorch versions)"
    )
    ap.add_argument(
        "--ckpt-dir", default=None,
        help="BCCheckpoint directory: a rerun resumes past the committed rounds "
        "(prints 'resuming: N rounds already committed')",
    )
    ap.add_argument(
        "--generations", type=int, default=None,
        help="BCCheckpoint snapshot generations to keep (default 3); a load falls back "
        "to the newest intact one on a torn write",
    )
    ap.add_argument("--out", default=None, help="save the BC scores (.npy)")
    ap.add_argument("--top", type=int, default=10)
    return ap


def _mesh_rank(groups: GridGroups, graph, kwargs: dict):
    """One rank of a ``--mesh`` run: its :class:`BCResult` and seconds on
    rank 0, None elsewhere.  Module-level, so spawned gloo processes
    import only this package."""
    t0 = time.perf_counter()
    res = distributed_betweenness_centrality(graph, groups, full_result=True, **kwargs)
    dt = time.perf_counter() - t0  # the result is on the host: the run has synchronised
    if groups.rank != 0:
        return None
    return res, dt


def _print_recovery(rec: dict) -> None:
    """The JAX launcher's recovery and integrity lines: the first when a
    chaos plan ran, or any retry, quarantine, fallback or re-mesh happened
    or the run resumed, the second whenever an integrity mode was on."""
    integ = rec["integrity"]
    events = any(v for k, v in rec.items() if k not in ("resumed_generation", "integrity"))
    integ_events = any(v for k, v in integ.items()
                       if k not in ("mode", "max_checksum_residual"))
    if "chaos" in rec or events or integ_events or rec["resumed_generation"]:
        print(f"recovery: {rec['retries']} retries ({rec['transient_errors']} transient), "
              f"{rec['quarantined_blocks']} quarantined, {rec['fallback_recomputes']} fallback "
              f"recomputes, {rec['remesh_events']} re-mesh events (dead replicas "
              f"{rec['dead_replicas']}), resumed generation {rec['resumed_generation']}")
    if integ["mode"] != "off":
        print(f"integrity[{integ['mode']}]: {integ['checksum_failures']} checksum + "
              f"{integ['audit_failures']} audit failures, {integ['vote_mismatches']}/"
              f"{integ['votes']} duplicate-vote mismatches, {integ['quarantined_rounds']} "
              f"quarantined rounds, watchdog {integ['watchdog_trips']} trips / "
              f"{integ['watchdog_escalations']} escalations, max checksum residual "
              f"{integ['max_checksum_residual']:.2e}")


def run_grid(fn, graph, mesh_shape: tuple[int, ...], kwargs: dict, *, on_cpu: bool):
    """``fn(groups, graph, kwargs)`` on every rank of an RxC / FRxRxC grid:
    under torchrun in this process (NCCL, or gloo with ``on_cpu``), else on
    spawned gloo ranks with ``on_cpu``.  Returns rank 0's result (None on
    the other ranks of a torchrun grid)."""
    fr, R, C = (1,) * (3 - len(mesh_shape)) + tuple(mesh_shape)
    world = fr * R * C
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # under torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(
                f"--mesh {'x'.join(map(str, mesh_shape))} needs {world} ranks, "
                f"torchrun started {os.environ['WORLD_SIZE']}"
            )
        dist.init_process_group("gloo" if on_cpu else "nccl", init_method="env://")
        try:
            return fn(GridGroups(fr, R, C), graph, kwargs)
        finally:
            dist.destroy_process_group()
    if on_cpu:
        return run_gloo(fn, fr, R, C, (graph, kwargs))[0]
    raise SystemExit(
        f"--mesh on the card runs one process per device: launch with "
        f"torchrun --standalone --nproc-per-node {world}"
    )


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    if args.rmat_scale is not None:
        graph = rmat_graph(args.rmat_scale, args.edge_factor, seed=1, weights=args.weights)
        name = f"rmat_s{args.rmat_scale}_ef{args.edge_factor}"
    elif args.grid:
        r, c = map(int, args.grid.split("x"))
        graph = grid_graph(r, c)
        if args.weights != "none":
            graph = weighted_copy(graph, weights=args.weights, seed=1)
        name = f"grid_{r}x{c}"
    elif args.road:
        r, c = map(int, args.road.split("x"))
        graph = road_like_graph(r, c, seed=1, weights=args.weights)
        name = f"road_{r}x{c}"
    else:
        raise SystemExit("pick --rmat-scale, --grid or --road")
    if args.weighted and graph.w is None:
        raise SystemExit("--weighted needs edge weights; pass --weights unit|dyadic")
    if args.delta is not None and not args.weighted:
        raise SystemExit("--delta sizes the weighted buckets; pass --weighted")
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(d) for d in args.mesh.split("x"))
        except ValueError:
            mesh_shape = ()
        if len(mesh_shape) not in (2, 3) or min(mesh_shape) < 1:
            raise SystemExit("--mesh takes RxC or FRxRxC (positive integers)")
    if args.overlap != "none" and mesh_shape is None:
        raise SystemExit("--overlap is a distributed schedule; pass --mesh RxC")
    if args.straggler != "none" and mesh_shape is not None and (
            len(mesh_shape) != 3 or mesh_shape[0] == 1):
        raise SystemExit("--straggler re-deals rounds between sub-cluster replicas; pass a "
                         "replicated --mesh FRxRxC (FR > 1)")
    if args.autotune != "off" and mesh_shape is None:
        raise SystemExit("--autotune measures distributed round configs; pass --mesh RxC")
    if args.chaos and mesh_shape is None:
        raise SystemExit("--chaos injects faults at the distributed round seam; pass --mesh RxC")
    if args.integrity != "off" and mesh_shape is None:
        raise SystemExit("--integrity audits the distributed round loop; pass --mesh RxC")
    deadline = None
    if args.dispatch_deadline is not None:
        if mesh_shape is None:
            raise SystemExit("--dispatch-deadline arms the distributed dispatch watchdog; "
                             "pass --mesh RxC")
        if args.dispatch_deadline == "auto":
            deadline = "auto"
        else:
            try:
                deadline = float(args.dispatch_deadline)
            except ValueError:
                raise SystemExit("--dispatch-deadline takes seconds or 'auto'") from None
            if deadline <= 0:
                raise SystemExit("--dispatch-deadline takes positive seconds or 'auto'")
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

    is_rank0 = int(os.environ.get("RANK", 0)) == 0
    checkpoint = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        ckpt_kw = {} if args.generations is None else {"generations": args.generations}
        checkpoint = BCCheckpoint(os.path.join(args.ckpt_dir, f"{name}.npz"), **ckpt_kw)
        if checkpoint.exists() and is_rank0:
            _, _, committed = checkpoint.load()
            gen = checkpoint.loaded_generation
            print(f"resuming: {len(committed)} rounds already committed"
                  + ("" if not gen else f" (from fallback generation {gen})"))
    kwargs = dict(batch_size=args.batch_size, heuristics=args.heuristics,
                  device=args.device, checkpoint=checkpoint, straggler=args.straggler,
                  **sampling_kw)
    if args.weighted:
        kwargs.update(weighted=True, delta=args.delta)
    if is_rank0:
        print(
            f"{name}: n={graph.n} m={graph.num_edges} heuristics={args.heuristics} "
            f"engine={args.engine} sampling={args.sampling} device={args.device or 'cuda'}"
            + (f" mesh={args.mesh} overlap={args.overlap} straggler={args.straggler}"
               if mesh_shape else "")
            + (f" weighted(delta={args.delta or 'auto'})" if args.weighted else "")
        )
    t0 = time.time()
    if mesh_shape is not None:
        # the arc-list engines map to the distributed arc-list engine
        engine = "sparse" if args.engine in ("dense", "sparse") else args.engine
        hbm = args.hbm_gb * 2**30 if args.hbm_gb > 0 else None
        robust_kw: dict = dict(straggler_factor=args.straggler_factor, integrity=args.integrity,
                               dispatch_deadline_s=deadline, autotune=args.autotune,
                               autotune_cache=args.autotune_cache, chaos=args.chaos)
        if args.max_retries is not None:
            robust_kw["max_retries"] = args.max_retries
        if args.retry_backoff is not None:
            robust_kw["retry_backoff_s"] = args.retry_backoff
        if args.numeric_guard:
            robust_kw["numeric_guard"] = True
        out = run_grid(_mesh_rank, graph, mesh_shape, dict(
            kwargs, engine_kind=engine, overlap=args.overlap, tile=tile,
            hybrid_threshold=args.hybrid_threshold, hbm_limit_bytes=hbm, **robust_kw),
            on_cpu=args.device == "cpu")
        if out is None:  # not rank 0 of a torchrun grid
            return
        res, dt = out
        bc, rounds, samp, layout = res.bc, res.rounds_run, res.sampling_stats, res.layout_stats
        _print_recovery(res.recovery_stats)
        if res.straggler_stats is not None:
            st = res.straggler_stats
            print(f"straggler[{st['policy']}]: {st['rounds_stolen']} stolen, "
                  f"{st['rounds_redealt']} re-dealt ({st['redeal_events']} events), "
                  f"{st['duplicates_discarded']}/{st['duplicates_dispatched']} duplicates "
                  f"discarded, rounds per replica {st['per_replica_rounds']}")
        foot = layout["footprint"]
        if "autotune" in layout:
            tune = layout["autotune"]
            print(f"autotune[{tune['mode']}]: tile {tune['tile']} ({tune['tile_source']}), "
                  f"overlap s/level {tune['overlap_level_s']}, hybrid calibration "
                  f"{'measured' if tune['cell_costs_measured'] else 'roofline'}; "
                  f"{tune['hits']} hits, {tune['misses']} misses, {tune['measured']} measured "
                  f"in {layout['autotune_s']:.3f}s")
        if args.overlap != "none":
            print(f"collective schedule: overlap={layout['overlap']}")
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
