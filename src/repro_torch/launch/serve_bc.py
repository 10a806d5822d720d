"""BC snapshot-serving launcher: answer queries while sampling refines.

    PYTHONPATH=src python -m repro_torch.launch.serve_bc --rmat-scale 16 --edge-factor 16 \
        --engine fused --batch-size 128 --sample-k 1024 --refresh-blocks 2 --generations 3
    PYTHONPATH=src python -m repro_torch.launch.serve_bc --grid 12x12 --sampling adaptive \
        --queries 20 --device cpu
    # the 2-D decomposed path: torchrun (NCCL) on cards, spawned gloo ranks on the host
    PYTHONPATH=src torchrun --standalone --nproc-per-node 1 -m repro_torch.launch.serve_bc \
        --rmat-scale 16 --edge-factor 16 --mesh 1x1 --engine fused --batch-size 128
    PYTHONPATH=src python -m repro_torch.launch.serve_bc --rmat-scale 7 --mesh 2x2 \
        --sample-frac 1.0 --device cpu --ckpt-dir bc_serve --overlap expand

Front end of the sampled-BC stack (``repro_torch/serving/``), the port of
the JAX package's ``launch/serve_bc.py``: a foreground query loop answers
``top_k`` requests from the current
:class:`~repro_torch.serving.BCSnapshotStore` generation while a
background refresher thread runs the *same* sampled schedule in budgeted
slices — each slice one ``betweenness_centrality`` (or, with a grid,
``distributed_betweenness_centrality``) call over a shared
:class:`~repro_torch.distributed.fault_tolerance.BCCheckpoint` with a
:class:`~repro_torch.serving.BlockBudgetStop`, so a slice resumes past the
committed prefix and every generation strictly extends the evidence.
After each slice the store republishes from the checkpoint (the raw
accumulator, rescaled N/k there) and swaps the generation atomically; the
last slice runs without a budget, so the final generation is the full
sampled estimate (exact with ``--sample-frac 1.0``).

Only the refresher thread touches the device or the process group; the
query loop reads the store's numpy snapshot.  Queries issued mid-refresh
are answered from the previous generation and counted as ``stale_hits``:
every query is exactly one of hit / stale_hit / miss.  A replacement
refresher republishes the last committed generation at start-up
(``publish_from_checkpoint``, ``"resumed": True``) before any new round.
``--engine`` takes the port's names; the run is on the card unless
``--device cpu`` is given.  On a grid every rank runs this loop (the
slices' collectives need all of them); rank 0 writes the checkpoint and
prints.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import threading
import time

from ..core.bc import ENGINE_KINDS, betweenness_centrality
from ..core.distributed import DIST_ENGINE_KINDS, distributed_betweenness_centrality
from ..core.operators import OVERLAP_POLICIES
from ..device import resolve_device
from ..distributed.fault_tolerance import BCCheckpoint
from ..distributed.groups import GridGroups, device_for_rank
from ..graphs import grid_graph, rmat_graph, road_like_graph
from ..roofline.model import sampled_run_seconds
from ..serving import BCSnapshotStore, BlockBudgetStop, eligible_roots, plan_sampling
from .bc import run_grid

logger = logging.getLogger(__name__)


def run_serving(
    graph,
    groups: GridGroups | None = None,
    *,
    ckpt_path: str,
    batch_size: int = 8,
    engine: str = "sparse",
    overlap: str = "none",
    tile: tuple[int, int] | None = None,
    sampling: str = "fixed",
    sample_frac: float | None = None,
    sample_k: int | None = None,
    sample_seed: int = 0,
    refresh_blocks: int = 2,
    generations: int = 3,
    queries: int = 12,
    top_k: int = 10,
    poll_s: float = 0.02,
    device=None,
) -> dict:
    """Serve BC queries while a background refresher extends the sample.

    Args:
      graph:          input graph.
      groups:         the rank's :class:`GridGroups` for the 2-D path (the
                      JAX package's ``mesh``), or None for one device.
      ckpt_path:      BCCheckpoint file the refresher slices share.
      batch_size:     sources per round.
      engine:         one of ``ENGINE_KINDS`` on one device; on a grid the
                      arc-list engines map to the distributed ``sparse``
                      and the rest must be ``DIST_ENGINE_KINDS``.
      overlap:        the grid's collective schedule (``"none"``,
                      ``"expand"``, ``"expand+fold"`` or ``"auto"``); one
                      device has none and refuses anything but ``"none"``.
      tile:           BCSR tile (bm, bk) of ``fused_sparse`` / ``fused_hybrid``.
      sampling / sample_frac / sample_k / sample_seed: the sampled
                      schedule; ``"off"`` is refused (a budgeted slice is a
                      truncated run, meaningful only as an estimate).
      refresh_blocks: dispatch blocks each non-final slice runs.
      generations:    maximum refresher slices; the last has no budget.
      queries:        minimum foreground ``top_k`` queries to issue.
      top_k:          k of the foreground query loop.
      poll_s:         sleep between foreground queries while refreshing.
      device:         None → the card (raises without one), "cpu" → host.

    Returns a stats dict: per-slice telemetry (``refresh_runs``), the
    store's query accounting (``stats``), the generation history the
    query loop observed (``history``), and the final snapshot's top-k and
    full estimate (``final_top_k`` / ``final_bc``).
    """
    if sampling == "off":
        raise ValueError(
            "serving refreshes in budgeted slices, which are only meaningful as rescaled "
            "estimates; pass sampling='fixed' (sample_frac=1.0 for an exact final "
            "generation) or 'adaptive'"
        )
    if groups is None:
        if engine not in ENGINE_KINDS:
            raise ValueError(f"engine {engine!r} needs a grid; on one device pick one of "
                             f"{ENGINE_KINDS}")
        if overlap != "none":
            raise ValueError("overlap is a distributed schedule; serve on a grid (groups=)")
        resolve_device(device)  # fail here, before any thread starts
        fr = 1
    else:
        engine = "sparse" if engine in ("dense", "sparse") else engine
        if engine not in DIST_ENGINE_KINDS:
            raise ValueError(f"unknown distributed engine {engine!r}")
        device_for_rank(device)
        fr = groups.fr
    plan = plan_sampling(eligible_roots(graph), sampling, sample_frac, sample_k, sample_seed)
    checkpoint = BCCheckpoint(ckpt_path)
    store = BCSnapshotStore()
    refresh_runs: list[dict] = []
    refresh_errors: list[BaseException] = []
    samp = dict(sampling=sampling, sample_frac=sample_frac, sample_k=sample_k,
                sample_seed=sample_seed)

    def _publish(meta: dict) -> int | None:
        return store.publish_from_checkpoint(checkpoint, num_eligible=plan.num_eligible,
                                             meta=meta)

    def _run_slice(stop_rule):
        if groups is not None:
            return distributed_betweenness_centrality(
                graph, groups, batch_size=batch_size, heuristics="h0", engine_kind=engine,
                overlap=overlap, tile=tile, checkpoint=checkpoint, stop_rule=stop_rule,
                full_result=True,
                device=device, **samp)
        return betweenness_centrality(
            graph, batch_size=batch_size, heuristics="h0", engine_kind=engine,
            checkpoint=checkpoint, stop_rule=stop_rule, device=device, **samp)

    # resume path: a replacement refresher serves the last committed
    # generation immediately, before any new rounds run
    if checkpoint.exists():
        gen = _publish({"resumed": True})
        if gen is not None:
            logger.info("resumed serving from committed snapshot (gen %d)", gen)

    def _refresher():
        try:
            for i in range(generations):
                final = i == generations - 1
                store.begin_refresh()
                t0 = time.perf_counter()
                result = _run_slice(None if final else BlockBudgetStop(refresh_blocks))
                gen = _publish({"refresh_slice": i + 1, "final": not result.stopped_early})
                store.end_refresh()
                wall = time.perf_counter() - t0
                blocks = -(-result.rounds_run // fr)
                left = len(result.schedule.rounds) - store.snapshot().meta["committed_rounds"]
                # the rest of the schedule, priced at this slice's block wall
                left_s = sampled_run_seconds(left, fr, result.wall_s / blocks) if blocks else 0.0
                refresh_runs.append({
                    "slice": i + 1,
                    "generation": gen,
                    "rounds_run": result.rounds_run,
                    "roots_accumulated": result.roots_accumulated,
                    "stopped_early": result.stopped_early,
                    "stop_stats": result.stop_stats,
                    "wall_s": wall,
                    "rounds_left": left,
                    "rounds_left_s_est": left_s,
                    "sampling": result.sampling_stats,
                })
                logger.info("refresh slice %d: %d rounds in %.3fs, generation %s; %d rounds "
                            "left, ~%.3fs at this slice's block wall", i + 1,
                            result.rounds_run, wall, gen, left, left_s)
                if not result.stopped_early:
                    break  # schedule exhausted (or the adaptive rule fired)
        except BaseException as exc:  # surfaced to the caller after join
            refresh_errors.append(exc)
        finally:
            store.end_refresh()

    history: list[dict] = []

    def _query():
        res = store.top_k(top_k)
        if res is None:
            return
        snap, top = res
        if not history or history[-1]["generation"] != snap.generation:
            history.append({"generation": snap.generation, "top_k": [v for v, _ in top],
                            "meta": dict(snap.meta)})

    _query()  # cold query: a miss unless a committed snapshot resumed us
    refresher = threading.Thread(target=_refresher, name="bc-refresher")
    refresher.start()
    issued = 1
    while refresher.is_alive() or issued < queries:
        _query()
        issued += 1
        if refresher.is_alive():
            time.sleep(poll_s)
    refresher.join()
    if refresh_errors:
        raise refresh_errors[0]
    _query()  # settled query: always a hit against the final generation

    snap = store.snapshot()
    return {
        "n": graph.n,
        "plan": {"mode": plan.mode, "num_eligible": plan.num_eligible, "k": plan.k,
                 "seed": plan.seed},
        "generations_published": store.generation,
        "refresh_runs": refresh_runs,
        "stats": dict(store.stats),
        "history": history,
        "final_top_k": history[-1]["top_k"] if history else [],
        "final_bc": None if snap is None else snap.bc,
    }


def _serve_rank(groups: GridGroups, graph, kwargs: dict):
    """One rank of a ``--mesh`` run: rank 0's :func:`run_serving` result
    (None elsewhere).  Module-level, so spawned gloo ranks import only this
    package."""
    out = run_serving(graph, groups, **kwargs)
    return out if groups.rank == 0 else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=None)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--grid", default=None, help="RxC grid graph")
    ap.add_argument("--road", default=None, help="RxC road-like graph")
    ap.add_argument("--mesh", default=None, help="RxC or FRxRxC: the 2-D decomposed path")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--engine", default="sparse",
                    choices=sorted(set(ENGINE_KINDS) | set(DIST_ENGINE_KINDS)))
    ap.add_argument("--overlap", default="none", choices=list(OVERLAP_POLICIES) + ["auto"],
                    help="the grid's collective schedule (ring pipelining; needs --mesh)")
    ap.add_argument("--tile", default=None, help="BCSR tile BM or BMxBK (fused_sparse/hybrid)")
    ap.add_argument("--sampling", default="fixed", choices=["fixed", "adaptive"])
    ap.add_argument("--sample-frac", type=float, default=None)
    ap.add_argument("--sample-k", type=int, default=None)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--refresh-blocks", type=int, default=2)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="shared refresher state (default: bc_serve under the temp directory)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (plain PyTorch versions)")
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
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(d) for d in args.mesh.split("x"))
        except ValueError:
            mesh_shape = ()
        if len(mesh_shape) not in (2, 3) or min(mesh_shape) < 1:
            raise SystemExit("--mesh takes RxC or FRxRxC (positive integers)")
    elif args.engine not in ENGINE_KINDS:
        raise SystemExit(f"{args.engine} is a distributed engine; pass --mesh RxC")
    if args.overlap != "none" and mesh_shape is None:
        raise SystemExit("--overlap is a distributed schedule; pass --mesh RxC")
    tile = None
    if args.tile:
        dims = tuple(int(d) for d in args.tile.split("x"))
        tile = (dims[0], dims[-1])

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "bc_serve")
    os.makedirs(ckpt_dir, exist_ok=True)
    kwargs = dict(
        ckpt_path=os.path.join(ckpt_dir, f"{name}.npz"), batch_size=args.batch_size,
        engine=args.engine, overlap=args.overlap, tile=tile, sampling=args.sampling,
        sample_frac=args.sample_frac,
        sample_k=args.sample_k, sample_seed=args.sample_seed,
        refresh_blocks=args.refresh_blocks, generations=args.generations,
        queries=args.queries, top_k=args.top, device=args.device,
    )
    if mesh_shape is not None:
        out = run_grid(_serve_rank, graph, mesh_shape, kwargs, on_cpu=args.device == "cpu")
        if out is None:  # not rank 0 of a torchrun grid
            return
    else:
        out = run_serving(graph, None, **kwargs)

    print(f"{name}: n={out['n']} sampling={out['plan']['mode']} "
          f"k={out['plan']['k']}/{out['plan']['num_eligible']} roots, engine={args.engine}, "
          f"device={args.device or 'cuda'}" + (f", mesh={args.mesh}" if mesh_shape else ""))
    for run in out["refresh_runs"]:
        print(f"  slice {run['slice']}: {run['rounds_run']} rounds, "
              f"{run['roots_accumulated']} roots committed, "
              f"{'stopped early' if run['stopped_early'] else 'final'}, {run['wall_s']:.2f}s")
    st = out["stats"]
    print(f"served {st['queries']} queries across {out['generations_published']} generations: "
          f"{st['hits']} hits, {st['stale_hits']} stale, {st['misses']} misses")
    bc = out["final_bc"]
    for v in out["final_top_k"]:
        print(f"  v{int(v):>8d}  BC = {bc[int(v)]:.1f}")


if __name__ == "__main__":
    main()
