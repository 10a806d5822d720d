"""The 2-D path on a one-process grid: the calls ``launch/steps.py``'s
``build_bc_cell`` makes, in its order, on the benchmark's graph (the
configuration's schedule, ``partition_2d``, the rank's arc arrays and ω on the
device, ``make_distributed_round_fn`` at the configuration's static
level bound), over NCCL on the card and gloo on the CPU.  The round
function builds its operator anew each round, so the level steps are
counted on the operator's class for as long as the cell is open.
``bench/tests/test_bcbench_grid.py`` holds this copy to ``build_bc_cell``
on one graph."""
from __future__ import annotations

import numpy as np
import torch

from bcbench.cell import Cell, LevelSteps, program_schedule


def _operator_class(engine: str):
    from repro_torch.core import operators

    classes = {"sparse": operators.DistributedOperator,
               "fused": operators.DistributedFusedOperator,
               "fused_sparse": operators.DistributedFusedSparseOperator}
    if engine not in classes:
        raise ValueError(f"the grid path runs engines {sorted(classes)}, not {engine!r}")
    return classes[engine]


def build(cfg: dict, graph, device: torch.device, span) -> Cell:
    import torch.distributed as dist

    from repro_torch.core.distributed import distributed_graph_arrays, make_distributed_round_fn
    from repro_torch.distributed.groups import GridGroups
    from repro_torch.device import resolve_device
    from repro_torch.graphs.partition import partition_2d

    R, C = cfg["grid"]
    if R * C != 1:
        raise ValueError(f"a {R}x{C} grid needs {R * C} processes; this path runs one")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    op_class = _operator_class(cfg["engine"])
    dev = resolve_device(device)
    with span("groups"):
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        groups = GridGroups(1, R, C)
    try:
        with span("schedule"):
            (schedule, _, residual, omega), plan = program_schedule(cfg, graph)
        with span("partition"):
            part = partition_2d(residual, R, C)
            graph_args = distributed_graph_arrays(part, cfg["engine"], groups.i, groups.j, dev)
            omega_pad = np.zeros(part.n_pad, np.float32)
            omega_pad[: residual.n] = omega
            omega_t = torch.from_numpy(omega_pad).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        round_fn = make_distributed_round_fn(part, groups, num_levels=cfg["max_levels"],
                                             engine_kind=cfg["engine"])
    except BaseException:
        dist.destroy_process_group()
        raise
    steps = LevelSteps().attach(op_class)

    def fn(sources, derived):
        return round_fn(graph_args, omega_t, sources, derived)

    def close():
        steps.detach()
        dist.destroy_process_group()

    return Cell(round_fn=fn, schedule=schedule, steps=steps,
                info={"residual_arcs": residual.num_arcs, "n_pad": part.n_pad,
                      "chunk": part.chunk},
                close=close, plan=plan)
