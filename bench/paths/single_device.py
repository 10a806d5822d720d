"""The single-device path: ``core/bc.py``'s round function over one of its
engines, composed as ``betweenness_centrality`` composes it (the
configuration's schedule, sampled or exact, the level operator over the
residual graph, the 1-degree weights on the device); the operator's level
steps are counted."""
from __future__ import annotations

import torch

from bcbench.cell import Cell, LevelSteps, program_schedule


def build(cfg: dict, graph, device: torch.device, span) -> Cell:
    from repro_torch.core.bc import make_operator, make_round_fn
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    with span("schedule"):
        (schedule, _, residual, omega), plan = program_schedule(cfg, graph)
    with span("operator"):
        op = make_operator(residual, cfg["engine"], dev)
        omega_t = torch.from_numpy(omega).to(device=dev, dtype=torch.float32)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    steps = LevelSteps().attach(op)
    return Cell(round_fn=make_round_fn(op, omega_t, cfg["max_levels"]), schedule=schedule,
                steps=steps, close=steps.detach, plan=plan)
