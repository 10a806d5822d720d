"""Rank-side case runner for tests/test_torch_gnn2d.py: the port's 2-D GNN
message passing and its train cell on spawned gloo grids.

``run_cases`` is what each spawned gloo rank executes
(:func:`repro_torch.distributed.run_gloo` pickles it by reference).  It
imports only numpy, torch and the port — never jax or the JAX package.
Every rank runs the same cases in the same order, as the collectives
require, and returns per case what the test holds against the JAX
package: the loss, every parameter's gradient (numpy, flat dotted
names) and the collectives the step issued, per group and class, from
the package's work counter.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.launch.steps import build_gnn_cell
from repro_torch.models.gnn2d import gnn2d_local_batch, make_gnn2d_loss_fn
from repro_torch.roofline.counter import WorkCounter

DTYPES = {None: None, "bf16": torch.bfloat16}


def _counted(groups, fn):
    """``fn()`` under the work counter; returns (its result, the
    collectives it issued as ``{"<group>/<class>": count}``, the group one
    of ``column``, ``row``, ``grid`` or ``other``)."""
    with WorkCounter() as counter:
        out = fn()
    counts = collections.Counter()
    for rec in counter.records:
        where = next((name for name in ("column", "row", "grid")
                      if rec["group"] is getattr(groups, name)), "other")
        counts[f"{where}/{rec['class']}"] += 1
    return out, dict(counts)


def _loss_grad(groups, cfg, shape_kind, b2d, params, chunk, max_arcs, n_graphs, gather, fold):
    """The 2-D loss and every gradient of this rank, from the global 2-D
    batch ``b2d`` and the parameters ``params`` (numpy, flat names)."""
    loss_fn = make_gnn2d_loss_fn(cfg, groups, shape_kind, chunk=chunk, max_arcs=max_arcs,
                                 n_graphs=n_graphs, gather_dtype=DTYPES[gather],
                                 fold_dtype=DTYPES[fold])
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    local = gnn2d_local_batch(b2d, groups, "cpu")

    def step():
        loss = loss_fn(tp, local)
        loss.backward()
        return float(loss)

    loss, counts = _counted(groups, step)
    return {"loss": loss, "grads": {k: v.grad.numpy() for k, v in tp.items()},
            "collectives": counts}


def _cell(groups, bundle, shape_name, seed):
    """One step of the GNN train cell: its parameters before, the loss,
    the parameters and AdamW moments after."""
    cell = build_gnn_cell(bundle, shape_name, groups, device="cpu", seed=seed)
    before = {k: v.detach().clone().numpy() for k, v in cell.params.items()}
    out = cell.fn()
    return {"loss": float(out["loss"]), "before": before,
            "after": {k: v.detach().numpy() for k, v in cell.params.items()},
            "mu": {k: cell.optimizer.state[v]["mu"].numpy() for k, v in cell.params.items()},
            "chunk": cell.chunk, "max_arcs": cell.max_arcs, "meta": cell.static_meta}


CASES = {"loss_grad": _loss_grad, "cell": _cell}


def run_cases(groups, cases):
    """Every ``(name, kind, args)`` case on this rank, in order:
    ``{name: result}``."""
    torch.manual_seed(0)
    return {name: CASES[kind](groups, *args) for name, kind, args in cases}
