"""GNN training with the paper's 2-D decomposition in the PyTorch port
(``models/gnn2d.py``; the counterpart of examples/gnn_products.py).

    PYTHONPATH=src python examples/gnn_products_torch.py               # the card, a 1x1 NCCL grid
    PYTHONPATH=src python examples/gnn_products_torch.py --device cpu  # a 2x4 gloo grid on the host

Trains a reduced GIN on a synthetic products-like graph (R-MAT scale 10),
full-batch, with message passing distributed like MGBC's traversal: an
expand all-gather over the column and a fold reduce-scatter over the row
of the grid, their transposes in the backward.  Asserts the reference
example's loss drop.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data import full_graph_batch, to_2d_batch
from repro_torch.distributed import GridGroups, device_for_rank, run_gloo
from repro_torch.graphs import rmat_graph
from repro_torch.models import gnn as gnn_mod
from repro_torch.models.gnn2d import gnn2d_local_batch, make_gnn2d_loss_fn
from repro_torch.optim import adamw

STEPS = 60


def train(groups: GridGroups, device) -> list[float]:
    """The reference example's run on this rank of the grid: the losses."""
    dev = device_for_rank(device)
    R, C = groups.R, groups.C
    cfg = dataclasses.replace(get_arch("gin-tu").arch, n_layers=3, d_hidden=32)
    graph = rmat_graph(10, 8, seed=3)
    d_feat, n_classes = 32, 16
    batch = full_graph_batch(cfg, graph, graph.n, 2 * graph.num_arcs, d_feat,
                             n_classes, n_classes, seed=0)
    # learnable labels: a linear probe of the node features
    probe = np.random.default_rng(1).standard_normal((d_feat, n_classes))
    batch["labels"] = np.argmax(batch["node_feat"] @ probe, axis=1).astype(np.int32)
    b2d = to_2d_batch(batch, graph.n, R, C)
    chunk = b2d["node_feat"].shape[0] // (R * C)
    loss_fn = make_gnn2d_loss_fn(cfg, groups, "full_graph", chunk=chunk,
                                 max_arcs=b2d["src_local"].shape[2])
    local = gnn2d_local_batch(b2d, groups, dev)
    params = gnn_mod.init_params(cfg, d_feat, n_classes,
                                 torch.Generator(device=dev).manual_seed(0))
    opt = adamw(params.values(), 3e-3)
    losses = []
    for i in range(STEPS):
        loss = loss_fn(params, local)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.item())
        if groups.rank == 0 and (i % 10 == 0 or i == STEPS - 1):
            print(f"step {i:3d}  loss {losses[-1]:.4f}", flush=True)
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: a 1x1 NCCL grid) or cpu (a 2x4 gloo grid)")
    args = ap.parse_args()
    t0 = time.time()
    if args.device is not None and torch.device(args.device).type == "cpu":
        losses = run_gloo(train, 1, 2, 4, ("cpu",))[0]
        grid = "2x4 gloo"
    else:
        device_for_rank(args.device)  # raises without a card
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "s"), 1),
                                    rank=0, world_size=1)
            try:
                losses = train(GridGroups(1, 1, 1), args.device)
            finally:
                dist.destroy_process_group()
        grid = "1x1 NCCL"
    print(f"{time.time() - t0:.1f}s — node classification on R-MAT scale 10 with 2-D "
          f"distributed message passing on a {grid} grid")
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])


if __name__ == "__main__":
    main()
