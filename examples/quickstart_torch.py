"""Quickstart of the PyTorch/CUDA port: exact betweenness centrality, then
a run killed half way and resumed from its checkpoint.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import betweenness_centrality, brandes_reference
from repro_torch.distributed import BCCheckpoint
from repro_torch.graphs import road_like_graph
from repro_torch.serving import BlockBudgetStop

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
device = ap.parse_args().device

# a road-network-like graph: long diameter, many 1-/2-degree vertices
graph = road_like_graph(10, 10, spur_fraction=0.5, seed=7)
print(f"graph: n={graph.n} vertices, m={graph.num_edges} edges")

# MGBC with all heuristics (H3 = 1-degree reduction + 2-degree DMF) on the
# fused CUDA level kernels (their plain PyTorch versions on the CPU)
result = betweenness_centrality(graph, batch_size=32, heuristics="h3", engine_kind="fused",
                                device=device)
print(
    f"rounds: {result.rounds_run}; forward BFS columns: "
    f"{result.forward_columns} (of {graph.n} vertices — the rest were "
    f"handled by the heuristics)"
)
top = np.argsort(result.bc)[::-1][:5]
for v in top:
    print(f"  vertex {int(v):4d}   BC = {result.bc[int(v)]:9.1f}")

# exactness: identical to the textbook Brandes oracle
np.testing.assert_allclose(result.bc, brandes_reference(graph), rtol=1e-5, atol=1e-5)
print("matches Brandes oracle ✓")

# durability: a run stopped after 2 dispatch blocks (as a killed job would
# be) leaves its committed rounds in the checkpoint; a fresh call on the
# same file runs only the rest and gives the same scores
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "bc.npz")
    kw = dict(batch_size=8, engine_kind="fused", sampling="fixed", sample_frac=1.0,
              device=device)
    first = betweenness_centrality(graph, checkpoint=BCCheckpoint(path),
                                   stop_rule=BlockBudgetStop(2), **kw)
    rest = betweenness_centrality(graph, checkpoint=BCCheckpoint(path), **kw)
    print(f"killed after {first.rounds_run} rounds; the resumed call ran the other "
          f"{rest.rounds_run} (generation {rest.recovery_stats['resumed_generation']})")
    np.testing.assert_allclose(rest.bc, brandes_reference(graph), rtol=1e-5, atol=1e-5)
    print("resumed run matches Brandes oracle ✓")
