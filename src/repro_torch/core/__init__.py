"""Exact betweenness centrality (MGBC), ported to PyTorch: on one device
and on the paper's 2-D decomposed grid of devices.

  operators.py    operator layer — dense / sparse / fused-kernel level
                  steps, and the 2-D operators (expand → local → fold)
  engine.py       engine layer — the forward/backward level loops
  driver.py       driver layer — traversal_round + the BCDriver round loop
  bc.py           single-device entry point
  distributed.py  2-D decomposed entry point (torch.distributed, sub-clusters)
  scheduler.py    source rounds
  heuristics/     1-degree reduction and 2-degree DMF
  brandes_ref.py  numpy oracle (Algorithm 1)
"""
from .bc import ENGINE_KINDS, BCResult, betweenness_centrality
from .brandes_ref import brandes_reference

__all__ = ["ENGINE_KINDS", "BCResult", "betweenness_centrality", "brandes_reference"]
