"""repro_torch — the PyTorch/CUDA port of the MGBC betweenness-centrality
system (Vella, Carbone & Bernaschi, arXiv:1602.00963).

The package mirrors the layout of the JAX package it was ported from
(``graphs/``, ``core/``, ``core/heuristics/``, ``kernels/``,
``roofline/``, ``serving/``, ``distributed/``, ``checkpoint/``, ``launch/``,
and for the DLRM recommender ``configs/``, ``data/``, ``models/``) so each
counterpart is easy to find, but it imports only ``torch``, ``numpy``
and the standard library.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the fused engines' level steps and the
DLRM embedding lookup are hand-written CUDA kernels (``kernels/csrc/``)
built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
