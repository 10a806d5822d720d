"""Entry points of the port: the BC command line (``python -m
repro_torch.launch.bc``) and BC snapshot server (``serve_bc``), the LM
server (``serve_lm``; ``serve`` is its deprecated alias) and the cell
programs of every arch (``steps``)."""
