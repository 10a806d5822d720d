"""Entry points of the port: the BC command line (``python -m
repro_torch.launch.bc``) and the DLRM cell programs (``steps``)."""
