"""Deprecated alias of :mod:`repro_torch.launch.serve_lm` (the LM decoder).

The JAX package's ``launch.serve`` historically named its LM serving
launcher; the BC snapshot-serving front end (``launch.serve_bc``) made
the bare name ambiguous, so the LM launcher is ``serve_lm``.  This shim
keeps ``python -m repro_torch.launch.serve`` working, with the same
warning as the JAX package's.
"""
from __future__ import annotations

import warnings

from .serve_lm import main, serve_loop

__all__ = ["main", "serve_loop"]

warnings.warn(
    "repro_torch.launch.serve is deprecated: the LM serving launcher moved to "
    "repro_torch.launch.serve_lm (BC snapshot serving lives in "
    "repro_torch.launch.serve_bc)",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    main()
