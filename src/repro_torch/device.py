"""Device selection for the port's entry points.

``device=None`` means the CUDA card.  Without one, an entry point raises
unless the caller asked for the CPU explicitly: nothing quietly carries
on on the host.  On the card TF32 is switched off, because TF32 operands
round the exact integer path counts σ that every level step carries; and
cuBLAS may not reduce bf16 GEMMs in reduced precision (split-K partial
sums rounded to bf16), so that the LM's bf16 products accumulate in f32
to one rounding at the end, as the JAX package's do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (None → ``"cuda"``) and check it is usable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev
