"""Hand-written optimizers and learning-rate schedules (the port of the
JAX package's ``optim``): ``torch.optim.Optimizer`` subclasses that
update in place, built by the reference's factory names with the
parameters first."""
from .optimizers import (
    Adafactor,
    AdamW,
    SGDMomentum,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgd_momentum,
)
from .schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "AdamW",
    "Adafactor",
    "SGDMomentum",
    "adamw",
    "adafactor",
    "sgd_momentum",
    "global_norm",
    "clip_by_global_norm",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
]
