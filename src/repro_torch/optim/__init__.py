"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, adamw, sgd
from repro_torch.optim.schedule import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "sgd",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
