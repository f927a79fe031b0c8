"""Optimizers and schedules (port of ``repro/optim``)."""
from .optimizers import Optimizer, adamw, lars, sgd
from .schedules import (Schedule, constant, cosine_warmup, scale_lr_sqrt_p,
                        step_decay)

__all__ = ["Optimizer", "sgd", "adamw", "lars", "Schedule", "constant",
           "step_decay", "cosine_warmup", "scale_lr_sqrt_p"]
