"""Optimizers and schedules (port of ``repro/optim``)."""
from .optimizers import Optimizer, adamw, lars, sgd
from .schedules import Schedule, constant, step_decay

__all__ = ["Optimizer", "sgd", "adamw", "lars", "Schedule", "constant",
           "step_decay"]
