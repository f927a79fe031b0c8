"""Optimizers and schedules (port of ``repro/optim``)."""
from .optimizers import Optimizer, sgd
from .schedules import Schedule, constant, step_decay

__all__ = ["Optimizer", "sgd", "Schedule", "constant", "step_decay"]
