"""Learning-rate schedules, evaluated on the host in float32.

Port of ``repro/optim/schedules.py`` (``constant``, ``step_decay``). The
reference evaluates its schedules on the traced int32 step in float32; here
the step counter lives on the host, so a schedule maps a Python int to the
same float32 value with numpy float32 arithmetic in the reference's op order
(never a Python double), returned as a Python float that is exactly that
float32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

__all__ = ["Schedule", "constant", "step_decay"]


def constant(lr: float) -> Schedule:
    v = float(np.float32(lr))
    return lambda step: v


def step_decay(lr: float, decay: float = 0.1, every: int = 30) -> Schedule:
    """lr * decay^(step // every) — the paper's ResNet-50 step regimen."""
    def fn(step: int) -> float:
        k = np.float32(int(step) // every)
        return float(np.float32(lr) * np.power(np.float32(decay), k))
    return fn
