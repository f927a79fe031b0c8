"""Learning-rate schedules, evaluated on the host in float32.

Port of ``repro/optim/schedules.py`` (``constant``, ``step_decay``,
``cosine_warmup``, ``scale_lr_sqrt_p``). The reference evaluates its
schedules on the traced int32 step in float32; here the step counter lives
on the host, so a schedule maps a Python int to the same float32 value with
numpy float32 arithmetic in the reference's op order (never a Python
double), returned as a Python float that is exactly that float32. A Python
constant beside a float32 value is rounded to float32 first, as JAX's weak
types round it.

The paper's baseline setup (§7.1) uses ``step_decay`` (ResNet-50's
regimen) and ``scale_lr_sqrt_p`` (LR x sqrt(p), the AGD baseline only).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]

__all__ = ["Schedule", "constant", "step_decay", "cosine_warmup",
           "scale_lr_sqrt_p"]

_F = np.float32


def constant(lr: float) -> Schedule:
    v = float(np.float32(lr))
    return lambda step: v


def step_decay(lr: float, decay: float = 0.1, every: int = 30) -> Schedule:
    """lr * decay^(step // every) — the paper's ResNet-50 step regimen."""
    def fn(step: int) -> float:
        k = np.float32(int(step) // every)
        return float(np.float32(lr) * np.power(np.float32(decay), k))
    return fn


def cosine_warmup(lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``lr`` over ``warmup`` steps, then a cosine decay
    to ``final_frac * lr`` at ``total``. numpy's float32 ``cos`` may differ
    from XLA's by an ulp or two."""
    def fn(step: int) -> float:
        s = _F(step)
        warm = _F(lr) * np.minimum(s / _F(max(warmup, 1)), _F(1.0))
        t = np.clip((s - _F(warmup)) / _F(max(total - warmup, 1)),
                    _F(0.0), _F(1.0))
        cos = (_F(final_frac * lr) + _F((1 - final_frac) * lr * 0.5)
               * (_F(1) + np.cos(_F(math.pi) * t)))
        return float(warm if s < _F(warmup) else cos)
    return fn


def scale_lr_sqrt_p(schedule: Schedule, p: int) -> Schedule:
    """Krizhevsky's weak-scaling rule for the AGD baseline (paper §7.1):
    the schedule times sqrt(p), the factor rounded to float32 first and the
    product rounded in float32."""
    s = _F(math.sqrt(max(p, 1)))
    return lambda step: float(_F(schedule(step)) * s)
