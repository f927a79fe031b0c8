"""Momentum SGD as the fused sweep computes it, in float32 whatever the
stored dtype: ``g += wd * p`` (the mixed weights), ``m = mu * m + g``,
``p -= lr * m``; weights and momentum stored in the parameter dtype."""
from __future__ import annotations

from typing import Dict

import torch

HELD = "mom"


def init(bucket: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"mom": torch.zeros_like(bucket)}


def update(p32, g32, state: Dict, *, lr: float, args: Dict):
    wd, mu = float(args.get("weight_decay", 0.0)), float(args["momentum"])
    if wd:
        g32 = g32 + wd * p32
    m32 = mu * state["mom"] + g32
    return p32 - lr * m32, {"mom": m32}


def first_gradient(x: torch.Tensor, args: Dict) -> torch.Tensor:
    """The momentum after one step from zero is the first gradient."""
    return x
