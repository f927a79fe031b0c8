"""``lr * decay^(step // every)`` in float32: GossipGraD's ResNet-50 step
regimen."""
from __future__ import annotations

from typing import Dict

import numpy as np


def lr(args: Dict, step: int) -> float:
    k = np.float32(int(step) // int(args["every"]))
    return float(np.float32(args["lr"]) * np.power(np.float32(args["decay"]),
                                                    k))
