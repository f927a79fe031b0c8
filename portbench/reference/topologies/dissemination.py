"""GossipGraD's dissemination schedule (section 4.4.2) with its random
relabelings (section 4.5.1), a frozen copy of the system under test's."""
from __future__ import annotations

import math

import numpy as np


def perms(p: int, rotations: int, seed: int) -> np.ndarray:
    """(rotations * ceil(log2 p), p) send-to rows: at sub-step k rank i
    sends to (i + 2^k) % p, each rotation under a relabeling sigma drawn
    from ``np.random.default_rng(seed).permutation`` (the first is the
    identity): i -> sigma^-1((sigma(i) + 2^k) % p)."""
    substeps = max(1, math.ceil(math.log2(p)))
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(rotations):
        sigma = np.arange(p) if r == 0 else rng.permutation(p)
        inv = np.empty_like(sigma)
        inv[sigma] = np.arange(p)
        for k in range(substeps):
            base = (np.arange(p) + 2 ** k) % p
            rows.append(inv[base[sigma]])
    return np.stack(rows)
