"""Rotary position embeddings, partial rotary included.

Port of ``repro/models/rotary.py`` (``rope_frequencies``, ``apply_rope``):
the same interleaved (even, odd) pair rotation, in the same op order.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(rot_dim: int, positions: torch.Tensor,
                     theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., rot_dim/2) for integer positions (...,)."""
    assert rot_dim % 2 == 0
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int | None = None) -> torch.Tensor:
    """Rotate the first ``rot_dim`` features of x (..., S, H, head_dim);
    cos/sin are (..., S, rot_dim/2) and broadcast over the head axis."""
    hd = x.shape[-1]
    if rot_dim is None:
        rot_dim = hd
    if rot_dim == 0:
        return x
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if rot_dim < hd else yr
