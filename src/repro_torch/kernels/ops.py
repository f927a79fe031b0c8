"""Bucket-level wrappers the engines call.

Port of ``repro/kernels/ops.py`` (``gossip_mix_bucket``,
``fused_sgd_bucket``). The dispatch rule is the tensor's device and nothing
else: a CPU tensor gets the plain PyTorch version, a CUDA tensor gets the
hand-written kernel or an exception. There is no ``impl`` override, no
capability check and no fallback. Each kernel keeps its launch count on its
module (``gossip_mix.launches``, ``fused_update.launches``).
"""
from __future__ import annotations

import torch

from .fused_update import fused_sgd_1d
from .gossip_mix import LANE, gossip_mix_1d

__all__ = ["gossip_mix_bucket", "fused_sgd_bucket"]


def _check_bucket(x: torch.Tensor) -> None:
    if x.shape[-1] % LANE:
        raise ValueError(f"bucket {tuple(x.shape)} is not LANE-aligned")


def gossip_mix_bucket(a: torch.Tensor, b: torch.Tensor,
                      alpha=0.5) -> torch.Tensor:
    """Mix one persistent gossip bucket in place (any leading axes, e.g. the
    replica axis, over the LANE-aligned flat dim): one kernel launch for the
    whole replica-stacked bucket. Returns ``a``."""
    _check_bucket(a)
    return gossip_mix_1d(a, b, alpha)


def fused_sgd_bucket(p, g, partner, mom, *, lr, alpha=0.5, momentum=0.9,
                     weight_decay=0.0):
    """Single-sweep fused mix+SGD over one bucket, in place over ``p`` and
    ``mom`` (one launch for the replica-stacked bucket). Returns
    ``(p, mom)``."""
    _check_bucket(p)
    return fused_sgd_1d(p, g, partner, mom, lr=lr, alpha=alpha,
                        momentum=momentum, weight_decay=weight_decay)
