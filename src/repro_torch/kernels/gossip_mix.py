"""Gossip arrival mix ``out = cast_a((1-alpha)*f32(a) + alpha*f32(b))``.

Port of ``repro/kernels/gossip_mix.py`` (``gossip_mix_2d``,
``gossip_mix_1d``). On a CUDA tensor the wrappers launch the hand-written
kernel ``csrc/gossip_mix.cu`` in place over ``a`` (the reference aliases its
output onto ``a``); on a CPU tensor they run ``gossip_mix_plain``, the same
arithmetic as separate PyTorch ops. There is no fallback between the two: a
CUDA tensor gets the kernel or an exception.

``alpha`` is a Python float (static) or a 0-d tensor (traced, the
masked-alpha path). ``mix_weights`` turns either into the two fp32
coefficients exactly as the reference forms them, so the kernel and the
plain version multiply by the same numbers. A tensor alpha is read on the
host (a device sync when it lives on the card).

``gossip_mix_q2d`` (quantized wire) is not ported yet (ROADMAP B.3).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

__all__ = ["LANE", "mix_weights", "gossip_mix_plain", "gossip_mix_2d",
           "gossip_mix_1d", "launches"]

LANE = 128

launches = _build.Launches()


def mix_weights(alpha) -> tuple[float, float]:
    """(1 - alpha, alpha) as the fp32 values the reference multiplies by: a
    static alpha rounds ``1.0 - alpha`` from a double (JAX's weak-typed
    scalar), a traced alpha subtracts in fp32."""
    if isinstance(alpha, torch.Tensor):
        a = np.float32(alpha.item())
        return float(np.float32(1.0) - a), float(a)
    return float(np.float32(1.0 - float(alpha))), float(np.float32(alpha))


def gossip_mix_plain(a: torch.Tensor, b: torch.Tensor, alpha=0.5) -> torch.Tensor:
    """The mix as plain PyTorch ops (separate mul and add, no lerp), out of
    place. ``b`` may be narrower than ``a``; both are promoted to fp32."""
    keep, take = mix_weights(alpha)
    return (a.float() * keep + b.float() * take).to(a.dtype)


def _launch(a: torch.Tensor, b: torch.Tensor, alpha) -> None:
    if b.dtype != a.dtype:
        raise TypeError(f"kernel mixes equal dtypes, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gossip_mix kernel needs contiguous buffers")
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.numel() == 0:
        return
    keep, take = mix_weights(alpha)
    fn = _build.kernel("gossip_mix")
    rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), b.data_ptr(), a.numel(),
            keep, take, torch.cuda.current_stream(a.device).cuda_stream)
    launches.count += 1
    _build.check_launch("gossip_mix", rc)


def gossip_mix_2d(a: torch.Tensor, b: torch.Tensor, alpha=0.5) -> torch.Tensor:
    """Mix two ``(M, N)`` buffers with ``N`` a multiple of LANE, in place
    over ``a``; returns ``a``."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.dim() != 2 or a.shape[1] % LANE:
        raise ValueError(f"last dim of {tuple(a.shape)} must be a multiple "
                         f"of {LANE}")
    return gossip_mix_1d(a, b, alpha)


def gossip_mix_1d(a: torch.Tensor, b: torch.Tensor, alpha=0.5) -> torch.Tensor:
    """Mix two same-shape buffers of any length, in place over ``a``;
    returns ``a``. The kernel takes the ragged tail in its masked edge, so a
    length that is not a LANE multiple is still one launch."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.is_cuda:
        _launch(a, b, alpha)
    elif a.device.type == "cpu":
        a.copy_(gossip_mix_plain(a, b, alpha))
    else:
        raise ValueError(f"unsupported device {a.device}")
    return a
