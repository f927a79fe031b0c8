"""Gossip arrival mix ``out = cast_a((1-alpha)*f32(a) + alpha*f32(b))``.

Port of ``repro/kernels/gossip_mix.py`` (``gossip_mix_2d``,
``gossip_mix_1d``, ``gossip_mix_q2d``). On a CUDA tensor the wrappers launch
the hand-written kernels of ``csrc/gossip_mix.cu`` in place over ``a`` (the
reference aliases its output onto ``a``); on a CPU tensor they run the plain
versions, the same arithmetic as separate PyTorch ops. There is no fallback
between the two: a CUDA tensor gets the kernel or an exception.

* ``gossip_mix_1d`` / ``gossip_mix_2d``: a raw partner ``b``, of the
  bucket's dtype or narrower (a bf16 wire on an fp32 bucket), promoted to
  fp32 as the reference does. Launches count on ``launches``.
* ``gossip_mix_q2d``: the quantized wire. The partner is int8 or
  float8_e4m3fn codes ``q`` with one fp32 scale per 128-element tile ``s``,
  decoded in the same sweep as ``f32(q) * s`` before the mix. Launches
  count on ``q_launches``.

``alpha`` is a Python float (static) or an fp32 tensor on ``a``'s device
(traced, the masked-alpha path) of shape () or ``(a.shape[0],)``, one value
per replica row (the async ring's per-replica masked alpha). A static alpha
becomes two fp32 coefficients formed as the reference forms them; a tensor
alpha reaches the kernel as a device pointer and ``1 - alpha`` is formed in
fp32 there, so a tensor never crosses to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from .quantize import LANE, dequant_flat

__all__ = ["LANE", "mix_weights", "kernel_alpha", "gossip_mix_plain",
           "gossip_mix_q_plain", "gossip_mix_2d", "gossip_mix_1d",
           "gossip_mix_q2d", "launches", "q_launches"]

launches = _build.Launches()     # gossip_mix (raw partner)
q_launches = _build.Launches()   # gossip_mix_q (quantized partner)


def mix_weights(alpha, like: torch.Tensor | None = None):
    """(1 - alpha, alpha) as the fp32 values the reference multiplies by: a
    static alpha rounds ``1.0 - alpha`` from a double (JAX's weak-typed
    scalar) and gives floats; a tensor alpha subtracts in fp32 and gives
    tensors, a per-row alpha shaped to broadcast over ``like``'s rows."""
    if isinstance(alpha, torch.Tensor):
        a = alpha.to(torch.float32)
        if a.dim() and like is not None:
            a = a.reshape(a.shape + (1,) * (like.dim() - 1))
        return 1.0 - a, a
    return float(np.float32(1.0 - float(alpha))), float(np.float32(alpha))


def kernel_alpha(alpha, a: torch.Tensor):
    """The kernels' alpha arguments ``(keep, take, alpha_ptr, row_len,
    holder)``: static floats and a null pointer, or the tensor's device
    pointer with ``row_len`` 0 for shape () and ``a``'s row length for one
    alpha per row of ``a``. ``holder`` keeps a converted tensor alive."""
    if not isinstance(alpha, torch.Tensor):
        keep, take = mix_weights(alpha)
        return keep, take, None, 0, None
    if alpha.device != a.device:
        raise ValueError(f"alpha on {alpha.device}, buffer on {a.device}")
    al = alpha.to(torch.float32).contiguous()
    if al.dim() == 0:
        row_len = 0
    elif al.dim() == 1 and a.dim() >= 1 and al.shape[0] == a.shape[0]:
        row_len = a.numel() // max(a.shape[0], 1)
    else:
        raise ValueError(f"alpha of shape {tuple(al.shape)} is neither () "
                         f"nor one per row of {tuple(a.shape)}")
    return 1.0, 0.0, al.data_ptr(), row_len, al


def gossip_mix_plain(a: torch.Tensor, b: torch.Tensor, alpha=0.5) -> torch.Tensor:
    """The mix as plain PyTorch ops (separate mul and add, no lerp), out of
    place. ``b`` may be narrower than ``a``; both are promoted to fp32."""
    keep, take = mix_weights(alpha, a)
    return (a.float() * keep + b.float() * take).to(a.dtype)


def gossip_mix_q_plain(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       alpha=0.5) -> torch.Tensor:
    """The quantized-wire mix as plain PyTorch ops, out of place: decode
    ``f32(q) * s`` per tile, then the mix."""
    return gossip_mix_plain(a, dequant_flat(q, s), alpha)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous buffers")
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, partner on {b.device}")


def _launch(a: torch.Tensor, b: torch.Tensor, alpha) -> None:
    _check(a, b, "gossip_mix")
    if a.numel() == 0:
        return
    keep, take, al_ptr, row_len, _hold = kernel_alpha(alpha, a)
    fn = _build.kernel("gossip_mix")
    rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(b.dtype),
            a.data_ptr(), b.data_ptr(), a.numel(), keep, take, al_ptr,
            row_len, _stream(a))
    launches.count += 1
    _build.check_launch("gossip_mix", rc)


def _launch_q(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              alpha) -> None:
    _check(a, q, "gossip_mix_q")
    _check(a, s, "gossip_mix_q")
    if s.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {s.dtype}")
    if a.numel() == 0:
        return
    keep, take, al_ptr, row_len, _hold = kernel_alpha(alpha, a)
    fn = _build.kernel("gossip_mix_q")
    rc = fn(_build.dtype_code(a.dtype),
            _build.dtype_code(q.dtype, _build.CODE_DTYPES), a.data_ptr(),
            q.data_ptr(), s.data_ptr(), a.numel(), keep, take, al_ptr,
            row_len, _stream(a))
    q_launches.count += 1
    _build.check_launch("gossip_mix_q", rc)


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


def gossip_mix_q2d(a: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   alpha=0.5) -> torch.Tensor:
    """Quantized-wire mix of an ``(M, N)`` buffer, ``N`` a multiple of
    LANE, against codes ``q`` of the same shape and scales ``s`` of shape
    ``(M, N // LANE)``, in place over ``a``; returns ``a``."""
    if q.shape != a.shape or a.dim() != 2 or a.shape[1] % LANE:
        raise ValueError(f"codes {tuple(q.shape)} must match a LANE-aligned "
                         f"(M, N) buffer {tuple(a.shape)}")
    if tuple(s.shape) != (a.shape[0], a.shape[1] // LANE):
        raise ValueError(f"scales {tuple(s.shape)} for buffer "
                         f"{tuple(a.shape)}: one per (row, {LANE}) tile")
    if a.is_cuda:
        _launch_q(a, q, s, alpha)
    elif a.device.type == "cpu":
        a.copy_(gossip_mix_q_plain(a, q, s, alpha))
    else:
        raise ValueError(f"unsupported device {a.device}")
    return a
