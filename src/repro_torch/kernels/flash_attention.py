"""Blocked causal / sliding-window attention with an online softmax.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``). On CUDA
tensors the wrapper launches the hand-written kernel of
``csrc/flash_attention.cu``: each input read in its own dtype, the
reference's fp32 products computed exactly on Hopper's tensor cores
(``wgmma``) by splitting fp32 operands into bf16 pieces, an online softmax
over 64-key tiles, whole tiles skipped by the reference's liveness rule. On
CPU tensors it runs the plain version ``kernels.ref.attention_ref`` (dense
scores). There is no fallback between the two. The kernel's sums run in
another order than the dense plain version's, so the two agree to a
tolerance, not bit for bit. Like the reference's kernel it is forward-only:
a call that autograd would record raises. Launches count on ``launches``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention", "launches", "MAX_HEAD_DIM"]

launches = _build.Launches()
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 4}


def _launch(q, k, v, *, causal, window, scale) -> torch.Tensor:
    if any(t.dtype not in _DTYPE_CODES for t in (q, k, v)):
        raise TypeError(f"the kernel takes {[str(d) for d in _DTYPE_CODES]}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    B, H, S, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _build.kernel("flash_attention")(
        *(_DTYPE_CODES[t.dtype] for t in (q, k, v)), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, k.shape[2], d, float(scale), int(causal),
        int(window is not None), 0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    launches.count += 1
    _build.check_launch("flash_attention", rc)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q (B,H,S,d), k/v (B,H,T,d) -> (B,H,S,d) of ``q.dtype``; full heads
    (repeat GQA beforehand). The reference's contract holds:
    ``min(block_q, S)`` divides S and ``min(block_k, T)`` divides T
    (``ValueError`` otherwise). The Hopper kernel tiles by 64 whatever the
    blocks, and skips tiles by the same rule at that size, which changes
    nothing but the order of the sums."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, S, d)")
    B, H, S, d = q.shape
    T = k.shape[2] if k.dim() == 4 else -1
    if tuple(k.shape) != (B, H, T, d) or tuple(v.shape) != (B, H, T, d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, H, T, d) for q {tuple(q.shape)}")
    bq, bk = min(block_q, S), min(block_k, T)
    if bq < 1 or bk < 1 or S % bq or T % bk:
        raise ValueError(f"S={S}, block_q={bq}, T={T}, block_k={bk}: the "
                         f"blocks must divide the lengths")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _build.forward_only("flash_attention", q, k, v)
    if q.is_cuda:
        return _launch(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    raise ValueError(f"unsupported device {q.device}")
