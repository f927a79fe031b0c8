"""Blocked causal / sliding-window attention with an online softmax.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention``). On CUDA
tensors the wrapper launches the hand-written kernel of
``csrc/flash_attention.cu``: each input read in its own dtype, the
reference's fp32 products computed exactly on Hopper's tensor cores
(``wgmma``) by splitting fp32 operands into bf16 pieces, an online softmax
over 64-key tiles, whole tiles skipped by the reference's liveness rule. On
CPU tensors it runs the plain version ``flash_attention_plain`` (dense
scores). There is no fallback between the two. The kernel's sums run in
another order than the dense plain version's, so the two agree to a
tolerance, not bit for bit. Like the reference's kernel it is forward-only:
a call that autograd would record raises. Launches count on ``launches``.

A query row with no admissible key (a window, and S > T + window - 1)
gets what the reference's blocked kernel gives it: each key of a live tile
counts with p = 1, so the row's output is the mean of v over the keys of
the tiles live for its ``(min(block_q, S), min(block_k, T))`` query block,
and 0 where none is. That depends on the blocks; the reference's own dense
``attention_ref`` gives the mean over all T keys instead. Both versions here
follow the blocked kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "launches",
           "MAX_HEAD_DIM"]

launches = _build.Launches()
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 4}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """The kernel's plain version: dense ``attention_ref`` for every row
    that has an admissible key; a row that has none gets the mean of v over
    the keys of the ``(bq, bk)`` tiles that the reference's liveness rule
    (``src/repro/kernels/flash_attention.py:43-48``) finds live for its
    query block, 0 where none is (the reference's ``acc / max(l, 1e-30)``
    with p = 1 on every key of a live tile)."""
    out = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if window is None:   # key 0 (causal) or every key is admissible
        return out
    S, T, dev = q.shape[2], k.shape[2], q.device
    bq, bk = min(block_q, S), min(block_k, T)
    qi = torch.arange(S, device=dev)[:, None]
    kj = torch.arange(T, device=dev)[None, :]
    admissible = (qi - kj) < window
    if causal:
        admissible &= kj <= qi
    empty = ~admissible.any(1)
    if not bool(empty.any()):
        return out
    q0 = torch.arange(0, S, bq, device=dev)[:, None]
    k0 = torch.arange(0, T, bk, device=dev)[None, :]
    live = k0 + bk - 1 >= q0 - window + 1
    if causal:
        live &= k0 <= q0 + bq - 1
    B, H, _, d = v.shape
    tiles = v.float().reshape(B, H, T // bk, bk, d).sum(3)
    acc = torch.einsum("qt,bhtd->bhqd", live.float(), tiles)
    keys = live.sum(1).float() * bk
    mean = acc / keys.clamp(min=1e-30)[:, None]
    rows = mean[:, :, torch.arange(S, device=dev) // bq].to(out.dtype)
    return torch.where(empty[:, None], rows, out)


def _launch(q, k, v, *, causal, window, scale, bq, bk) -> torch.Tensor:
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
        k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, k.shape[2], d,
        float(scale), int(causal), int(window is not None),
        0 if window is None else int(window), bq, bk,
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
    (``ValueError`` otherwise). The Hopper kernel walks 64-key tiles
    whatever the blocks, skipping tiles by the reference's rule at that
    size: for a row with an admissible key that changes nothing but the
    order of the sums (a masked key's p is exp(-1e30 - m) = 0). A row with
    none takes the reference's blocks: the kernel writes it apart, as
    ``flash_attention_plain`` does."""
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
        return _launch(q, k, v, causal=causal, window=window, scale=scale,
                       bq=bq, bk=bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    raise ValueError(f"unsupported device {q.device}")
