"""Mamba selective scan ``h_t = dA_t * h_{t-1} + dBx_t`` along axis 1.

Port of ``repro/kernels/ssm_scan.py`` (``ssm_scan_chunked``). On a CUDA
tensor the wrapper launches the hand-written kernel of ``csrc/ssm_scan.cu``
(one thread per (b, d, n) state element walking all of S, so it takes any S
and D); on a CPU tensor it runs the plain version ``kernels.ref.ssm_scan_ref``
(the same multiply and add per step, each rounded). There is no fallback
between the two. Like the reference's kernel it is forward-only: a call that
autograd would record raises. Launches count on ``launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import ssm_scan_ref

__all__ = ["ssm_scan_chunked", "launches"]

launches = _build.Launches()


def _launch(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    if dBx.device != dA.device:
        raise ValueError(f"dA on {dA.device}, dBx on {dBx.device}")
    dA, dBx = dA.contiguous(), dBx.contiguous()
    h = torch.empty_like(dA)
    if h.numel() == 0:
        return h
    B, S, D, N = dA.shape
    rc = _build.kernel("ssm_scan")(
        dA.data_ptr(), dBx.data_ptr(), h.data_ptr(), B, S, D * N,
        torch.cuda.current_stream(dA.device).cuda_stream)
    launches.count += 1
    _build.check_launch("ssm_scan", rc)
    return h


def ssm_scan_chunked(dA: torch.Tensor, dBx: torch.Tensor, *,
                     chunk: Optional[int] = 128,
                     block_d: Optional[int] = 256) -> torch.Tensor:
    """dA, dBx: (B, S, D, N) float32 -> h (B, S, D, N), with the reference's
    contract: ``min(chunk, S)`` divides S and ``min(block_d, D)`` divides D
    (``ValueError`` otherwise). The Hopper kernel does not tile S or D, so
    the two only keep that contract; ``None`` takes the whole axis as one
    chunk or block, which is how ``ops.ssm_scan`` calls it."""
    if dA.dim() != 4 or dA.shape != dBx.shape:
        raise ValueError(f"dA {tuple(dA.shape)} and dBx {tuple(dBx.shape)} "
                         f"must both be (B, S, D, N)")
    _, S, D, _ = dA.shape
    ch = max(min(S if chunk is None else chunk, S), 1)
    bd = max(min(D if block_d is None else block_d, D), 1)
    if S % ch or D % bd:
        raise ValueError(f"S={S} is not a multiple of chunk={ch} or D={D} "
                         f"of block_d={bd}")
    if dA.dtype != torch.float32 or dBx.dtype != torch.float32:
        raise TypeError(f"the scan takes float32, got {dA.dtype}, {dBx.dtype}")
    _build.forward_only("ssm_scan", dA, dBx)
    if dA.is_cuda:
        return _launch(dA, dBx)
    if dA.device.type == "cpu":
        return ssm_scan_ref(dA, dBx)
    raise ValueError(f"unsupported device {dA.device}")
