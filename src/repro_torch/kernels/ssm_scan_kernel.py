"""Mamba selective scan ``h_t = dA_t * h_{t-1} + dBx_t`` along axis 1.

Port of ``repro/kernels/ssm_scan.py`` (``ssm_scan_chunked``). On a CUDA
tensor the wrapper launches the hand-written kernel of ``csrc/ssm_scan.cu``
(one thread per (b, d, n) state element walking all of S, so it takes any S
and D); on a CPU tensor it runs the plain version ``kernels.ref.ssm_scan_ref``
(the same multiply and add per step, each rounded). There is no fallback
between the two. Like the reference's kernel it is forward-only: a call that
autograd would record raises. Launches count on ``launches``.

``ssm_scan_train`` (no reference counterpart: the reference's train path
lets XLA differentiate its jnp scan) is the same scan under autograd: a
``torch.autograd.Function`` whose forward launches ``csrc/ssm_scan.cu`` and
whose backward launches the adjoint kernel of ``csrc/ssm_scan_bwd.cu``, or
on a CPU tensor runs ``ssm_scan_ref`` and ``kernels.ref.ssm_scan_bwd_ref``.
Its launches count on ``train_launches`` (forward) and ``bwd_launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["ssm_scan_chunked", "ssm_scan_train", "launches",
           "train_launches", "bwd_launches"]

launches = _build.Launches()
train_launches = _build.Launches()
bwd_launches = _build.Launches()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(dA: torch.Tensor, dBx: torch.Tensor,
            count: _build.Launches = launches) -> torch.Tensor:
    if dBx.device != dA.device:
        raise ValueError(f"dA on {dA.device}, dBx on {dBx.device}")
    dA, dBx = dA.contiguous(), dBx.contiguous()
    h = torch.empty_like(dA)
    if h.numel() == 0:
        return h
    B, S, D, N = dA.shape
    rc = _build.kernel("ssm_scan")(
        dA.data_ptr(), dBx.data_ptr(), h.data_ptr(), B, S, D * N, _stream(dA))
    count.count += 1
    _build.check_launch("ssm_scan", rc)
    return h


def _launch_bwd(dA: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    dh = dh.contiguous()
    ddA, ddBx = torch.empty_like(dA), torch.empty_like(dA)
    if dA.numel() == 0:
        return ddA, ddBx
    B, S, D, N = dA.shape
    rc = _build.kernel("ssm_scan_bwd")(
        dA.data_ptr(), h.data_ptr(), dh.data_ptr(), ddA.data_ptr(),
        ddBx.data_ptr(), B, S, D * N, _stream(dA))
    bwd_launches.count += 1
    _build.check_launch("ssm_scan_bwd", rc)
    return ddA, ddBx


def _check(dA: torch.Tensor, dBx: torch.Tensor) -> None:
    if dA.dim() != 4 or dA.shape != dBx.shape:
        raise ValueError(f"dA {tuple(dA.shape)} and dBx {tuple(dBx.shape)} "
                         f"must both be (B, S, D, N)")
    if dA.dtype != torch.float32 or dBx.dtype != torch.float32:
        raise TypeError(f"the scan takes float32, got {dA.dtype}, {dBx.dtype}")


def _device(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"unsupported device {x.device}")


def ssm_scan_chunked(dA: torch.Tensor, dBx: torch.Tensor, *,
                     chunk: Optional[int] = 128,
                     block_d: Optional[int] = 256) -> torch.Tensor:
    """dA, dBx: (B, S, D, N) float32 -> h (B, S, D, N), with the reference's
    contract: ``min(chunk, S)`` divides S and ``min(block_d, D)`` divides D
    (``ValueError`` otherwise). The Hopper kernel does not tile S or D, so
    the two only keep that contract; ``None`` takes the whole axis as one
    chunk or block, which is how ``ops.ssm_scan`` calls it."""
    _check(dA, dBx)
    _, S, D, _ = dA.shape
    ch = max(min(S if chunk is None else chunk, S), 1)
    bd = max(min(D if block_d is None else block_d, D), 1)
    if S % ch or D % bd:
        raise ValueError(f"S={S} is not a multiple of chunk={ch} or D={D} "
                         f"of block_d={bd}")
    _build.forward_only("ssm_scan", dA, dBx)
    if _device(dA) == "cuda":
        return _launch(dA, dBx)
    return ssm_scan_ref(dA, dBx)


class _ScanTrain(torch.autograd.Function):
    """``(dA, dBx) -> h``; saves ``dA`` and ``h``, which the Mamba mixer's
    ``exp_`` and read-out keep alive anyway."""

    @staticmethod
    def forward(ctx, dA, dBx):
        if _device(dA) == "cuda":
            h = _launch(dA, dBx, train_launches)
        else:
            h = ssm_scan_ref(dA, dBx)
        ctx.save_for_backward(dA, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        dA, h = ctx.saved_tensors
        if dA.is_cuda:
            return _launch_bwd(dA, h, dh)
        return ssm_scan_bwd_ref(dA, h, dh)


def ssm_scan_train(dA: torch.Tensor, dBx: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, S, D, N) float32 scan -> h, from a zero state, in
    fp32 throughout: forward ``ssm_scan_ref``'s order, backward
    ``ssm_scan_bwd_ref``'s, each the CUDA kernel on a CUDA tensor (one
    launch each way, counted on ``train_launches`` and ``bwd_launches``)
    and the plain loop on a CPU tensor. Any S and D."""
    _check(dA, dBx)
    if dBx.device != dA.device:
        raise ValueError(f"dA on {dA.device}, dBx on {dBx.device}")
    return _ScanTrain.apply(dA.contiguous(), dBx.contiguous())
