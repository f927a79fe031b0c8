"""Plain PyTorch versions of the forward-only kernels: dense attention and
the sequential selective scan, and of the scan's adjoint.

Port of ``repro/kernels/ref.py`` (``attention_ref``, ``ssm_scan_ref``; the
mix's twin lives in ``kernels/gossip_mix.py``). ``ssm_scan_ref`` is the
plain version of ``kernels/ssm_scan_kernel.py``'s forward kernel and
``ssm_scan_bwd_ref`` (no reference counterpart: XLA differentiates the
reference's scan) that of its backward kernel; ``attention_ref`` is that
of ``kernels/flash_attention.py`` for every query row that has an
admissible key (``flash_attention_plain`` adds the rows that have none).
The wrappers run them on CPU tensors, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card. The two forwards stay differentiable.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["attention_ref", "ssm_scan_ref", "ssm_scan_bwd_ref", "NEG_INF"]

NEG_INF = -1e30   # the reference's finite mask value, never -inf


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,d), k/v (B,H,T,d) — dense softmax attention in fp32, cast
    back to ``q.dtype``. Query i sees key j when j <= i (causal) and
    i - j < window (a window)."""
    S, d = q.shape[2], q.shape[3]
    T = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= (qi - kj) < window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)


def ssm_scan_ref(dA: torch.Tensor, dBx: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential scan ``h_t = dA_t * h_{t-1} + dBx_t`` over axis 1 of
    (B, S, D, N), from ``h0`` (zeros by default): one multiply and one add
    per step, each rounded, as the CUDA kernel computes them."""
    h = torch.zeros_like(dA[:, 0]) if h0 is None else h0
    out = torch.empty_like(dA)
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        out[:, t] = h
    return out


def ssm_scan_bwd_ref(dA: torch.Tensor, h: torch.Tensor,
                     dh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adjoint of ``ssm_scan_ref`` from a zero state: for the forward's
    ``dA`` and ``h`` and the gradient ``dh`` of every h_t, (B, S, D, N),
    walks ``g_t = dA_{t+1} * g_{t+1} + dh_t`` from ``g_S = 0`` and
    ``dA_S = 0`` down to t = 0 and returns ``(ddA, ddBx)`` with
    ``ddBx_t = g_t`` and ``ddA_t = g_t * h_{t-1}`` (``h_{-1} = 0``): the
    multiplies and the add each rounded, in the CUDA kernel's order."""
    ddA, ddBx = torch.empty_like(dA), torch.empty_like(dA)
    zero = torch.zeros_like(dh[:, 0])
    g, a_next = zero, zero
    for t in range(dA.shape[1] - 1, -1, -1):
        g = a_next * g + dh[:, t]
        ddBx[:, t] = g
        ddA[:, t] = g * (h[:, t - 1] if t else zero)
        a_next = dA[:, t]
    return ddA, ddBx
