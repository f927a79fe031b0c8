"""Mamba-1 selective SSM mixer, the full-sequence path (falcon-mamba
[arXiv:2410.05355]).

Port of ``repro/models/mamba.py`` (``mamba_init``, ``_conv_causal``,
``_ssm_inputs``, ``ssm_assoc_scan``, ``ssm_scan_ref``, ``mamba_apply``).
Activations carry the replica axis first, ``(dp, b, S, d)``, against
weights ``(dp, ...)``; a scan implementation sees ``(dp * b, S, D, N)``.
``mamba_apply``'s default scan is ``ssm_assoc_scan``, a log-depth scan in
plain PyTorch that autograd differentiates (the train path); the scoring
path passes ``scan_impl=repro_torch.kernels.ssm_scan``, the CUDA kernel,
which is forward-only as the reference's Pallas kernel is.

The decode path (``mamba_decode``, ``mamba_state_init``) and the chunked jnp
scan wait for serving and long-sequence training (ROADMAP A.13, A.14).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.ref import ssm_scan_ref

from .config import SSMSpec
from .layers import Param, dense_param, per_replica, replica_matmul, silu

__all__ = ["mamba_init", "mamba_apply", "ssm_scan_ref", "ssm_assoc_scan"]


def mamba_init(d_model: int, spec: SSMSpec, dtype=torch.float32) -> Dict:
    d_in = spec.expand * d_model
    dt_rank = spec.resolved_dt_rank(d_model)
    return {
        "in_proj": dense_param(d_model, (2 * d_in,), "embed", ("inner",),
                               dtype=dtype),
        "conv_w": Param((spec.d_conv, d_in), (None, "inner"),
                        scale=1.0 / math.sqrt(spec.d_conv), dtype=dtype),
        "conv_b": Param((d_in,), ("inner",), init="zeros", dtype=dtype),
        "x_proj": dense_param(d_in, (dt_rank + 2 * spec.d_state,), "inner",
                              (None,), dtype=dtype),
        "dt_proj": dense_param(dt_rank, (d_in,), None, ("inner",),
                               dtype=dtype),
        "dt_bias": Param((d_in,), ("inner",), init="dt_bias", dtype=dtype),
        "A_log": Param((d_in, spec.d_state), ("inner", None), init="A_log",
                       dtype=dtype),
        "D": Param((d_in,), ("inner",), init="ones", dtype=dtype),
        "out_proj": dense_param(d_in, (d_model,), "inner", ("embed",),
                                dtype=dtype),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv with zero left padding: x (dp, b, S, Di),
    w (dp, K, Di), b (dp, Di). A Python sum over the K taps, then the bias,
    as the reference sums."""
    K, S = w.shape[1], x.shape[2]
    tail = x.new_zeros(x.shape[:2] + (K - 1, x.shape[3]))
    xp = torch.cat([tail, x], dim=2)
    out = sum(xp[:, :, k:k + S] * per_replica(w[:, k], 4) for k in range(K))
    return out + per_replica(b, 4)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)`` (torch's ``softplus``
    switches to the identity above a threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(p, spec: SSMSpec, x: torch.Tensor, dt_rank: int):
    """dA, dBx (dp, b, S, Di, N) in fp32 and C (dp, b, S, N) for x
    (dp, b, S, Di), formed as the reference forms them."""
    dbc = replica_matmul(x, p["x_proj"])
    dt = _softplus(replica_matmul(dbc[..., :dt_rank], p["dt_proj"])
                   + per_replica(p["dt_bias"], 4))
    B = dbc[..., dt_rank:dt_rank + spec.d_state]
    C = dbc[..., dt_rank + spec.d_state:]
    A = -torch.exp(p["A_log"].float())                        # (dp, Di, N)
    # exp in place: the product is saved by nothing, and at falcon-mamba
    # width each of these buffers is 4.3 GB
    dA = (dt[..., None].float() * per_replica(A, 5)).exp_()
    dBx = (dt * x)[..., None].float() * B[..., None, :].float()
    return dA, dBx, C


def _combine(a1, b1, a2, b2):
    """(a1, b1) then (a2, b2): h -> a2 * (a1 * h + b1) + b2."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (``even`` is as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _assoc(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` along axis 1 with the recursion of
    ``jax.lax.associative_scan``: combine neighbours, scan the half, fill
    in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc(*_combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                              a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def ssm_assoc_scan(dA: torch.Tensor, dBx: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = dA_t * h_{t-1} + dBx_t along axis 1, by a log-depth
    associative scan in plain PyTorch (differentiable)."""
    if h0 is not None:
        dBx = torch.cat([dBx[:, :1] + dA[:, :1] * h0[:, None], dBx[:, 1:]],
                        dim=1)
    return _assoc(dA, dBx)[1]


def mamba_apply(p, spec: SSMSpec, d_model: int, x: torch.Tensor,
                scan_impl=None) -> torch.Tensor:
    """Full-sequence mixer over x (dp, b, S, d). ``scan_impl(dA, dBx) -> h``
    on (dp * b, S, Di, N) overrides the associative scan (e.g. the CUDA
    kernel ``repro_torch.kernels.ssm_scan``)."""
    dt_rank = spec.resolved_dt_rank(d_model)
    xz = replica_matmul(x, p["in_proj"])
    xi, z = xz.chunk(2, dim=-1)
    xi = silu(_conv_causal(xi, p["conv_w"], p["conv_b"]))
    dA, dBx, C = _ssm_inputs(p, spec, xi, dt_rank)
    shape = dA.shape
    h = (scan_impl or ssm_assoc_scan)(dA.flatten(0, 1), dBx.flatten(0, 1))
    del dA, dBx  # under no_grad the scan's inputs are freed here
    h = h.view(shape)
    y = torch.einsum("rbsdn,rbsn->rbsd", h, C.float()).to(x.dtype)
    del h
    y = y + per_replica(p["D"], 4) * xi
    y = y * silu(z)
    return replica_matmul(y, p["out_proj"])
