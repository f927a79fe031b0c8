"""Mamba-1 selective SSM mixer (falcon-mamba [arXiv:2410.05355]): the
full-sequence path and the one-token decode path.

Port of ``repro/models/mamba.py`` (``mamba_init``, ``_conv_causal``,
``_ssm_inputs``, ``ssm_assoc_scan``, ``ssm_scan_chunked_jnp`` as
``ssm_scan_chunked_torch``, ``ssm_scan_ref``, ``mamba_apply``,
``mamba_state_init``, ``mamba_decode``).
Activations carry the replica axis first, ``(dp, b, S, d)``, against
weights ``(dp, ...)``; a scan implementation sees ``(dp * b, S, D, N)``.
``mamba_apply``'s default scan is ``ssm_assoc_scan``, a log-depth scan in
plain PyTorch that autograd differentiates (the train path);
``ssm_scan_chunked_torch`` is the same scan chunk by chunk, the reference's
long-sequence train scan (on the card, ``kernels.ssm_scan_train``'s forward
and adjoint kernels); the scoring path passes
``scan_impl=repro_torch.kernels.ssm_scan``, the CUDA kernel, which is
forward-only as the reference's Pallas kernel is.

``SSMSpec.bcdt_norm`` adds RMSNorms on dt, B and C between ``x_proj`` and
their uses (Jamba's weighted ones, Falcon Mamba's weightless ones), on
every path: train, prefill and decode all form the scan's inputs in
``_ssm_inputs``.

Decode carries O(1) state per layer: ``h`` (b, d_inner, d_state) in fp32
and ``conv``, the last ``d_conv - 1`` pre-conv inputs (b, d_conv - 1,
d_inner) in the param dtype; ``mamba_decode`` writes both in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan_kernel import ssm_scan_train

from .config import SSMSpec
from .layers import (Param, dense_param, norm_apply, per_replica,
                     replica_matmul, silu)

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "mamba_state_init",
           "ssm_scan_ref", "ssm_assoc_scan", "ssm_scan_chunked_torch"]


BCDT_NORMS = (None, "weighted", "weightless")


def mamba_init(d_model: int, spec: SSMSpec, dtype=torch.float32) -> Dict:
    """The mixer's params; under ``bcdt_norm="weighted"`` also the scales
    of the norms on dt, B and C (``dt_norm``, ``b_norm``, ``c_norm``)."""
    if spec.bcdt_norm not in BCDT_NORMS:
        raise ValueError(f"bcdt_norm {spec.bcdt_norm!r}: want one of "
                         f"{BCDT_NORMS}")
    d_in = spec.expand * d_model
    dt_rank = spec.resolved_dt_rank(d_model)
    p = {
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
    if spec.bcdt_norm == "weighted":
        for name, n in (("dt_norm", dt_rank), ("b_norm", spec.d_state),
                        ("c_norm", spec.d_state)):
            p[name] = Param((n,), (None,), init="ones", dtype=dtype)
    return p


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
    (dp, b, S, Di), formed as the reference forms them; under
    ``spec.bcdt_norm`` dt's low-rank input, B and C normalized first."""
    dbc = replica_matmul(x, p["x_proj"])
    dt_low = dbc[..., :dt_rank]
    B = dbc[..., dt_rank:dt_rank + spec.d_state]
    C = dbc[..., dt_rank + spec.d_state:]
    if spec.bcdt_norm is not None:   # layers.norm_apply's RMSNorm
        weighted = spec.bcdt_norm == "weighted"
        dt_low, B, C = (norm_apply("rms", {"scale": p[k]} if weighted
                                   else {}, v)
                        for v, k in ((dt_low, "dt_norm"), (B, "b_norm"),
                                     (C, "c_norm")))
    dt = _softplus(replica_matmul(dt_low, p["dt_proj"])
                   + per_replica(p["dt_bias"], 4))
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


def ssm_scan_chunked_torch(dA: torch.Tensor, dBx: torch.Tensor,
                           chunk: int = 256) -> torch.Tensor:
    """The reference's ``ssm_scan_chunked_jnp``, differentiable.

    On CUDA tensors it is ``kernels.ssm_scan_train``: the hand-written
    forward and adjoint kernels, fp32 in the sequential order of
    ``ssm_scan_ref``, over the whole sequence at once; ``chunk`` then only
    keeps the reference's contract, as ``ssm_scan_chunked``'s tile sizes do.
    On other tensors it is the reference's algorithm in plain PyTorch: a
    loop over S / chunk chunks carrying the state ``h``, the associative
    scan only within a chunk (``ssm_assoc_scan(a, b, h0=h)``, the body of
    the reference's ``lax.scan``, from a zero state); the associative scan
    over the whole sequence when ``S % chunk`` or ``S <= chunk``, as the
    reference."""
    if dA.is_cuda:
        return ssm_scan_train(dA, dBx)
    B, S, D, N = dA.shape
    if S % chunk or S <= chunk:
        return ssm_assoc_scan(dA, dBx)
    h = dA.new_zeros((B, D, N))
    hs = []
    for c in range(0, S, chunk):
        hc = ssm_assoc_scan(dA[:, c:c + chunk], dBx[:, c:c + chunk], h0=h)
        hs.append(hc)
        # a copy: the next chunk's autograd then keeps (B, D, N), not hc
        h = hc[:, -1].clone()
    return torch.cat(hs, dim=1)


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


def mamba_state_init(spec: SSMSpec, d_model: int, batch: int, dtype, *,
                     device) -> Dict:
    d_in = spec.expand * d_model
    return {"h": torch.zeros((batch, d_in, spec.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, spec.d_conv - 1, d_in), dtype=dtype,
                                device=device)}


def mamba_decode(p, spec: SSMSpec, d_model: int, x1: torch.Tensor,
                 state: Dict):
    """One-token recurrent step. x1 (dp, b, 1, d); state leaves (dp, b, ...)
    written in place. Returns (y (dp, b, 1, d), state)."""
    if state["conv"].shape[2] != spec.d_conv - 1:
        # a prefill prompt shorter than d_conv - 1 leaves a short tail; the
        # reference's decode then fails on its conv einsum likewise
        raise ValueError(f"conv state holds {state['conv'].shape[2]} inputs, "
                         f"decode needs d_conv - 1 = {spec.d_conv - 1}")
    dt_rank = spec.resolved_dt_rank(d_model)
    xz = replica_matmul(x1, p["in_proj"])
    xi, z = xz.chunk(2, dim=-1)
    conv_in = torch.cat([state["conv"], xi], dim=2)             # (dp,b,K,Di)
    xi = silu(torch.einsum("rbkd,rkd->rbd", conv_in, p["conv_w"])
              + per_replica(p["conv_b"], 3))[:, :, None]
    dA, dBx, C = _ssm_inputs(p, spec, xi, dt_rank)
    h = dA[:, :, 0] * state["h"] + dBx[:, :, 0]                 # (dp,b,Di,N)
    y = torch.einsum("rbdn,rbn->rbd", h, C[:, :, 0].float()).to(
        x1.dtype)[:, :, None]
    y = y + per_replica(p["D"], 4) * xi
    y = y * silu(z)
    state["h"].copy_(h)
    state["conv"].copy_(conv_in[:, :, 1:])
    return replica_matmul(y, p["out_proj"]), state
