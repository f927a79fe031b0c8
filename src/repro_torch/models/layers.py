"""Shared layers: parameter specs, the RMS norm, the SwiGLU MLP, embedding.

Port of ``repro/models/layers.py`` (``Param``/``dense_param`` init rules,
``norm_init``/``norm_apply``, ``mlp_init``/``mlp_apply``, ``embed_init``,
``silu``, ``dtype_of``) for the kinds the dense attention and Mamba-1
families use: the layer norm, the parameter-free norm and the GELU MLP wait
for the families that need them (ROADMAP A.13). Init is split in two:
``*_init`` functions return ``ParamSpec`` trees (shape, dtype and the
reference's distribution), and ``draw`` makes a tensor of one from a
``torch.Generator`` (``models.transformer.lm_init`` draws the tree). The
draws cannot reproduce ``jax.random``'s bits; parity tests bridge the
reference's weights in (``checkpoint/bridge.py``).

Every weight carries a leading replica axis ``(dp, ...)`` and activations
are ``(dp, b, S, ...)``: the reference's ``vmap`` over replicas is written
out as a batch dimension.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ParamSpec", "Param", "draw", "dense_param", "dtype_of", "silu",
           "norm_init", "norm_apply", "mlp_init", "mlp_apply", "embed_init",
           "per_replica", "replica_matmul"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf before it is drawn (see ``draw`` for the kinds)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"  # "normal" | "ones" | "zeros" | "dt_bias" | "A_log"
    scale: float = 1.0

    def stacked(self, repeats: int) -> "ParamSpec":
        return dataclasses.replace(self, shape=(repeats,) + self.shape)


def Param(shape, *, scale: Optional[float] = None, dtype=torch.float32,
          init: str = "normal") -> ParamSpec:
    """The reference's ``Param`` rule: default scale 1/sqrt(fan_in) with
    fan_in = shape[0]."""
    if init == "normal" and scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return ParamSpec(tuple(shape), dtype, init,
                     1.0 if scale is None else float(scale))


def draw(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    """A tensor of ``spec``, every draw in fp32 and then cast to its dtype:
    ``normal`` is ``N(0, 1) * scale``; ``dt_bias`` is Mamba-1's dt bias
    (``mamba.py:41-44`` of the reference: ``dt = exp(u * (ln 0.1 - ln 1e-3)
    + ln 1e-3)`` for ``u ~ U[0, 1)``, then ``dt + log(-expm1(-dt))``, the
    inverse softplus); ``A_log`` is ``log(1..N)`` along the last axis,
    deterministic; ``ones`` and ``zeros`` draw nothing."""
    if spec.init in ("ones", "zeros"):
        fill = torch.ones if spec.init == "ones" else torch.zeros
        return fill(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "A_log":
        n = spec.shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a.expand(spec.shape)).to(spec.dtype)
    if spec.init == "dt_bias":
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(u * (hi - lo) + lo)
        return (dt + torch.log(-torch.expm1(-dt))).to(spec.dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    # scaled in place: falcon-mamba's stacked in_proj draws 17 GB of fp32
    return torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(spec.scale).to(spec.dtype)


def dense_param(d_in: int, out_shape, *, dtype=torch.float32, scale=None):
    """Weight (d_in, *out_shape) with fan-in init."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return Param((d_in,) + tuple(out_shape), scale=scale, dtype=dtype)


def per_replica(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """View ``w`` (dp, *ws) so it broadcasts against an ``ndim``-dim
    activation (dp, ..., *ws) replica by replica."""
    return w.view((w.shape[0],) + (1,) * (ndim - w.dim()) + tuple(w.shape[1:]))


def replica_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (dp, *mid, d) @ w (dp, d, f) -> (dp, *mid, f): one batched product
    over the replica axis."""
    dp, d = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(dp, -1, d), w)
    return out.view(tuple(x.shape[:-1]) + (w.shape[-1],))


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------- norms
def _check_kind(kind: str, ported: str) -> None:
    if kind != ported:
        raise NotImplementedError(f"{kind!r} is not ported yet (ROADMAP A.13)")


def norm_init(kind: str, d: int, dtype=torch.float32) -> Dict:
    _check_kind(kind, "rms")
    return {"scale": Param((d,), init="ones", dtype=dtype)}


def norm_apply(kind: str, params: Dict, x: torch.Tensor, eps: float = 1e-6):
    _check_kind(kind, "rms")
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    y = y * per_replica(params["scale"], x.dim()).float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- MLP
def mlp_init(d: int, d_ff: int, act: str, dtype=torch.float32) -> Dict:
    _check_kind(act, "swiglu")
    return {"w_gate": dense_param(d, (d_ff,), dtype=dtype),
            "w_in": dense_param(d, (d_ff,), dtype=dtype),
            "w_out": dense_param(d_ff, (d,), dtype=dtype)}


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    _check_kind(act, "swiglu")
    h = replica_matmul(x, params["w_in"])
    h = silu(replica_matmul(x, params["w_gate"])) * h
    return replica_matmul(h, params["w_out"])


# ---------------------------------------------------------------- embedding
def embed_init(vocab: int, d: int, dtype=torch.float32) -> ParamSpec:
    return Param((vocab, d), scale=0.02, dtype=dtype)
