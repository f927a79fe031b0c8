"""Shared layers: parameter specs, the norms, the MLPs, embedding.

Port of ``repro/models/layers.py`` (``Param``/``dense_param`` init rules,
``norm_init``/``norm_apply`` for ``"rms"``, ``"ln"`` and ``"nonparam"``,
``mlp_init``/``mlp_apply`` for ``"swiglu"`` and ``"gelu"``, ``embed_init``,
``silu``, ``gelu``, ``dtype_of``, ``ax``, ``ax_names``). Init is split in
two: ``*_init`` functions return ``ParamSpec`` trees (shape,
dtype, the reference's distribution and its logical-axes annotation, which
``train.sharding`` maps onto mesh axes), and ``draw`` makes a tensor of one
from a ``torch.Generator`` (``models.transformer.lm_init`` draws the tree).
The draws cannot reproduce ``jax.random``'s bits; parity tests bridge the
reference's weights in (``checkpoint/bridge.py``).

Every weight carries a leading replica axis ``(dp, ...)`` and activations
are ``(dp, b, S, ...)``: the reference's ``vmap`` over replicas is written
out as a batch dimension.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = ["ParamSpec", "Param", "draw", "dense_param", "dtype_of", "silu",
           "gelu", "ax", "ax_names",
           "norm_init", "norm_apply", "mlp_init", "mlp_apply", "embed_init",
           "per_replica", "replica_matmul", "weight_einsum",
           "weight_products"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def ax(*names) -> str:
    """A logical-axes annotation as one string, one comma-separated segment
    per dim ("embed,heads,head_dim"; an empty segment is an unannotated
    dim), as the reference encodes it."""
    return ",".join("" if n is None else str(n) for n in names)


def ax_names(annotation: str) -> Tuple[Optional[str], ...]:
    return tuple(n if n else None for n in annotation.split(","))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf before it is drawn (see ``draw`` for the kinds).
    ``axes`` is its logical-axes annotation (``ax``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"  # "normal" | "ones" | "zeros" | "dt_bias" | "A_log"
    scale: float = 1.0
    axes: str = ""

    def stacked(self, repeats: int) -> "ParamSpec":
        """The spec under a leading repeat axis, left unannotated."""
        return dataclasses.replace(self, shape=(repeats,) + self.shape,
                                   axes="," + self.axes)


def Param(shape, axes, *, scale: Optional[float] = None, dtype=torch.float32,
          init: str = "normal") -> ParamSpec:
    """The reference's ``Param`` rule: default scale 1/sqrt(fan_in) with
    fan_in = shape[0]; ``axes`` names each dim's logical axis (or None)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ "
                         "in length")
    if init == "normal" and scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return ParamSpec(tuple(shape), dtype, init,
                     1.0 if scale is None else float(scale), ax(*axes))


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


def dense_param(d_in: int, out_shape, in_axis, out_axes, *,
                dtype=torch.float32, scale=None):
    """Weight (d_in, *out_shape) with fan-in init."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return Param((d_in,) + tuple(out_shape), (in_axis,) + tuple(out_axes),
                 scale=scale, dtype=dtype)


def per_replica(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """View ``w`` (dp, *ws) so it broadcasts against an ``ndim``-dim
    activation (dp, ..., *ws) replica by replica."""
    return w.view((w.shape[0],) + (1,) * (ndim - w.dim()) + tuple(w.shape[1:]))


# Set while a product of activations with a weight runs: remat's "dots"
# policy (``blocks.stack_apply``) saves exactly those products' outputs.
_WEIGHT_PRODUCT = contextvars.ContextVar("weight_product", default=False)


@contextlib.contextmanager
def _weight_product():
    token = _WEIGHT_PRODUCT.set(True)
    try:
        yield
    finally:
        _WEIGHT_PRODUCT.reset(token)


def weight_products() -> bool:
    """True inside a weight product (``replica_matmul``,
    ``weight_einsum``)."""
    return _WEIGHT_PRODUCT.get()


def replica_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (dp, *mid, d) @ w (dp, d, f) -> (dp, *mid, f): one batched product
    over the replica axis."""
    dp, d = x.shape[0], x.shape[-1]
    with _weight_product():
        out = torch.bmm(x.reshape(dp, -1, d), w)
    return out.view(tuple(x.shape[:-1]) + (w.shape[-1],))


def weight_einsum(equation: str, x: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, x, w)`` for a product with a weight ``w``
    (the attention projections)."""
    with _weight_product():
        return torch.einsum(equation, x, w)


def silu(x):
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in its op order: the tanh
    approximation, its constants rounded to x's dtype as jnp rounds them."""
    c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


# ---------------------------------------------------------------- norms
def norm_init(kind: str, d: int, dtype=torch.float32) -> Dict:
    """rms: a learnable scale; ln: scale and bias; nonparam: no params
    (OLMo-1B's non-parametric LayerNorm [arXiv:2402.00838])."""
    if kind == "nonparam":
        return {}
    if kind == "rms":
        return {"scale": Param((d,), ("embed",), init="ones", dtype=dtype)}
    if kind == "ln":
        return {"scale": Param((d,), ("embed",), init="ones", dtype=dtype),
                "bias": Param((d,), ("embed",), init="zeros", dtype=dtype)}
    raise ValueError(kind)


def norm_apply(kind: str, params: Dict, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    if kind == "rms":   # weightless where ``params`` holds no scale
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        if "scale" in params:
            y = y * per_replica(params["scale"], x.dim()).float()
    else:  # ln / nonparam; the variance is jnp.var's, the mean square of
        # the deviations
        mu = xf.mean(-1, keepdim=True)
        dev = xf - mu
        y = dev * torch.rsqrt((dev * dev).mean(-1, keepdim=True) + eps)
        if kind == "ln":
            y = (y * per_replica(params["scale"], x.dim()).float()
                 + per_replica(params["bias"], x.dim()).float())
    return y.to(x.dtype)


# ---------------------------------------------------------------- MLP
def mlp_init(d: int, d_ff: int, act: str, dtype=torch.float32) -> Dict:
    p = {}
    if act == "swiglu":
        p["w_gate"] = dense_param(d, (d_ff,), "embed", ("ffn",), dtype=dtype)
    p["w_in"] = dense_param(d, (d_ff,), "embed", ("ffn",), dtype=dtype)
    p["w_out"] = dense_param(d_ff, (d,), "ffn", ("embed",), dtype=dtype)
    return p


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = replica_matmul(x, params["w_in"])
    if act == "swiglu":
        h = silu(replica_matmul(x, params["w_gate"])) * h
    elif act == "gelu":
        h = gelu(h)
    else:
        raise ValueError(act)
    return replica_matmul(h, params["w_out"])


# ---------------------------------------------------------------- embedding
def embed_init(vocab: int, d: int, dtype=torch.float32) -> ParamSpec:
    return Param((vocab, d), ("vocab", "embed"), scale=0.02, dtype=dtype)
