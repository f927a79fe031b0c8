"""Multi-head / grouped-query attention for the train path.

Port of ``repro/models/attention.py`` (``attn_init``, ``_qk_normalize``,
``_project_qkv``, ``_sdpa``, ``causal_window_mask``, ``attn_apply``). Plain
tensor code, as the reference's is jnp: the same einsums, the GQA key/value
repetition to all heads, scores cast to fp32, a masked softmax. It calls no
fused attention operator, so the comparison with the reference is like for
like. Activations carry the replica axis first: q is (dp, b, S, H, hd)
against weights (dp, d, H, hd).

Decode caches, cross-attention and MLA wait for serving and the other
families (ROADMAP A.13, A.14).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .config import AttnSpec
from .layers import Param, dense_param, per_replica
from .rotary import apply_rope, rope_frequencies

__all__ = ["attn_init", "attn_apply", "causal_window_mask", "NEG_INF"]

NEG_INF = -1e30


def attn_init(d_model: int, spec: AttnSpec, dtype=torch.float32):
    H, K, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    assert H % K == 0, (H, K)
    p = {"wq": dense_param(d_model, (H, hd), "embed", ("heads", "head_dim"),
                           dtype=dtype),
         "wk": dense_param(d_model, (K, hd), "embed",
                           ("kv_heads", "head_dim"), dtype=dtype),
         "wv": dense_param(d_model, (K, hd), "embed",
                           ("kv_heads", "head_dim"), dtype=dtype),
         "wo": Param((H, hd, d_model), ("heads", "head_dim", "embed"),
                     scale=1.0 / math.sqrt(H * hd), dtype=dtype)}
    if spec.qk_norm:  # Qwen3-style per-head RMSNorm on q and k
        p["q_norm"] = Param((hd,), ("head_dim",), init="ones", dtype=dtype)
        p["k_norm"] = Param((hd,), ("head_dim",), init="ones", dtype=dtype)
    return p


def _qk_normalize(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * per_replica(scale, x.dim()).float()).to(x.dtype)


def _rot_dim(spec: AttnSpec) -> int:
    rd = int(spec.head_dim * spec.rope_frac)
    return rd - rd % 2


def _project_qkv(p, spec: AttnSpec, x, positions):
    q = torch.einsum("rbsd,rdhk->rbshk", x, p["wq"])
    k = torch.einsum("rbtd,rdhk->rbthk", x, p["wk"])
    v = torch.einsum("rbtd,rdhk->rbthk", x, p["wv"])
    if spec.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    rd = _rot_dim(spec)
    if rd:
        c, s = rope_frequencies(rd, positions, spec.rope_theta)
        q = apply_rope(q, c, s, rd)
        k = apply_rope(k, c, s, rd)
    return q, k, v


def _sdpa(q, k, v, mask, n_kv: int):
    """q (..., S, H, hd), k/v (..., T, K, hd), mask (S, T) bool or None."""
    *lead, S, H, hd = q.shape
    T, K = k.shape[-3], n_kv
    G = H // K
    if G > 1:
        k = k[..., None, :].expand(*lead, T, K, G, hd).reshape(*lead, T, H, hd)
        v = v[..., None, :].expand(*lead, T, K, G, hd).reshape(*lead, T, H, hd)
    scores = torch.einsum("...shd,...thd->...hst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hst,...thd->...shd", w, v)


def causal_window_mask(S: int, T: int, window: Optional[int],
                       device=None) -> torch.Tensor:
    """(S, T) bool; query i attends key j when j <= i (and i - j < window)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= (qi - kj) < window
    return m


def attn_apply(p, spec: AttnSpec, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal self-attention over x (dp, b, S, d)."""
    S = x.shape[2]
    positions = torch.arange(S, device=x.device)[None]
    q, k, v = _project_qkv(p, spec, x, positions)
    mask = causal_window_mask(S, S, spec.window, device=x.device) \
        if spec.causal else None
    out = _sdpa(q, k, v, mask, spec.n_kv_heads)
    return torch.einsum("rbshk,rhkd->rbsd", out, p["wo"])
