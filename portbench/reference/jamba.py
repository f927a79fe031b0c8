"""Plain float32 reference of an AI21-Jamba language model without experts
(``model_type`` "jamba" with ``num_experts`` 1, as AI21-Jamba2-3B): the
layer equations of arXiv:2403.19887 and of the ``jamba`` type's published
code.

Layer ``i`` mixes with attention where ``i % attn_layer_period ==
attn_layer_offset`` and with Mamba-1 elsewhere; every layer is pre-norm,
``h += mixer(rmsnorm(h))``, then ``h += W_down (silu(W_gate x) * W_up x)``
with ``x = rmsnorm(h)``; then the final RMSNorm, the tied head ``h . E^T``
and the mean next-token cross entropy. Every RMSNorm has a learned scale
and epsilon ``rms_norm_eps``.

* Mamba-1: ``(xi, z) = W_in x``, ``xi = silu(causal depthwise conv(xi) +
  b)``, ``(dt_low, B, C) = W_x xi``, then the weighted RMSNorms of the
  paper's section 6.4, ``dt_low = rms(dt_low) w_dt``, ``B = rms(B) w_B``,
  ``C = rms(C) w_C``; ``dt = softplus(W_dt dt_low + dt_bias)``, ``A =
  -exp(A_log)``, the state ``h_t = exp(dt_t A) h_{t-1} + dt_t xi_t B_t``,
  ``y = h_t . C_t + D xi``, out ``W_out (y * silu(z))``. No bias on the
  in and out projections; the conv has one.
* Attention: ``num_attention_heads`` query heads of ``hidden_size /
  num_attention_heads`` over ``num_key_value_heads`` key and value heads,
  each shared by as many query heads in order; no positional encoding;
  causal softmax over ``q . k / sqrt(hd)``; out ``W_o``.

Departures from the published model: none in the equations. The scan is
a log-depth doubling scan (``_DoublingScan``) where the published code
scans in order, so its sums round in another order. ``leaf_specs`` lists
the weights in the order and shapes of the system under test's parameter
tree (layers grouped by their position in the smallest repeating period
of the layer kinds, each stacked over the period's repeats), with the
initial distributions of ``mamba.py`` and ``dense.py`` and norm scales
of one. Each layer is recomputed in backward (``checkpoint``) so that the
reference fits beside the program's data on one card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .mamba import _rms

Spec = Tuple[str, Tuple[int, ...], str, float]


def kinds(cfg: Dict) -> List[str]:
    """Each layer's mixer, "attn" or "mamba", in order."""
    period, offset = cfg["attn_layer_period"], cfg["attn_layer_offset"]
    return ["attn" if i % period == offset else "mamba"
            for i in range(cfg["num_hidden_layers"])]


def period(ks: List[str]) -> int:
    """The smallest period of the layer kinds that divides the depth (up to
    16 layers, the tree's grouping)."""
    L = len(ks)
    for P in range(1, min(16, L - 1) + 1):
        if L % P == 0 and all(ks[i] == ks[i % P] for i in range(L)):
            return P
    raise ValueError(f"layer kinds {ks} repeat with no period of at most 16")


def dims(cfg: Dict) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    return (cfg["mamba_expand"] * cfg["hidden_size"], cfg["mamba_d_state"],
            cfg["mamba_d_conv"], cfg["mamba_dt_rank"])


def _heads(cfg: Dict) -> Tuple[int, int, int]:
    H = cfg["num_attention_heads"]
    return H, cfg["num_key_value_heads"], cfg["hidden_size"] // H


def _layer_specs(cfg: Dict, kind: str) -> Dict[str, Tuple]:
    """One layer's weights: name -> (shape, init, scale)."""
    d, F = cfg["hidden_size"], cfg["intermediate_size"]
    out = {"ff.w_gate": ((d, F), "normal", 1 / math.sqrt(d)),
           "ff.w_in": ((d, F), "normal", 1 / math.sqrt(d)),
           "ff.w_out": ((F, d), "normal", 1 / math.sqrt(F)),
           "norm1.scale": ((d,), "ones", 1.0),
           "norm2.scale": ((d,), "ones", 1.0)}
    if kind == "attn":
        H, K, hd = _heads(cfg)
        out.update({"mixer.wk": ((d, K, hd), "normal", 1 / math.sqrt(d)),
                    "mixer.wo": ((H, hd, d), "normal", 1 / math.sqrt(H * hd)),
                    "mixer.wq": ((d, H, hd), "normal", 1 / math.sqrt(d)),
                    "mixer.wv": ((d, K, hd), "normal", 1 / math.sqrt(d))})
        return out
    Di, N, Kc, R = dims(cfg)
    out.update({"mixer.A_log": ((Di, N), "A_log", 1.0),
                "mixer.D": ((Di,), "ones", 1.0),
                "mixer.b_norm": ((N,), "ones", 1.0),
                "mixer.c_norm": ((N,), "ones", 1.0),
                "mixer.conv_b": ((Di,), "zeros", 1.0),
                "mixer.conv_w": ((Kc, Di), "normal", 1 / math.sqrt(Kc)),
                "mixer.dt_bias": ((Di,), "dt_bias", 1.0),
                "mixer.dt_norm": ((R,), "ones", 1.0),
                "mixer.dt_proj": ((R, Di), "normal", 1 / math.sqrt(R)),
                "mixer.in_proj": ((d, 2 * Di), "normal", 1 / math.sqrt(d)),
                "mixer.out_proj": ((Di, d), "normal", 1 / math.sqrt(Di)),
                "mixer.x_proj": ((Di, R + 2 * N), "normal",
                                 1 / math.sqrt(Di))})
    return out


def leaf_specs(cfg: Dict) -> List[Spec]:
    """``(name, shape, init, scale)`` per weight; a layer's weight is named
    ``layers.<position in the period>.<name>`` and stacked over the
    period's repeats."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    ks = kinds(cfg)
    P = period(ks)
    R = len(ks) // P
    out: List[Spec] = [("embed", (V, d), "normal", 0.02),
                       ("final_norm.scale", (d,), "ones", 1.0)]
    for j in range(P):
        for name, (shape, init, scale) in sorted(
                _layer_specs(cfg, ks[j]).items()):
            out.append((f"layers.{j}.{name}", (R,) + shape, init, scale))
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head", (d, V), "normal", 1 / math.sqrt(d)))
    return out


def _doubling(a: torch.Tensor, b: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in ceil(log2 S)
    passes (Hillis and Steele); with ``reverse``, h_t = a_{t+1} h_{t+1} +
    b_t from h_S = 0. The pass at distance ``k`` folds position ``t - k``'s
    partial result into position ``t``'s (``t + k``'s with ``reverse``)
    through ``c``, the products of ``a`` over the spans folded so far: for
    the forward scan at the positions ``k .. S-1``, for the reverse one at
    ``0 .. S-k-1``; both are ``a[:, 1:]`` at first and shorten by ``k``
    each pass."""
    S = a.shape[1]
    if S < 2:
        return b.clone()
    h, c, k = b, a[:, 1:], 1
    while k < S:
        new = torch.empty_like(h)
        if reverse:
            new[:, S - k:] = h[:, S - k:]
            torch.addcmul(h[:, :-k], c, h[:, k:], out=new[:, :-k])
        else:
            new[:, :k] = h[:, :k]
            torch.addcmul(h[:, k:], c, h[:, :-k], out=new[:, k:])
        h = new
        if 2 * k < S:
            c = c[:, k:] * c[:, :-k]
        k *= 2
    return h


class _DoublingScan(torch.autograd.Function):
    """``mamba._Scan``'s recurrence by ``_doubling``; backward runs the
    adjoint ``g_t = dh_t + a_{t+1} g_{t+1}`` as the reverse doubling scan.
    Saves ``a`` and ``h`` only."""

    @staticmethod
    def forward(ctx, a, b):
        hs = _doubling(a, b)
        ctx.save_for_backward(a, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        a, hs = ctx.saved_tensors
        g = _doubling(a, dhs, reverse=True)
        ga = torch.zeros_like(a)
        torch.mul(g[:, 1:], hs[:, :-1], out=ga[:, 1:])
        return ga, g


def _mamba(cfg, mm, x, w):
    Di, N, Kc, R = dims(cfg)
    eps = cfg["rms_norm_eps"]
    S = x.shape[1]
    xi, z = mm(x, w["mixer.in_proj"]).chunk(2, dim=-1)
    xp = torch.nn.functional.pad(xi, (0, 0, Kc - 1, 0))
    xi = sum(xp[:, k:k + S] * w["mixer.conv_w"][k] for k in range(Kc))
    xi = torch.nn.functional.silu(xi + w["mixer.conv_b"])
    dbc = mm(xi, w["mixer.x_proj"])
    dt_low = _rms(dbc[..., :R], w["mixer.dt_norm"], eps)
    B = _rms(dbc[..., R:R + N], w["mixer.b_norm"], eps)
    C = _rms(dbc[..., R + N:], w["mixer.c_norm"], eps)
    dt = torch.nn.functional.softplus(
        mm(dt_low, w["mixer.dt_proj"]) + w["mixer.dt_bias"], threshold=1e9)
    dA = torch.exp(dt[..., None] * -torch.exp(w["mixer.A_log"]))
    dBx = (dt * xi)[..., None] * B[..., None, :]
    hs = _DoublingScan.apply(dA, dBx)
    del dA, dBx
    y = (hs * C[..., None, :]).sum(-1) + w["mixer.D"] * xi
    return mm(y * torch.nn.functional.silu(z), w["mixer.out_proj"])


def _attn(cfg, mm, x, w, mask):
    b, S, d = x.shape
    H, K, hd = _heads(cfg)
    q = mm(x, w["mixer.wq"].reshape(d, H * hd)).view(b, S, H, hd)
    k = mm(x, w["mixer.wk"].reshape(d, K * hd)).view(b, S, K, hd)
    v = mm(x, w["mixer.wv"].reshape(d, K * hd)).view(b, S, K, hd)
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(att, v).transpose(1, 2).reshape(b, S, H * hd)
    return mm(o, w["mixer.wo"].reshape(H * hd, d))


def _layer(cfg, mm, kind, mask, h, w):
    eps = cfg["rms_norm_eps"]
    x = _rms(h, w["norm1.scale"], eps)
    h = h + (_attn(cfg, mm, x, w, mask) if kind == "attn"
             else _mamba(cfg, mm, x, w))
    x = _rms(h, w["norm2.scale"], eps)
    return h + mm(torch.nn.functional.silu(mm(x, w["ff.w_gate"]))
                  * mm(x, w["ff.w_in"]), w["ff.w_out"])


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict,
         mm) -> torch.Tensor:
    """Mean next-token cross entropy of one replica's weights ``w`` (float32,
    by ``leaf_specs`` name) on ``tokens`` (b, S+1)."""
    if cfg["num_experts"] != 1:
        raise ValueError("experts are not modelled")
    inp, gold = tokens[:, :-1], tokens[:, 1:]
    S = inp.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    ks = kinds(cfg)
    P = period(ks)
    h = w["embed"][inp]
    for i, kind in enumerate(ks):
        pre = f"layers.{i % P}."
        lw = {n[len(pre):]: x[i // P] for n, x in w.items()
              if n.startswith(pre)}
        h = checkpoint(_layer, cfg, mm, kind, mask, h, lw,
                       use_reentrant=False)
    h = _rms(h, w["final_norm.scale"], cfg["rms_norm_eps"])
    head = w["embed"].t() if cfg["tie_word_embeddings"] else w["lm_head"]
    logits = mm(h, head)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), gold.reshape(-1))
