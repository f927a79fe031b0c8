"""Plain float32 reference of a Mamba-1 language model (falcon-mamba's shapes,
arXiv:2410.05355, without its weightless norms on B, C and dt; the
selective SSM of arXiv:2312.00752).

Per layer ``x = rmsnorm(h)``, ``(xi, z) = W_in x``, ``xi = silu(causal
depthwise conv(xi) + b)``, ``(dt_low, B, C) = W_x xi``, ``dt =
softplus(W_dt dt_low + dt_bias)``, ``A = -exp(A_log)``; the state ``h_t =
exp(dt_t A) h_{t-1} + dt_t xi_t B_t`` over the sequence, ``y = h_t . C_t + D
xi``, ``h += W_out (y * silu(z))``; then the final RMSNorm and an untied
head. The scan is a plain loop over positions with its backward written
out (``_Scan``). ``leaf_specs`` lists the weights in the order and shapes
of the system under test's parameter tree, with their initial
distributions (``dt_bias`` is Mamba's inverse-softplus of a log-uniform
dt in [1e-3, 0.1], ``A_log`` is log(1..N)).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Spec = Tuple[str, Tuple[int, ...], str, float]

_MIXER = ("A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj", "in_proj",
          "out_proj", "x_proj")


def dims(cfg: Dict) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    return (cfg["expand"] * cfg["d_model"], cfg["d_state"], cfg["d_conv"],
            cfg["dt_rank"])


def leaf_specs(cfg: Dict) -> List[Spec]:
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    Di, N, Kc, R = dims(cfg)
    mixer = {"A_log": ((Di, N), "A_log", 1.0), "D": ((Di,), "ones", 1.0),
             "conv_b": ((Di,), "zeros", 1.0),
             "conv_w": ((Kc, Di), "normal", 1.0 / math.sqrt(Kc)),
             "dt_bias": ((Di,), "dt_bias", 1.0),
             "dt_proj": ((R, Di), "normal", 1.0 / math.sqrt(R)),
             "in_proj": ((d, 2 * Di), "normal", 1.0 / math.sqrt(d)),
             "out_proj": ((Di, d), "normal", 1.0 / math.sqrt(Di)),
             "x_proj": ((Di, R + 2 * N), "normal", 1.0 / math.sqrt(Di))}
    out: List[Spec] = [("embed", (V, d), "normal", 0.02),
                       ("final_norm.scale", (d,), "ones", 1.0)]
    for name in _MIXER:
        shape, init, scale = mixer[name]
        out.append((f"layers.mixer.{name}", (L,) + shape, init, scale))
    out.append(("layers.norm1.scale", (L, d), "ones", 1.0))
    out.append(("lm_head", (d, V), "normal", 1.0 / math.sqrt(d)))
    return out


class _Scan(torch.autograd.Function):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0; backward
    runs the adjoint recurrence g_t = dh_t + a_{t+1} g_{t+1}."""

    @staticmethod
    def forward(ctx, a, b):
        hs = torch.empty_like(b)
        h = torch.zeros_like(b[:, 0])
        for t in range(b.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs[:, t] = h
        ctx.save_for_backward(a, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        a, hs = ctx.saved_tensors
        ga, gb = torch.zeros_like(a), torch.empty_like(a)
        g = torch.zeros_like(dhs[:, 0])
        for t in reversed(range(a.shape[1])):
            g = dhs[:, t] + (a[:, t + 1] * g if t + 1 < a.shape[1] else 0)
            gb[:, t] = g
            if t:
                ga[:, t] = g * hs[:, t - 1]
        return ga, gb


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _layer(cfg, mm, h, A_log, D, conv_b, conv_w, dt_bias, dt_proj, in_proj,
           out_proj, x_proj, norm):
    Di, N, Kc, R = dims(cfg)
    S = h.shape[1]
    xi, z = mm(_rms(h, norm, cfg["norm_eps"]), in_proj).chunk(2, dim=-1)
    xp = torch.nn.functional.pad(xi, (0, 0, Kc - 1, 0))
    xi = sum(xp[:, k:k + S] * conv_w[k] for k in range(Kc)) + conv_b
    xi = torch.nn.functional.silu(xi)
    dbc = mm(xi, x_proj)
    dt = torch.nn.functional.softplus(mm(dbc[..., :R], dt_proj) + dt_bias,
                                      threshold=1e9)
    B, C = dbc[..., R:R + N], dbc[..., R + N:]
    dA = torch.exp(dt[..., None] * -torch.exp(A_log))
    dBx = (dt * xi)[..., None] * B[..., None, :]
    hs = _Scan.apply(dA, dBx)
    y = (hs * C[..., None, :]).sum(-1) + D * xi
    return h + mm(y * torch.nn.functional.silu(z), out_proj)


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict,
         mm) -> torch.Tensor:
    if cfg.get("bcdt_rms"):
        raise ValueError("norms on B, C and dt are not modelled")
    inp, gold = tokens[:, :-1], tokens[:, 1:]
    h = w["embed"][inp]
    for i in range(cfg["n_layers"]):
        ws = [w[f"layers.mixer.{n}"][i] for n in _MIXER]
        h = checkpoint(_layer, cfg, mm, h, *ws, w["layers.norm1.scale"][i],
                       use_reentrant=False)
    h = _rms(h, w["final_norm.scale"], cfg["norm_eps"])
    logits = mm(h, w["lm_head"])
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), gold.reshape(-1))
