"""Plain float32 reference of a pre-norm decoder with rotary MHA and a SwiGLU
MLP: OLMo (arXiv:2402.00838, non-parametric LayerNorm, tied embedding) and
its RMSNorm relatives.

Per layer ``h += Wo . attn(rope(Wq x), rope(Wk x), Wv x)`` with ``x =
norm(h)``, causal softmax over ``q . k / sqrt(hd)``, rotary pairs (even,
odd) at theta ``rope_theta``; then ``h += W_out (silu(W_gate x) * W_in x)``
with ``x = norm(h)``; the final norm, logits ``h . E^T`` (tied) or ``h .
W_head``, the mean token cross entropy. ``leaf_specs`` lists the weights in
the order and shapes of the system under test's parameter tree (its keys
sorted, the layers stacked on a leading axis), with their initial
distributions. Each layer is recomputed in backward (``checkpoint``) so that
the reference fits beside the program's data on one card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Spec = Tuple[str, Tuple[int, ...], str, float]

_LAYER = ("ff.w_gate", "ff.w_in", "ff.w_out", "mixer.wk", "mixer.wo",
          "mixer.wq", "mixer.wv")


def leaf_specs(cfg: Dict) -> List[Spec]:
    """``(name, shape, init, scale)`` per weight: ``normal`` is N(0, 1) x
    scale (1 / sqrt(fan-in), the embedding 0.02), ``ones`` a norm scale."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    H, K, hd, F = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    shapes = {"ff.w_gate": ((d, F), d), "ff.w_in": ((d, F), d),
              "ff.w_out": ((F, d), F), "mixer.wk": ((d, K, hd), d),
              "mixer.wo": ((H, hd, d), H * hd), "mixer.wq": ((d, H, hd), d),
              "mixer.wv": ((d, K, hd), d)}
    out: List[Spec] = [("embed", (V, d), "normal", 0.02)]
    if cfg["norm"] == "rms":
        out.append(("final_norm.scale", (d,), "ones", 1.0))
    for name in _LAYER:
        shape, fan_in = shapes[name]
        out.append((f"layers.{name}", (L,) + shape, "normal",
                    1.0 / math.sqrt(fan_in)))
    if cfg["norm"] == "rms":
        out += [(f"layers.{n}.scale", (L, d), "ones", 1.0)
                for n in ("norm1", "norm2")]
    if not cfg["tie_embeddings"]:
        out.append(("lm_head", (d, V), "normal", 1.0 / math.sqrt(d)))
    return out


def _norm(x: torch.Tensor, cfg: Dict, scale=None) -> torch.Tensor:
    eps = cfg["norm_eps"]
    if cfg["norm"] == "rms":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale
    dev = x - x.mean(-1, keepdim=True)
    return dev * torch.rsqrt((dev * dev).mean(-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate the (even, odd) pairs of x (b, S, H, hd) by position."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], -1).flatten(-2)


def _layer(cfg, mm, cos, sin, mask, h, w_gate, w_in, w_out, wk, wo, wq, wv,
           n1=None, n2=None):
    b, S, d = h.shape
    H, K, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x = _norm(h, cfg, n1)
    q = _rope(mm(x, wq.reshape(d, H * hd)).view(b, S, H, hd), cos, sin)
    k = _rope(mm(x, wk.reshape(d, K * hd)).view(b, S, K, hd), cos, sin)
    v = mm(x, wv.reshape(d, K * hd)).view(b, S, K, hd)
    if K < H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(att, v).transpose(1, 2).reshape(b, S, H * hd)
    h = h + mm(o, wo.reshape(H * hd, d))
    x = _norm(h, cfg, n2)
    return h + mm(torch.nn.functional.silu(mm(x, w_gate)) * mm(x, w_in), w_out)


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: Dict,
         mm) -> torch.Tensor:
    """Mean next-token cross entropy of one replica's weights ``w`` (float32,
    by ``leaf_specs`` name) on ``tokens`` (b, S+1)."""
    inp, gold = tokens[:, :-1], tokens[:, 1:]
    S, hd = inp.shape[1], cfg["head_dim"]
    dev = tokens.device
    inv = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=dev)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    h = w["embed"][inp]
    rms = cfg["norm"] == "rms"
    for i in range(cfg["n_layers"]):
        ws = [w[f"layers.{n}"][i] for n in _LAYER]
        if rms:
            ws += [w["layers.norm1.scale"][i], w["layers.norm2.scale"][i]]
        h = checkpoint(_layer, cfg, mm, cos, sin, mask, h, *ws,
                       use_reentrant=False)
    h = _norm(h, cfg, w.get("final_norm.scale"))
    head = w["embed"].t() if cfg["tie_embeddings"] else w["lm_head"]
    logits = mm(h, head)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), gold.reshape(-1))
