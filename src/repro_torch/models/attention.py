"""Multi-head / grouped-query attention, enc-dec cross-attention and
DeepSeek-V3's multi-head latent attention (MLA): the train path and the
decode path.

Port of ``repro/models/attention.py`` (``attn_init``, ``_qk_normalize``,
``_project_qkv``, ``_sdpa``, ``causal_window_mask``, ``attn_apply``,
``cache_len``, ``attn_cache_init``, ``attn_decode``, and MLA's
``mla_init``, ``_rms``, ``_mla_q``, ``_mla_latent_kv``, ``mla_apply``,
``mla_cache_init``, ``mla_decode``). Plain tensor code, as
the reference's is jnp: the same einsums, the GQA key/value repetition to
all heads, scores cast to fp32, a masked softmax. It calls no fused
attention operator, so the comparison with the reference is like for like.
Activations carry the replica axis first: q is (dp, b, S, H, hd) against
weights (dp, d, H, hd), and a decode cache leaf is (dp, b, L, K, hd).

Decode consumes one token against a KV cache: a full cache (b, L, K, hd)
written at ``pos``, or with a sliding window a ring buffer of ``window``
slots written at ``pos % L``. The cache is written in place (the
reference's jitted serve step donates it) and returned; ``pos`` may be a
0-d device tensor, so a decode loop never reads a position back to the host.

Partial rotary (``rope_frac`` < 1, stablelm-2) rotates the first
``_rot_dim`` dims of each head; ``rope_frac`` 0 (whisper's encoder and
cross-attention) rotates none. Cross-attention (``AttnSpec.cross``) takes
its keys and values from the encoder's output ``memory``, unmasked and
unrotated; its decode reads them from the cache (``memory_kv``, filled by
prefill) and writes nothing.

**Sequence-parallel decode** (a serve step under a
``dist_ctx.SeqShards``, ``current_seq()``: the batch does not split over
the rank's batch group, as long_500k's batch of 1): a cache leaf whose
length the plan splits holds the rank's stretch, ``L / n`` positions from
``lo``. The slot rule and the validity mask stay global (over ``L`` and
the stretch's global indices ``lo + t``); only the stretch that holds the
slot writes the new token (``_write_slot``, no host read of ``pos``);
each rank's partial softmax over its stretch, fp32 ``(m, l, o)``, is
all-gathered over the batch group once a layer and combined in batch
order (``_seq_combine``), so every rank holds the same bits. A leaf that
does not split runs the one-process arithmetic on every rank.

MLA caches one latent per token, ``c_kv`` (b, L, kv_lora) and the shared
RoPE key ``k_rope`` (b, L, rope_dim), a full cache or a ring as above.
Its decode absorbs ``wk_b`` into the query and ``wv_b`` into the output,
so attention runs in the latent space; its scores are the nope product
plus the RoPE product, cast to fp32 and multiplied by
``1/sqrt(qk_nope + qk_rope)``, as the reference computes them (not
``_sdpa``, which divides and takes one product). In bf16 the RoPE half
is fp32 (the rotation promotes against its fp32 tables, as jnp does), so
the sum is too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.buckets import gather_rows
from repro_torch.dist_ctx import current_seq

from .config import AttnSpec, MLASpec
from .layers import (Param, dense_param, per_replica, replica_matmul,
                     weight_einsum)
from .rotary import apply_rope, rope_frequencies

__all__ = ["attn_init", "attn_apply", "attn_decode", "attn_cache_init",
           "mla_init", "mla_apply", "mla_decode", "mla_cache_init",
           "cache_len", "causal_window_mask", "NEG_INF"]

NEG_INF = -1e30


def cache_len(seq_len: int, window: Optional[int]) -> int:
    """Physical KV-cache length: ring buffer of ``window`` if windowed."""
    return seq_len if window is None else min(seq_len, window)


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


def _project_qkv(p, spec: AttnSpec, x, kv_x, q_positions, kv_positions):
    q = weight_einsum("rbsd,rdhk->rbshk", x, p["wq"])
    k = weight_einsum("rbtd,rdhk->rbthk", kv_x, p["wk"])
    v = weight_einsum("rbtd,rdhk->rbthk", kv_x, p["wv"])
    if spec.qk_norm:
        q = _qk_normalize(q, p["q_norm"])
        k = _qk_normalize(k, p["k_norm"])
    rd = _rot_dim(spec)
    if rd and not spec.cross:
        qc, qs = rope_frequencies(rd, q_positions, spec.rope_theta)
        kc, ks = rope_frequencies(rd, kv_positions, spec.rope_theta)
        q = apply_rope(q, qc, qs, rd)
        k = apply_rope(k, kc, ks, rd)
    return q, k, v


def _gqa_scores(q, k, v, mask, n_kv: int):
    """The fp32 scores (..., b, H, S, T) of ``_sdpa``, ``NEG_INF`` where
    ``mask`` is False, and ``v`` repeated to every head."""
    *lead, S, H, hd = q.shape
    T, K = k.shape[-3], n_kv
    G = H // K
    # jnp.einsum promotes its operands: decode's fp32 q (RoPE's tables are
    # fp32) meets the cache's keys in the param dtype (an exact upcast)
    k = k.to(torch.promote_types(q.dtype, k.dtype))
    if G > 1:
        k = k[..., None, :].expand(*lead, T, K, G, hd).reshape(*lead, T, H, hd)
        v = v[..., None, :].expand(*lead, T, K, G, hd).reshape(*lead, T, H, hd)
    scores = torch.einsum("...shd,...thd->...hst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = _masked(scores, mask[:, None] if mask.dim() == 3 else mask)
    return scores, v


def _masked(scores, valid):
    """``scores`` where ``valid``, ``NEG_INF`` elsewhere."""
    return torch.where(valid, scores,
                       torch.full((), NEG_INF, dtype=scores.dtype,
                                  device=scores.device))


def _sdpa(q, k, v, mask, n_kv: int):
    """q (..., b, S, H, hd), k/v (..., b, T, K, hd), mask (b, S, T) or
    (S, T) bool or None."""
    scores, v = _gqa_scores(q, k, v, mask, n_kv)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("...hst,...thd->...shd", w, v)


# ------------------------------------------------------ the decode cache
def _slot(window, pos, L: int):
    """The token's slot in a cache of ``L`` positions: ``pos % L`` in a
    ring buffer, else ``pos`` clamped into the cache (the reference's
    dynamic_update_slice clamps its start)."""
    return pos % L if window is not None else pos.clamp(0, L - 1)


def _valid(window, L: int, lo: int, part: int, slot, pos, device):
    """Which of the slots ``lo .. lo + part - 1`` of a cache of ``L``
    positions hold a token up to ``pos``: in a ring buffer those written
    within the last L steps (a floor-mod: ``%`` on tensors takes the
    divisor's sign)."""
    idx = torch.arange(lo, lo + part, device=device)
    if window is None:
        return idx <= pos
    return (slot - idx) % L < torch.clamp(pos + 1, max=L)


def _seq_stretch(window, leaf: torch.Tensor):
    """(seq, L, lo) when this step is sequence-parallel and the plan
    splits this cache leaf (a stretch of ``L / n`` positions from ``lo``
    of its global length ``L``), else None: the leaf is whole."""
    seq = current_seq()
    if seq is None:
        return None
    L = cache_len(seq.max_seq, window)
    lo, part = seq.stretch(L)
    if part == L:
        return None
    if leaf.shape[2] != part:
        raise ValueError(f"a stretch of {part} of {L} positions, the cache "
                         f"holds {leaf.shape[2]}")
    return seq, L, lo


def _write_slot(leaf: torch.Tensor, new: torch.Tensor, slot, lo: int,
                stretch: bool):
    """Write the token's entry ``new`` (one position on dim 2) at the
    global ``slot``: into a whole leaf directly; into a stretch starting
    at ``lo`` only where it holds the slot, every other stretch rewriting
    the entry it already holds (``slot`` stays on the device)."""
    new = new.to(leaf.dtype)
    if stretch:
        local = slot - lo
        at = local.clamp(0, leaf.shape[2] - 1).reshape(1).long()
        owner = (local >= 0) & (local < leaf.shape[2])
        new = torch.where(owner, new, leaf.index_select(2, at))
    else:
        at = slot.reshape(1).long()
    leaf.index_copy_(2, at, new)


def _seq_combine(scores, valid, vals, eq: str, seq, dtype):
    """Softmax over every rank's stretch: this rank's masked fp32
    ``scores`` (..., H, S, T) give its partial ``m`` (the row maximum),
    ``l`` (the sum of ``exp(s - m)`` over its valid slots, 0 where it has
    none) and ``o`` (``einsum(eq, exp(s - m), vals)`` in fp32, (..., H, S,
    e)); one ``all_gather`` of the three over the batch group, then in
    batch order ``l = sum exp(m_i - m) l_i`` and ``o = sum exp(m_i - m)
    o_i`` against the largest ``m``, and ``o / l`` rounded once to
    ``dtype``."""
    m = scores.amax(-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m),
                    torch.zeros((), dtype=scores.dtype, device=scores.device))
    mine = (m, e.sum(-1, keepdim=True), torch.einsum(eq, e, vals.float()))
    sizes = [t.numel() for t in mine]
    parts = [[x.view(t.shape) for x, t in zip(torch.split(g, sizes), mine)]
             for g in gather_rows(torch.cat([t.reshape(-1) for t in mine]),
                                  seq.group.batch, seq.n)]
    top = parts[0][0]
    for mi, _, _ in parts[1:]:
        top = torch.maximum(top, mi)
    l_sum = torch.zeros_like(m)
    o_sum = torch.zeros_like(mine[2])
    for mi, li, oi in parts:
        w = torch.exp(mi - top)
        l_sum = l_sum + w * li
        o_sum = o_sum + w * oi
    return (o_sum / l_sum).to(dtype)


def causal_window_mask(S: int, T: int, window: Optional[int],
                       device=None) -> torch.Tensor:
    """(S, T) bool; query i attends key j when j <= i (and i - j < window)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= (qi - kj) < window
    return m


def attn_apply(p, spec: AttnSpec, x: torch.Tensor,
               memory: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention over x (dp, b, S, d): causal (optionally
    windowed) self-attention, or with ``spec.cross`` cross-attention over
    ``memory`` (dp, b, T, d), unmasked."""
    S = x.shape[2]
    kv_x = memory if spec.cross else x
    T = kv_x.shape[2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    kv_positions = (torch.arange(T, device=x.device)[None] if spec.cross
                    else positions)
    q, k, v = _project_qkv(p, spec, x, kv_x, positions, kv_positions)
    mask = None
    if spec.causal and not spec.cross:
        mask = causal_window_mask(S, T, spec.window, device=x.device)
    out = _sdpa(q, k, v, mask, spec.n_kv_heads)
    return weight_einsum("rbshk,rhkd->rbsd", out, p["wo"])


# ------------------------------------------------------------- decode
def attn_cache_init(spec: AttnSpec, batch: int, seq_len: int, dtype, *,
                    device) -> dict:
    L = cache_len(seq_len, spec.window)
    shp = (batch, L, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attn_decode(p, spec: AttnSpec, x1: torch.Tensor, cache: dict, pos,
                memory_kv=None):
    """One-token decode. x1 (dp, b, 1, d); cache leaves (dp, b, L, K, hd),
    written in place at the token's slot; ``pos`` the current position (an
    int or a 0-d integer tensor). Returns (y (dp, b, 1, d), cache).

    A cross-attention layer reads ``memory_kv`` = (k_mem, v_mem), each
    (dp, b, F, K, hd), unmasked, and returns ``cache`` untouched. Its
    queries need no position, so prefill runs it over all S positions."""
    if spec.cross:
        k, v = memory_kv
        q = weight_einsum("rbsd,rdhk->rbshk", x1, p["wq"])
        if spec.qk_norm:
            q = _qk_normalize(q, p["q_norm"])
        out = _sdpa(q, k, v, None, spec.n_kv_heads)
        return torch.einsum("rbshk,rhkd->rbsd", out, p["wo"]), cache
    B = x1.shape[1]
    pos = torch.as_tensor(pos, device=x1.device)
    p1 = pos.reshape(1, 1)
    q, k1, v1 = _project_qkv(p, spec, x1, x1, p1, p1)
    sp = _seq_stretch(spec.window, cache["k"])
    part = cache["k"].shape[2]
    L, lo = (part, 0) if sp is None else sp[1:]
    slot = _slot(spec.window, pos, L)
    _write_slot(cache["k"], k1, slot, lo, sp is not None)
    _write_slot(cache["v"], v1, slot, lo, sp is not None)
    valid = _valid(spec.window, L, lo, part, slot, pos, x1.device)
    if sp is None:
        mask = valid[None, None, :].expand(B, 1, L)
        out = _sdpa(q, cache["k"], cache["v"], mask, spec.n_kv_heads)
    else:   # the partial attention over the stretch, combined
        scores, v = _gqa_scores(q, cache["k"], cache["v"],
                                valid[None, None, :], spec.n_kv_heads)
        out = _seq_combine(scores, valid, v, "...hst,...thd->...hsd",
                           sp[0], v.dtype).transpose(-3, -2)
    return torch.einsum("rbshk,rhkd->rbsd", out, p["wo"]), cache


# ===================================================================== MLA
def mla_init(d_model: int, spec: MLASpec, dtype=torch.float32):
    H = spec.n_heads
    qk = spec.qk_nope_dim + spec.qk_rope_dim
    return {
        "wq_a": dense_param(d_model, (spec.q_lora_rank,), "embed",
                            ("latent",), dtype=dtype),
        "q_norm": Param((spec.q_lora_rank,), ("latent",), init="ones",
                        dtype=dtype),
        "wq_b": dense_param(spec.q_lora_rank, (H, qk), "latent",
                            ("heads", "head_dim"), dtype=dtype),
        "wkv_a": dense_param(d_model, (spec.kv_lora_rank + spec.qk_rope_dim,),
                             "embed", ("latent",), dtype=dtype),
        "kv_norm": Param((spec.kv_lora_rank,), ("latent",), init="ones",
                         dtype=dtype),
        "wk_b": dense_param(spec.kv_lora_rank, (H, spec.qk_nope_dim),
                            "latent", ("heads", "head_dim"), dtype=dtype),
        "wv_b": dense_param(spec.kv_lora_rank, (H, spec.v_head_dim),
                            "latent", ("heads", "head_dim"), dtype=dtype),
        "wo": Param((H, spec.v_head_dim, d_model),
                    ("heads", "head_dim", "embed"),
                    scale=1.0 / math.sqrt(H * spec.v_head_dim), dtype=dtype)}


def _rms(x, scale, eps=1e-6):
    """The latents' RMSNorm: mean square and rsqrt in fp32, times the scale
    in fp32, cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * per_replica(scale, x.dim()).float()).to(x.dtype)


def _mla_q(p, spec: MLASpec, x, positions):
    """(q_nope (dp, b, S, H, nope), q_rope (dp, b, S, H, rope)); q_rope is
    rotated, in fp32 (the tables' dtype)."""
    q_lat = _rms(replica_matmul(x, p["wq_a"]), p["q_norm"])
    q = weight_einsum("rbsl,rlhk->rbshk", q_lat, p["wq_b"])
    q_nope = q[..., :spec.qk_nope_dim]
    q_rope = q[..., spec.qk_nope_dim:]
    c, s = rope_frequencies(spec.qk_rope_dim, positions, spec.rope_theta)
    return q_nope, apply_rope(q_rope, c, s)


def _mla_latent_kv(p, spec: MLASpec, x, positions):
    """(c_kv (dp, b, S, kv_lora), k_rope (dp, b, S, rope)): the normed
    latent and the one rotated RoPE key every head shares."""
    kv = replica_matmul(x, p["wkv_a"])
    c_kv = _rms(kv[..., :spec.kv_lora_rank], p["kv_norm"])
    k_rope = kv[..., spec.kv_lora_rank:]
    c, s = rope_frequencies(spec.qk_rope_dim, positions, spec.rope_theta)
    return c_kv, apply_rope(k_rope[..., None, :], c, s)[..., 0, :]


def _mla_weights(scores, valid, dtype):
    """Masked fp32 softmax of the scores (``NEG_INF`` where ``valid`` is
    False), cast to ``dtype``."""
    return torch.softmax(_masked(scores, valid), dim=-1).to(dtype)


def _rope_scores(q_rope, k_rope):
    """q_rope (dp, b, S, H, r) . k_rope (dp, b, T, r) -> (dp, b, H, S, T),
    in the two operands' promoted dtype (as jnp's einsum)."""
    k_rope = k_rope.to(torch.promote_types(q_rope.dtype, k_rope.dtype))
    return torch.einsum("rbshk,rbtk->rbhst", q_rope.to(k_rope.dtype), k_rope)


def mla_apply(p, spec: MLASpec, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal (optionally windowed) MLA over x (dp, b, S,
    d): keys and values expanded from the latent per head."""
    S = x.shape[2]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    q_nope, q_rope = _mla_q(p, spec, x, positions)
    c_kv, k_rope = _mla_latent_kv(p, spec, x, positions)
    k_nope = weight_einsum("rbtl,rlhk->rbthk", c_kv, p["wk_b"])
    v = weight_einsum("rbtl,rlhk->rbthk", c_kv, p["wv_b"])
    scale = 1.0 / math.sqrt(spec.qk_nope_dim + spec.qk_rope_dim)
    scores = (torch.einsum("rbshk,rbthk->rbhst", q_nope, k_nope)
              + _rope_scores(q_rope, k_rope)).float() * scale
    w = _mla_weights(scores, causal_window_mask(S, S, spec.window,
                                                device=x.device), v.dtype)
    out = torch.einsum("rbhst,rbthk->rbshk", w, v)
    return weight_einsum("rbshk,rhkd->rbsd", out, p["wo"])


def mla_cache_init(spec: MLASpec, batch: int, seq_len: int, dtype, *,
                   device) -> dict:
    L = cache_len(seq_len, spec.window)
    return {"c_kv": torch.zeros((batch, L, spec.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, L, spec.qk_rope_dim), dtype=dtype,
                                  device=device)}


def mla_decode(p, spec: MLASpec, x1: torch.Tensor, cache: dict, pos):
    """Absorbed-latent one-token decode. x1 (dp, b, 1, d); cache leaves
    ``c_kv`` (dp, b, L, kv_lora) and ``k_rope`` (dp, b, L, rope), written
    in place at the token's slot (``attn_decode``'s slot rule). The query
    meets the latents through ``wk_b`` (q_lat = q_nope . wk_b) and the
    weighted latents leave through ``wv_b`` and ``wo``: the per-token cache
    is kv_lora + rope values, MLA's saving. Returns (y (dp, b, 1, d),
    cache)."""
    pos = torch.as_tensor(pos, device=x1.device)
    p1 = pos.reshape(1, 1)
    q_nope, q_rope = _mla_q(p, spec, x1, p1)
    c1, kr1 = _mla_latent_kv(p, spec, x1, p1)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    sp = _seq_stretch(spec.window, c_kv)
    part = c_kv.shape[2]
    L, lo = (part, 0) if sp is None else sp[1:]
    slot = _slot(spec.window, pos, L)
    _write_slot(c_kv, c1, slot, lo, sp is not None)
    _write_slot(k_rope, kr1, slot, lo, sp is not None)
    q_lat = weight_einsum("rbshk,rlhk->rbshl", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(spec.qk_nope_dim + spec.qk_rope_dim)
    scores = (torch.einsum("rbshl,rbtl->rbhst", q_lat, c_kv)
              + _rope_scores(q_rope, k_rope)).float() * scale
    valid = _valid(spec.window, L, lo, part, slot, pos, x1.device)
    if sp is None:
        w = _mla_weights(scores, valid, c_kv.dtype)
        lat = torch.einsum("rbhst,rbtl->rbshl", w, c_kv)
    else:   # the weighted latents over the stretch, combined
        lat = _seq_combine(_masked(scores, valid), valid, c_kv,
                           "rbhst,rbtl->rbhsl", sp[0],
                           c_kv.dtype).transpose(2, 3)
    out = weight_einsum("rbshl,rlhk->rbshk", lat, p["wv_b"])
    return weight_einsum("rbshk,rhkd->rbsd", out, p["wo"]), cache
