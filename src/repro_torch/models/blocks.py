"""Residual blocks and the depth stacker.

Port of ``repro/models/blocks.py`` (``AUX_KEYS``, ``segments_of``,
``block_init``, ``_zero_aux``, ``block_apply``, ``stack_init``,
``stack_apply``, and serving's ``block_cache_init``, ``block_decode``,
``_cache_write_seq``, ``block_prefill``, ``stack_cache_init``,
``stack_decode``, ``stack_prefill``) for attention, MLA and Mamba-1
blocks. A block is pre-norm residual: ``h += mixer(norm1(h))``
(attention, MLA or the Mamba mixer); in an enc-dec decoder
``h += cross(norm_x(h), memory)``; then ``h += moe(norm2(h))`` or, if ``d_ff``, ``h += mlp(norm2(h))``.
The self mixer runs inside the ``repro.mixer`` span (``repro_torch.spans``),
and inside it ``repro.mixer.attn`` (attention, MLA) or ``repro.mixer.mamba``.
``block_apply`` returns ``(h, aux)``: the MoE layer's ``moe_aux`` and
``moe_dropped_frac`` per replica (zeros without MoE), which
``stack_apply`` sums over every layer.
``ssm_scan_impl`` reaches every Mamba mixer's ``scan_impl``; ``remat``
checkpoints each block (``torch.utils.checkpoint``),
``remat_policy="dots"`` saving the weight products' outputs and
``"save_moe_combine"`` each MoE layer's combined output.

The param tree keeps the reference's leaf paths and shapes: a list over
segments, each a list over pattern positions of block params stacked on a
leading repeat axis (the reference scans over it). With the replica axis in
front a stacked leaf is ``(dp, R, ...)``; ``stack_apply`` loops over the
repeats in Python where the reference runs ``lax.scan``. Decode caches have
the same tree: ``stack_cache_init`` returns one replica's, leaves
``(R, b, ...)``; ``stack_decode`` and ``stack_prefill`` take them with the
replica axis, ``(dp, R, b, ...)``, and write each layer's view in place. A
cross-attention layer's cache also holds the encoder's keys and values
(``mem_k``, ``mem_v``: ``(b, n_frames, K, hd)``), which
``transformer.lm_prefill`` fills and decode only reads. Under a
sequence-parallel serve step (``dist_ctx.current_seq()``) prefill still
computes every position's keys and values and writes into a split leaf
only its stretch's positions (``_cache_write_seq``'s ``lo``, ``length``).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.spans import MIXER, MIXER_ATTN, MIXER_MAMBA, span
from repro_torch.tree import tree_flatten, tree_map

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import BlockSpec, ModelConfig
from .layers import (mlp_apply, mlp_init, norm_apply, norm_init, per_replica,
                     replica_matmul, silu, weight_products)

__all__ = ["segments_of", "block_init", "block_apply", "stack_init",
           "stack_apply", "block_cache_init", "block_decode", "block_prefill",
           "stack_cache_init", "stack_decode", "stack_prefill", "AUX_KEYS"]

AUX_KEYS = ("moe_aux", "moe_dropped_frac")


def segments_of(blocks: Sequence[BlockSpec]) -> List[Tuple[Tuple[BlockSpec, ...], int]]:
    """[(pattern, repeats), ...] — periodic if possible, else maximal runs."""
    L = len(blocks)
    for P in range(1, min(16, L - 1) + 1):
        if L % P == 0 and all(blocks[i] == blocks[i % P] for i in range(L)):
            return [(tuple(blocks[:P]), L // P)]
    segs: List[Tuple[Tuple[BlockSpec, ...], int]] = []
    i = 0
    while i < L:
        j = i
        while j < L and blocks[j] == blocks[i]:
            j += 1
        segs.append(((blocks[i],), j - i))
        i = j
    return segs


def _check_kind(spec: BlockSpec) -> None:
    if spec.kind not in ("attn", "mla", "mamba"):
        raise ValueError(spec.kind)


def block_init(cfg: ModelConfig, spec: BlockSpec, dtype) -> Dict:
    _check_kind(spec)
    p: Dict = {"norm1": norm_init(cfg.norm, cfg.d_model, dtype)}
    if spec.kind == "attn":
        p["mixer"] = attn_mod.attn_init(cfg.d_model, spec.attn, dtype)
    elif spec.kind == "mla":
        p["mixer"] = attn_mod.mla_init(cfg.d_model, spec.mla, dtype)
    else:
        p["mixer"] = mamba_mod.mamba_init(cfg.d_model, spec.ssm, dtype)
    if spec.cross_attn is not None:
        p["norm_x"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["cross"] = attn_mod.attn_init(cfg.d_model, spec.cross_attn, dtype)
    if spec.moe is not None:
        p["norm2"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["ff"] = moe_mod.moe_init(cfg.d_model, spec.moe, dtype)
    elif spec.d_ff:
        p["norm2"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["ff"] = mlp_init(cfg.d_model, spec.d_ff, spec.mlp_act, dtype)
    return p


def _zero_aux(dp: int, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(dp, dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def block_apply(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                ssm_scan_impl=None) -> Tuple[torch.Tensor, Dict]:
    """One block over h (dp, b, S, d); ``memory`` (dp, b, F, d) feeds a
    cross-attention layer. Returns (h, aux), aux's values (dp,) fp32."""
    _check_kind(spec)
    x = norm_apply(cfg.norm, p["norm1"], h)
    with span(MIXER), span(MIXER_MAMBA if spec.kind == "mamba"
                           else MIXER_ATTN):
        if spec.kind == "attn":
            h = h + attn_mod.attn_apply(p["mixer"], spec.attn, x,
                                        positions=positions)
        elif spec.kind == "mla":
            h = h + attn_mod.mla_apply(p["mixer"], spec.mla, x,
                                       positions=positions)
        else:
            h = h + mamba_mod.mamba_apply(p["mixer"], spec.ssm, cfg.d_model,
                                          x, scan_impl=ssm_scan_impl)
    if spec.cross_attn is not None:
        xc = norm_apply(cfg.norm, p["norm_x"], h)
        h = h + attn_mod.attn_apply(p["cross"], spec.cross_attn, xc,
                                    memory=memory)
    h, aux = _ffn(p, cfg, spec, h)
    return h, aux if aux is not None else _zero_aux(h.shape[0], h.device)


def _ffn(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor):
    """The block's MoE or MLP sub-layer: (h, the MoE's aux or None)."""
    if spec.moe is not None:
        x2 = norm_apply(cfg.norm, p["norm2"], h)
        y, m = moe_mod.moe_apply(p["ff"], spec.moe, x2)
        return h + y, {k: m[k].float() for k in AUX_KEYS}
    if spec.d_ff:
        x2 = norm_apply(cfg.norm, p["norm2"], h)
        h = h + mlp_apply(p["ff"], x2, spec.mlp_act)
    return h, None


def _cross_cached(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor,
                  cache: Dict) -> torch.Tensor:
    """Serving's cross-attention sub-layer over the cached encoder keys and
    values (any number of query positions, no mask)."""
    if spec.cross_attn is None:
        return h
    xc = norm_apply(cfg.norm, p["norm_x"], h)
    y, _ = attn_mod.attn_decode(p["cross"], spec.cross_attn, xc, {}, 0,
                                memory_kv=(cache["mem_k"], cache["mem_v"]))
    return h + y


# ----------------------------------------------------------------- caches
def block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     seq_len: int, dtype, n_frames: int = 0, *,
                     device) -> Dict:
    _check_kind(spec)
    if spec.kind == "attn":
        c = {"kv": attn_mod.attn_cache_init(spec.attn, batch, seq_len, dtype,
                                            device=device)}
    elif spec.kind == "mla":
        c = {"kv": attn_mod.mla_cache_init(spec.mla, batch, seq_len, dtype,
                                           device=device)}
    else:
        c = {"ssm": mamba_mod.mamba_state_init(spec.ssm, cfg.d_model, batch,
                                               dtype, device=device)}
    if spec.cross_attn is not None:
        ca = spec.cross_attn
        shp = (batch, n_frames, ca.n_kv_heads, ca.head_dim)
        c["mem_k"] = torch.zeros(shp, dtype=dtype, device=device)
        c["mem_v"] = torch.zeros(shp, dtype=dtype, device=device)
    return c


def block_decode(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor,
                 cache: Dict, pos) -> Tuple[torch.Tensor, Dict]:
    """One token through one block; h (dp, b, 1, d), the cache written in
    place."""
    _check_kind(spec)
    x = norm_apply(cfg.norm, p["norm1"], h)
    new_cache = dict(cache)
    if spec.kind == "attn":
        y, new_cache["kv"] = attn_mod.attn_decode(p["mixer"], spec.attn, x,
                                                  cache["kv"], pos)
    elif spec.kind == "mla":
        y, new_cache["kv"] = attn_mod.mla_decode(p["mixer"], spec.mla, x,
                                                 cache["kv"], pos)
    else:
        y, new_cache["ssm"] = mamba_mod.mamba_decode(
            p["mixer"], spec.ssm, cfg.d_model, x, cache["ssm"])
    h = _cross_cached(p, cfg, spec, h + y, cache)
    return _ffn(p, cfg, spec, h)[0], new_cache


def _cache_write_seq(cache_arr: torch.Tensor, full: torch.Tensor,
                     axis: int = 1, lo: int = 0,
                     length: Optional[int] = None) -> torch.Tensor:
    """Write a full prefill sequence (positions 0..S-1 along ``axis``) into
    a decode cache of length L, in place, and return the cache. If L < S
    (sliding-window ring buffer), keep the last L positions at their ring
    slots (pos % L); else write at the front.

    With ``length`` the cache is a stretch of a cache of ``length``
    positions starting at ``lo`` (the sequence-parallel cache): it takes
    positions ``[lo, lo + its length)`` of what the whole-length write
    would hold, and keeps what it holds where that write writes nothing."""
    part, S = cache_arr.shape[axis], full.shape[axis]
    L = part if length is None else length
    full = full.to(cache_arr.dtype)
    if S <= L:
        n = min(S, lo + part) - lo
        if n > 0:
            cache_arr.narrow(axis, 0, n).copy_(full.narrow(axis, lo, n))
    else:
        tail = full.narrow(axis, S - L, L)
        cache_arr.copy_(torch.roll(tail, (S - L) % L, axis).narrow(
            axis, lo, part))
    return cache_arr


def _stretch_of(window, leaf: torch.Tensor):
    """(lo, length) of the sequence-parallel stretch ``leaf`` holds
    (``attention._seq_stretch``), or (0, None): the leaf is whole."""
    sp = attn_mod._seq_stretch(window, leaf)
    return (0, None) if sp is None else (sp[2], sp[1])


def block_prefill(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor,
                  cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward over h (dp, b, S, d) that also fills this
    block's decode cache (serving's prefill), with the reference's
    arithmetic: ``_sdpa`` and ``ssm_assoc_scan``, no kernel. Windowed layers
    keep the trailing window in their ring buffer; full-attention layers
    need S <= the cache length. An MLA layer writes its latents
    (``c_kv``, ``k_rope``) and takes its output from the full
    ``mla_apply``, as the reference does. Cross-attention reads the cached
    encoder keys and values (``attn_decode`` over all S positions,
    unmasked)."""
    _check_kind(spec)
    S = h.shape[2]
    x = norm_apply(cfg.norm, p["norm1"], h)
    new_cache = dict(cache)
    if spec.kind == "attn":
        a, m = spec.attn, p["mixer"]
        pos = torch.arange(S, device=h.device)[None]
        q, k, v = attn_mod._project_qkv(m, a, x, x, pos, pos)
        lo, L = _stretch_of(a.window, cache["kv"]["k"])
        new_cache["kv"] = {
            "k": _cache_write_seq(cache["kv"]["k"], k, 2, lo, L),
            "v": _cache_write_seq(cache["kv"]["v"], v, 2, lo, L)}
        mask = attn_mod.causal_window_mask(S, S, a.window, device=h.device)
        out = attn_mod._sdpa(q, k, v, mask, a.n_kv_heads)
        h = h + torch.einsum("rbshk,rhkd->rbsd", out, m["wo"])
    elif spec.kind == "mla":
        m = spec.mla
        pos = torch.arange(S, device=h.device)[None]
        c_kv, k_rope = attn_mod._mla_latent_kv(p["mixer"], m, x, pos)
        kv = cache["kv"]
        lo, L = _stretch_of(m.window, kv["c_kv"])
        new_cache["kv"] = {
            "c_kv": _cache_write_seq(kv["c_kv"], c_kv, 2, lo, L),
            "k_rope": _cache_write_seq(kv["k_rope"], k_rope, 2, lo, L)}
        h = h + attn_mod.mla_apply(p["mixer"], m, x)
    else:
        s, m, st = spec.ssm, p["mixer"], cache["ssm"]
        xz = replica_matmul(x, m["in_proj"])
        xi_pre, z = xz.chunk(2, dim=-1)
        xi = silu(mamba_mod._conv_causal(xi_pre, m["conv_w"], m["conv_b"]))
        dA, dBx, C = mamba_mod._ssm_inputs(m, s, xi,
                                           s.resolved_dt_rank(cfg.d_model))
        shape = dA.shape
        hs = mamba_mod.ssm_assoc_scan(dA.flatten(0, 1),
                                      dBx.flatten(0, 1)).view(shape)
        del dA, dBx
        # the conv state carries the PRE-conv tail (what decode's window
        # needs); a prompt shorter than d_conv - 1 leaves a shorter tail,
        # as in the reference, which decode then refuses
        tail = xi_pre[:, :, -(s.d_conv - 1):]
        conv = (st["conv"].copy_(tail) if tail.shape == st["conv"].shape
                else tail.to(st["conv"].dtype))
        new_cache["ssm"] = {"h": st["h"].copy_(hs[:, :, -1]), "conv": conv}
        y = torch.einsum("rbsdn,rbsn->rbsd", hs, C.float()).to(x.dtype)
        del hs
        y = (y + per_replica(m["D"], 4) * xi) * silu(z)
        h = h + replica_matmul(y, m["out_proj"])
    h = _cross_cached(p, cfg, spec, h, cache)
    return _ffn(p, cfg, spec, h)[0], new_cache


# ----------------------------------------------------------------- stacker
def stack_init(cfg: ModelConfig, blocks: Sequence[BlockSpec], dtype):
    """ParamSpec tree: list over segments, each a list over pattern
    positions of block specs stacked on a leading repeat axis."""
    segs = segments_of(blocks)
    params = [[tree_map(lambda s: s.stacked(R), block_init(cfg, spec, dtype))
               for spec in pattern] for pattern, R in segs]
    return params, segs


_MATMULS = (torch.ops.aten.bmm.default, torch.ops.aten.mm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` on the
    port: save the products of activations with weights (the reference's
    dots with no batch dims; here batched over the replica axis only, see
    ``layers.weight_products``), recompute everything else, attention
    scores and the scan included."""
    if op in _MATMULS and weight_products():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_moe_combine(ctx, op, *args, **kwargs):
    """``save_only_these_names("moe_combine")`` on the port: save each MoE
    layer's combined output (the op ``moe.moe_combine_output`` flags),
    recompute everything else."""
    if moe_mod.moe_combine_output():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(policy: Optional[str]):
    """``context_fn`` of ``torch.utils.checkpoint`` for a remat policy."""
    if policy is None:
        return noop_context_fn
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_weight_products)
    if policy == "save_moe_combine":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_moe_combine)
    raise ValueError(f"unknown remat_policy {policy!r}")


def _block_body(cfg: ModelConfig, spec: BlockSpec, treedef, ssm_scan_impl):
    """One block as a function of its input, the running aux sums, the
    encoder's output and the layer's weight views. The block is bound
    here, not read through the caller's loop variables: a checkpointed
    block reruns this function in backward, after the loop has moved on."""
    def body(hh, aux, memory, positions, *ws):
        hh, a = block_apply(treedef.unflatten(ws), cfg, spec, hh,
                            memory=memory, positions=positions,
                            ssm_scan_impl=ssm_scan_impl)
        return hh, {k: aux[k] + a[k] for k in AUX_KEYS}
    return body


def stack_apply(params, cfg: ModelConfig, segs, h: torch.Tensor,
                memory: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                ssm_scan_impl=None, remat: bool = False,
                remat_policy: Optional[str] = None):
    """Run every layer; returns (h, aux), aux's values (dp,) fp32 summed
    over the layers in order (the reference's scan carry). Stacked leaves
    are (dp, R, ...) and layer r of a segment reads the r-th view of
    ``leaf.unbind(1)``. One unbind per leaf, not one index per layer:
    backward then stacks the R layer gradients in one pass instead of
    adding R leaf-sized zero-padded ones.

    ``remat=True`` checkpoints each block, one region a layer, with
    ``torch.utils.checkpoint(use_reentrant=False)``, its input, the aux
    sums, ``memory`` and its weight views passed as inputs: backward
    recomputes one layer at a time from its input instead of saving its
    internals for the whole depth (the reference checkpoints its scan
    body, a whole repeat of the pattern; a hybrid's 14-layer repeat would
    hold 13 Mamba layers' internals at once). For a pattern of one block
    the two are the same regions. Remat changes no value.
    ``remat_policy="dots"`` saves the weight products' outputs
    (``_save_weight_products``), ``"save_moe_combine"`` each MoE layer's
    combined output (``_save_moe_combine``)."""
    context_fn = _remat_context(remat_policy) if remat else None
    aux = _zero_aux(h.shape[0], h.device)
    for (pattern, R), seg_p in zip(segs, params):
        per_pos = []
        for spec, bp in zip(pattern, seg_p):
            leaves, treedef = tree_flatten(bp)
            per_pos.append((_block_body(cfg, spec, treedef, ssm_scan_impl),
                            [w.unbind(1) for w in leaves]))
        for r in range(R):
            for body, layers in per_pos:
                ws = [views[r] for views in layers]
                h, aux = (checkpoint(body, h, aux, memory, positions, *ws,
                                     use_reentrant=False,
                                     context_fn=context_fn)
                          if remat else body(h, aux, memory, positions, *ws))
    return h, aux


def stack_cache_init(cfg: ModelConfig, segs, batch: int, seq_len: int, dtype,
                     n_frames: int = 0, *, device) -> List:
    """One replica's decode caches: per segment, per pattern position, the
    block's cache stacked on a leading repeat axis, all zeros."""
    return [[tree_map(lambda c: c.new_zeros((R,) + tuple(c.shape)),
                      block_cache_init(cfg, spec, batch, seq_len, dtype,
                                       n_frames, device=device))
             for spec in pattern] for pattern, R in segs]


def _layers(tree, R: int):
    """The R per-layer trees of views ``leaf[:, r]`` of a stacked tree."""
    leaves, treedef = tree_flatten(tree)
    views = [w.unbind(1) for w in leaves]
    return [treedef.unflatten([v[r] for v in views]) for r in range(R)]


def stack_decode(params, cfg: ModelConfig, segs, h: torch.Tensor, caches,
                 pos):
    """Every layer's one-token decode; params (dp, R, ...), caches
    (dp, R, b, ...) written in place through each layer's view."""
    for (pattern, R), seg_p, seg_c in zip(segs, params, caches):
        per_pos = [(_layers(bp, R), _layers(bc, R))
                   for bp, bc in zip(seg_p, seg_c)]
        for r in range(R):
            for spec, (ps, cs) in zip(pattern, per_pos):
                h, _ = block_decode(ps[r], cfg, spec, h, cs[r], pos)
    return h, caches


def stack_prefill(params, cfg: ModelConfig, segs, h: torch.Tensor, caches):
    """Every layer's prefill; the caches (dp, R, b, ...) are filled in place
    through each layer's view, except a leaf whose layers returned other
    tensors (the short Mamba conv tail), which is stacked anew."""
    new_caches = []
    for (pattern, R), seg_p, seg_c in zip(segs, params, caches):
        per_pos = [(_layers(bp, R), _layers(bc, R))
                   for bp, bc in zip(seg_p, seg_c)]
        outs = [[] for _ in pattern]
        for r in range(R):
            for i, (spec, (ps, cs)) in enumerate(zip(pattern, per_pos)):
                h, nc = block_prefill(ps[r], cfg, spec, h, cs[r])
                outs[i].append(nc)
        seg_new = []
        for bc, (_, cs), layer_outs in zip(seg_c, per_pos, outs):
            leaves, treedef = tree_flatten(bc)
            given = [tree_flatten(c)[0] for c in cs]
            got = [tree_flatten(c)[0] for c in layer_outs]
            seg_new.append(treedef.unflatten([
                w if all(g[j] is o[j] for g, o in zip(given, got))
                else torch.stack([o[j] for o in got], dim=1)
                for j, w in enumerate(leaves)]))
        new_caches.append(seg_new)
    return h, new_caches
