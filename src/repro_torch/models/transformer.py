"""Decoder-only language model with tied or untied unembedding, the
encoder-decoder (whisper) and vision-stub (llava) variants, and
DeepSeek-V3's multi-token prediction (MTP) head.

Port of ``repro/models/transformer.py`` (``lm_init``, ``_enc_segs``,
``encode_audio``, ``lm_apply``, ``_embed_lookup``, ``_unembed``, and
serving's ``lm_cache_init``, ``lm_decode``, ``lm_prefill``,
``_fill_cross_kv``) for the dense attention, vision-stub, encoder-decoder,
Mamba-1, routed-MoE and MLA families.
``lm_specs`` gives the param tree as ``ParamSpec``s (the reference's leaf
paths and shapes, nothing allocated); ``lm_axes`` their logical-axes
annotations, the tree the reference's ``lm_init`` returns second;
``lm_init`` draws the params from a
``torch.Generator`` with the reference's distributions (``layers.draw``:
normal x fan-in scale, embedding scale 0.02, norm scales of one, Mamba's
dt bias and A_log). ``lm_apply`` takes params
with a leading replica axis and tokens ``(dp, b, S)`` and returns
``(logits, aux)``, aux the MoE layers' ``moe_aux`` and
``moe_dropped_frac`` summed over the layers, each ``(dp,)``. A VLM's image
embeddings (the vision tower is a stub: precomputed patch embeddings) are
prepended to the token embeddings, cast to their dtype, and the image
positions' logits are dropped. With ``cfg.mtp`` the params hold an
``mtp`` subtree (``block``, ``proj``, ``norm_h``, ``norm_e``) and aux
holds ``mtp_logits`` (dp, b, S-1, V): at position t the head predicts
token t+2 from the final-normed hidden state and the embedding of token
t+1, through one block of the last layer's spec (outside the stack: no
repeat axis, no remat, its MoE aux discarded). An enc-dec model's audio
frames (the conv/mel frontend is a stub: precomputed frame embeddings
``(dp, b, F, d)``) run through the encoder (``encode_audio``, no remat, as the
reference's), whose output every decoder layer's cross-attention reads.

The serving functions take one replica as the reference's do: params
without a replica axis, caches in ``lm_cache_init``'s tree (leaves
``(R, b, ...)``), ``pos`` a scalar (an int or a 0-d device tensor). They
view every leaf as ``(1, ...)`` for the model code, run without autograd,
and write the caches in place (the reference's serve step donates them).
An enc-dec prefill runs the encoder once and writes every cross-attention
layer's keys and values into the cache (``_fill_cross_kv``), so decode
never runs the encoder.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_map

from . import blocks as B
from .config import BlockSpec, ModelConfig
from .layers import (Param, draw, dtype_of, embed_init, norm_apply, norm_init,
                     per_replica, replica_matmul, weight_einsum)

__all__ = ["lm_specs", "lm_axes", "lm_init", "lm_apply", "lm_cache_init",
           "lm_decode", "lm_prefill", "encode_audio"]


def lm_specs(cfg: ModelConfig) -> Dict:
    """ParamSpec tree of one replica, in the reference's layout."""
    dtype = dtype_of(cfg.param_dtype)
    p: Dict = {"embed": embed_init(cfg.vocab, cfg.d_model, dtype)}
    p["layers"], _ = B.stack_init(cfg, cfg.blocks, dtype)
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = Param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                             scale=cfg.d_model ** -0.5, dtype=dtype)
    if cfg.encoder is not None:
        p["encoder"] = {
            "layers": B.stack_init(cfg, _enc_blocks(cfg), dtype)[0],
            "norm": norm_init(cfg.norm, cfg.d_model, dtype),
            "pos": Param((cfg.encoder.n_frames, cfg.d_model), (None, "embed"),
                         scale=0.02, dtype=dtype)}
    if cfg.mtp:
        p["mtp"] = {
            "block": B.block_init(cfg, cfg.blocks[-1], dtype),
            "proj": Param((2 * cfg.d_model, cfg.d_model),
                          ("embed", "embed_out"),
                          scale=(2 * cfg.d_model) ** -0.5, dtype=dtype),
            "norm_h": norm_init(cfg.norm, cfg.d_model, dtype),
            "norm_e": norm_init(cfg.norm, cfg.d_model, dtype)}
    return p


def _enc_blocks(cfg: ModelConfig):
    return tuple(BlockSpec(kind="attn", attn=cfg.encoder.attn,
                           d_ff=cfg.encoder.d_ff, mlp_act="gelu")
                 for _ in range(cfg.encoder.n_layers))


def _enc_segs(cfg: ModelConfig):
    return B.segments_of(_enc_blocks(cfg))


def lm_axes(cfg: ModelConfig) -> Dict:
    """Logical-axes annotation of every leaf of ``lm_specs(cfg)`` (a string
    per leaf, ``layers.ax``); the stacked layer axis is unannotated."""
    return tree_map(lambda s: s.axes, lm_specs(cfg))


def lm_init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    """Draw one replica's params (no replica axis), leaf by leaf in the
    tree's flatten order, from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    specs, treedef = tree_flatten(lm_specs(cfg))
    return treedef.unflatten([draw(s, gen, dev) for s in specs])


def _embed_lookup(p, tokens: torch.Tensor) -> torch.Tensor:
    """Per-replica token gather, staged through fp32 as the reference's
    (so the embedding gradient accumulates in fp32 before its cast)."""
    emb = p["embed"]
    rep = torch.arange(emb.shape[0], device=tokens.device)[:, None, None]
    return emb.float()[rep, tokens].to(emb.dtype)


def _embed_gather(p, tokens: torch.Tensor) -> torch.Tensor:
    """Serving's token gather: ``_embed_lookup`` without its fp32 staging of
    the whole table (a copy per call in PyTorch, which XLA fuses away). A
    bf16 -> fp32 -> bf16 round trip is exact, so the rows are the same
    bits."""
    emb = p["embed"]
    rep = torch.arange(emb.shape[0], device=tokens.device)[:, None, None]
    return emb[rep, tokens]


def _unembed(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return replica_matmul(h, p["embed"].transpose(1, 2))
    return replica_matmul(h, p["lm_head"])


def _with_image(cfg: ModelConfig, h: torch.Tensor, image_embeds):
    """h (dp, b, S, d) with the image embeddings (dp, b, Ni, d) prepended,
    cast to h's dtype; a config without the vision stub ignores them, as
    the reference does."""
    if cfg.vision is None or image_embeds is None:
        return h
    return torch.cat([image_embeds.to(h.dtype), h], dim=2)


def encode_audio(p, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The whisper-style encoder over (stub) frame embeddings (dp, b, F, d):
    cast to the compute dtype, plus the learned positions ``pos[:F]``, the
    encoder layers (no remat), the encoder's norm."""
    frames = frames.to(dtype_of(cfg.compute_dtype))
    F = frames.shape[2]
    h = frames + per_replica(p["encoder"]["pos"][:, :F], frames.dim())
    h, _ = B.stack_apply(p["encoder"]["layers"], cfg, _enc_segs(cfg), h)
    return norm_apply(cfg.norm, p["encoder"]["norm"], h)


def _memory(p, cfg: ModelConfig, audio_frames):
    """The encoder's output for an enc-dec config (which needs the frames),
    else None: a config without an encoder ignores them, as the
    reference's does."""
    if cfg.encoder is None:
        return None
    if audio_frames is None:
        raise ValueError(f"{cfg.name} has an audio encoder: pass "
                         "audio_frames")
    return encode_audio(p, cfg, audio_frames)


def lm_apply(p, cfg: ModelConfig, tokens: torch.Tensor,
             image_embeds: Optional[torch.Tensor] = None,
             audio_frames: Optional[torch.Tensor] = None,
             ssm_scan_impl=None, remat: bool = False,
             remat_policy: Optional[str] = None):
    """``(logits (dp, b, S, V), aux)`` over the text positions of tokens
    (dp, b, S); aux holds ``moe_aux`` and ``moe_dropped_frac`` (dp,) fp32,
    summed over the layers (zeros without MoE), and with ``cfg.mtp`` the
    MTP head's ``mtp_logits`` (dp, b, S-1, V). A VLM (``cfg.vision``)
    needs ``image_embeds`` (dp, b, Ni, d): they are prepended and their
    positions' logits dropped. An enc-dec model (``cfg.encoder``) needs
    ``audio_frames`` (dp, b, F, d), which feed the encoder and every
    cross-attention layer. ``ssm_scan_impl`` replaces every Mamba layer's
    scan (e.g. ``repro_torch.kernels.ssm_scan``, the CUDA kernel, for
    scoring); ``remat`` and ``remat_policy`` checkpoint the decoder's
    layers (``blocks.stack_apply``)."""
    if cfg.vision is not None and image_embeds is None:
        raise ValueError(f"{cfg.name} has a vision stub: pass image_embeds")
    h = _with_image(cfg, _embed_lookup(p, tokens), image_embeds)
    n_img = h.shape[2] - tokens.shape[2]
    memory = _memory(p, cfg, audio_frames)
    h, aux = B.stack_apply(p["layers"], cfg, B.segments_of(cfg.blocks), h,
                           memory=memory, ssm_scan_impl=ssm_scan_impl,
                           remat=remat, remat_policy=remat_policy)
    h = norm_apply(cfg.norm, p["final_norm"], h)
    if n_img:
        h = h[:, :, n_img:]
    logits = _unembed(p, cfg, h)
    if cfg.mtp:
        aux = dict(aux, mtp_logits=_mtp_logits(p, cfg, h, tokens))
    return logits, aux


def _mtp_logits(p, cfg: ModelConfig, h: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """The MTP head: position t predicts token t+2 from (h_t, embed of
    token t+1); h (dp, b, S, d) after the final norm."""
    m = p["mtp"]
    ht = norm_apply(cfg.norm, m["norm_h"], h[:, :, :-1])
    et = norm_apply(cfg.norm, m["norm_e"], _embed_lookup(p, tokens[:, :, 1:]))
    hm = replica_matmul(torch.cat([ht, et], dim=-1), m["proj"])
    hm, _ = B.block_apply(m["block"], cfg, cfg.blocks[-1], hm)
    return _unembed(p, cfg, hm)


# ===================================================================== serve
def _one_replica(tree):
    """Every leaf viewed as (1, ...): the model code's replica axis."""
    return tree_map(lambda w: w.unsqueeze(0), tree)


def lm_cache_init(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
                  device="cuda"):
    """Zero decode caches for ``batch`` sequences of up to ``seq_len``
    positions, in the reference's tree (dtype: the param dtype); an enc-dec
    model's cross-attention layers also hold ``n_frames`` encoder keys and
    values."""
    dtype = dtype or dtype_of(cfg.param_dtype)
    n_frames = cfg.encoder.n_frames if cfg.encoder is not None else 0
    return B.stack_cache_init(cfg, B.segments_of(cfg.blocks), batch, seq_len,
                              dtype, n_frames, device=resolve_device(device))


@torch.no_grad()
def lm_decode(p, cfg: ModelConfig, token: torch.Tensor, caches, pos):
    """One decode step: token (B,), pos scalar -> (logits (B, V), caches),
    the caches written in place."""
    p1 = _one_replica(p)
    h = _embed_gather(p1, token[None, :, None])                 # (1,B,1,d)
    h, _ = B.stack_decode(p1["layers"], cfg, B.segments_of(cfg.blocks), h,
                          _one_replica(caches), pos)
    h = norm_apply(cfg.norm, p1["final_norm"], h)
    return _unembed(p1, cfg, h)[0, :, 0], caches


@torch.no_grad()
def lm_prefill(p, cfg: ModelConfig, tokens: torch.Tensor, caches,
               image_embeds=None, audio_frames=None):
    """Process a full prompt (B, S), filling the decode caches; returns
    (last-position logits (B, V), caches). A VLM's ``image_embeds``
    (B, Ni, d) come first: the caches then hold Ni + S positions. An
    enc-dec model's ``audio_frames`` (B, F, d) run through the encoder once,
    and every cross-attention layer's keys and values of its output go into
    the caches."""
    p1 = _one_replica(p)
    segs = B.segments_of(cfg.blocks)
    caches1 = _one_replica(caches)
    memory = _memory(p1, cfg, None if audio_frames is None
                     else audio_frames[None])
    if memory is not None:
        _fill_cross_kv(p1, segs, caches1, memory)
    h = _with_image(cfg, _embed_gather(p1, tokens[None]),
                    None if image_embeds is None else image_embeds[None])
    h, caches1 = B.stack_prefill(p1["layers"], cfg, segs, h, caches1)
    h = norm_apply(cfg.norm, p1["final_norm"], h)
    return (_unembed(p1, cfg, h[:, :, -1])[0],
            tree_map(lambda c: c[0], caches1))


def _fill_cross_kv(p, segs, caches, memory: torch.Tensor) -> None:
    """Every cross-attention layer's keys and values of the encoder's
    output ``memory`` (1, B, F, d), written in place into its ``mem_k`` /
    ``mem_v`` cache leaves (1, R, B, F, K, hd)."""
    for (pattern, R), seg_p, seg_c in zip(segs, p["layers"], caches):
        for spec, bp, bc in zip(pattern, seg_p, seg_c):
            if spec.cross_attn is None:
                continue
            for r in range(R):
                for w, leaf in (("wk", "mem_k"), ("wv", "mem_v")):
                    bc[leaf][:, r].copy_(weight_einsum(
                        "rbtd,rdhk->rbthk", memory, bp["cross"][w][:, r]))
