"""Decoder-only language model with tied or untied unembedding.

Port of ``repro/models/transformer.py`` (``lm_init``, ``lm_apply``,
``_embed_lookup``, ``_unembed``, and serving's ``lm_cache_init``,
``lm_decode``, ``lm_prefill``) for the dense attention, vision-stub (llava)
and Mamba-1 families.
``lm_specs`` gives the param tree as ``ParamSpec``s (the reference's leaf
paths and shapes, nothing allocated); ``lm_axes`` their logical-axes
annotations, the tree the reference's ``lm_init`` returns second;
``lm_init`` draws the params from a
``torch.Generator`` with the reference's distributions (``layers.draw``:
normal x fan-in scale, embedding scale 0.02, norm scales of one, Mamba's
dt bias and A_log). ``lm_apply`` takes params
with a leading replica axis and tokens ``(dp, b, S)``. A VLM's image
embeddings (the vision tower is a stub: precomputed patch embeddings) are
prepended to the token embeddings, cast to their dtype, and the image
positions' logits are dropped.

The serving functions take one replica as the reference's do: params
without a replica axis, caches in ``lm_cache_init``'s tree (leaves
``(R, b, ...)``), ``pos`` a scalar (an int or a 0-d device tensor). They
view every leaf as ``(1, ...)`` for the model code, run without autograd,
and write the caches in place (the reference's serve step donates them).

The encoder (audio) and MTP paths wait for their model families (ROADMAP
A.13c, A.13e).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_map

from . import blocks as B
from .config import ModelConfig
from .layers import (Param, draw, dtype_of, embed_init, norm_apply, norm_init,
                     replica_matmul)

_NOT_PORTED = ("audio_frames feed the encoder-decoder family, which is not "
               "ported yet (ROADMAP A.13c)")

__all__ = ["lm_specs", "lm_axes", "lm_init", "lm_apply", "lm_cache_init",
           "lm_decode", "lm_prefill"]


def lm_specs(cfg: ModelConfig) -> Dict:
    """ParamSpec tree of one replica, in the reference's layout."""
    dtype = dtype_of(cfg.param_dtype)
    p: Dict = {"embed": embed_init(cfg.vocab, cfg.d_model, dtype)}
    p["layers"], _ = B.stack_init(cfg, cfg.blocks, dtype)
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        p["lm_head"] = Param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                             scale=cfg.d_model ** -0.5, dtype=dtype)
    return p


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


def lm_apply(p, cfg: ModelConfig, tokens: torch.Tensor,
             image_embeds: Optional[torch.Tensor] = None,
             ssm_scan_impl=None, remat: bool = False,
             remat_policy: Optional[str] = None) -> torch.Tensor:
    """Logits (dp, b, S, V) over the text positions of tokens (dp, b, S).
    A VLM (``cfg.vision``) needs ``image_embeds`` (dp, b, Ni, d): they are
    prepended and their positions' logits dropped. ``ssm_scan_impl``
    replaces every Mamba layer's scan (e.g. ``repro_torch.kernels.ssm_scan``,
    the CUDA kernel, for scoring); ``remat`` and ``remat_policy`` checkpoint
    the layers (``blocks.stack_apply``)."""
    if cfg.vision is not None and image_embeds is None:
        raise ValueError(f"{cfg.name} has a vision stub: pass image_embeds")
    h = _with_image(cfg, _embed_lookup(p, tokens), image_embeds)
    n_img = h.shape[2] - tokens.shape[2]
    h = B.stack_apply(p["layers"], cfg, B.segments_of(cfg.blocks), h,
                      ssm_scan_impl=ssm_scan_impl, remat=remat,
                      remat_policy=remat_policy)
    h = norm_apply(cfg.norm, p["final_norm"], h)
    return _unembed(p, cfg, h[:, :, n_img:] if n_img else h)


# ===================================================================== serve
def _one_replica(tree):
    """Every leaf viewed as (1, ...): the model code's replica axis."""
    return tree_map(lambda w: w.unsqueeze(0), tree)


def lm_cache_init(cfg: ModelConfig, batch: int, seq_len: int, dtype=None, *,
                  device="cuda"):
    """Zero decode caches for ``batch`` sequences of up to ``seq_len``
    positions, in the reference's tree (dtype: the param dtype)."""
    dtype = dtype or dtype_of(cfg.param_dtype)
    return B.stack_cache_init(cfg, B.segments_of(cfg.blocks), batch, seq_len,
                              dtype, device=resolve_device(device))


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
    (B, Ni, d) come first: the caches then hold Ni + S positions."""
    if audio_frames is not None:
        raise NotImplementedError(_NOT_PORTED)
    p1 = _one_replica(p)
    h = _with_image(cfg, _embed_gather(p1, tokens[None]),
                    None if image_embeds is None else image_embeds[None])
    h, caches = B.stack_prefill(p1["layers"], cfg, B.segments_of(cfg.blocks),
                                h, _one_replica(caches))
    h = norm_apply(cfg.norm, p1["final_norm"], h)
    return (_unembed(p1, cfg, h[:, :, -1])[0],
            tree_map(lambda c: c[0], caches))
