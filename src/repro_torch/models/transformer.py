"""Decoder-only language model with tied or untied unembedding.

Port of ``repro/models/transformer.py`` (``lm_init``, ``lm_apply``,
``_embed_lookup``, ``_unembed``) for the dense attention and Mamba-1
families.
``lm_specs`` gives the param tree as ``ParamSpec``s (the reference's leaf
paths and shapes, nothing allocated); ``lm_axes`` their logical-axes
annotations, the tree the reference's ``lm_init`` returns second;
``lm_init`` draws the params from a
``torch.Generator`` with the reference's distributions (``layers.draw``:
normal x fan-in scale, embedding scale 0.02, norm scales of one, Mamba's
dt bias and A_log). ``lm_apply`` takes params
with a leading replica axis and tokens ``(dp, b, S)``.

The encoder, vision, MTP, decode and prefill paths wait for their model
families and serving (ROADMAP A.13, A.14).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_map

from . import blocks as B
from .config import ModelConfig
from .layers import (Param, draw, dtype_of, embed_init, norm_apply, norm_init,
                     replica_matmul)

__all__ = ["lm_specs", "lm_axes", "lm_init", "lm_apply"]


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


def _unembed(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return replica_matmul(h, p["embed"].transpose(1, 2))
    return replica_matmul(h, p["lm_head"])


def lm_apply(p, cfg: ModelConfig, tokens: torch.Tensor,
             ssm_scan_impl=None) -> torch.Tensor:
    """Logits (dp, b, S, V) for tokens (dp, b, S). ``ssm_scan_impl``
    replaces every Mamba layer's scan (e.g. ``repro_torch.kernels.ssm_scan``,
    the CUDA kernel, for scoring)."""
    h = _embed_lookup(p, tokens)
    h = B.stack_apply(p["layers"], cfg, B.segments_of(cfg.blocks), h,
                      ssm_scan_impl=ssm_scan_impl)
    h = norm_apply(cfg.norm, p["final_norm"], h)
    return _unembed(p, cfg, h)
