"""Residual blocks and the depth stacker.

Port of ``repro/models/blocks.py`` (``segments_of``, ``block_init``,
``block_apply``, ``stack_init``, ``stack_apply``) for attention and Mamba-1
blocks. A block is pre-norm residual: ``h += mixer(norm1(h))`` (attention
or the Mamba mixer) then, if ``d_ff``, ``h += mlp(norm2(h))``.
``ssm_scan_impl`` reaches every Mamba mixer's ``scan_impl``. MLA, MoE and
cross-attention blocks wait for their families (ROADMAP A.13).

The param tree keeps the reference's leaf paths and shapes: a list over
segments, each a list over pattern positions of block params stacked on a
leading repeat axis (the reference scans over it). With the replica axis in
front a stacked leaf is ``(dp, R, ...)``; ``stack_apply`` loops over the
repeats in Python where the reference runs ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map

from . import attention as attn_mod
from . import mamba as mamba_mod
from .config import BlockSpec, ModelConfig
from .layers import mlp_apply, mlp_init, norm_apply, norm_init

__all__ = ["segments_of", "block_init", "block_apply", "stack_init",
           "stack_apply"]


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
    if spec.kind not in ("attn", "mamba"):
        raise NotImplementedError(
            f"block kind {spec.kind!r} is not ported yet (ROADMAP A.13)")


def block_init(cfg: ModelConfig, spec: BlockSpec, dtype) -> Dict:
    _check_kind(spec)
    p: Dict = {"norm1": norm_init(cfg.norm, cfg.d_model, dtype)}
    if spec.kind == "attn":
        p["mixer"] = attn_mod.attn_init(cfg.d_model, spec.attn, dtype)
    else:
        p["mixer"] = mamba_mod.mamba_init(cfg.d_model, spec.ssm, dtype)
    if spec.d_ff:
        p["norm2"] = norm_init(cfg.norm, cfg.d_model, dtype)
        p["ff"] = mlp_init(cfg.d_model, spec.d_ff, spec.mlp_act, dtype)
    return p


def block_apply(p, cfg: ModelConfig, spec: BlockSpec, h: torch.Tensor,
                ssm_scan_impl=None) -> torch.Tensor:
    _check_kind(spec)
    x = norm_apply(cfg.norm, p["norm1"], h)
    if spec.kind == "attn":
        h = h + attn_mod.attn_apply(p["mixer"], spec.attn, x)
    else:
        h = h + mamba_mod.mamba_apply(p["mixer"], spec.ssm, cfg.d_model, x,
                                      scan_impl=ssm_scan_impl)
    if spec.d_ff:
        x2 = norm_apply(cfg.norm, p["norm2"], h)
        h = h + mlp_apply(p["ff"], x2, spec.mlp_act)
    return h


def stack_init(cfg: ModelConfig, blocks: Sequence[BlockSpec], dtype):
    """ParamSpec tree: list over segments, each a list over pattern
    positions of block specs stacked on a leading repeat axis."""
    segs = segments_of(blocks)
    params = [[tree_map(lambda s: s.stacked(R), block_init(cfg, spec, dtype))
               for spec in pattern] for pattern, R in segs]
    return params, segs


def stack_apply(params, cfg: ModelConfig, segs, h: torch.Tensor,
                ssm_scan_impl=None) -> torch.Tensor:
    """Run every layer; stacked leaves are (dp, R, ...) and layer r of a
    segment reads the r-th view of ``leaf.unbind(1)``. One unbind per leaf,
    not one index per layer: backward then stacks the R layer gradients in
    one pass instead of adding R leaf-sized zero-padded ones."""
    for (pattern, R), seg_p in zip(segs, params):
        per_pos = []
        for bp in seg_p:
            leaves, treedef = tree_flatten(bp)
            per_pos.append((treedef, [w.unbind(1) for w in leaves]))
        for r in range(R):
            for spec, (treedef, layers) in zip(pattern, per_pos):
                bp_r = treedef.unflatten([ws[r] for ws in layers])
                h = block_apply(bp_r, cfg, spec, h,
                                ssm_scan_impl=ssm_scan_impl)
    return h
