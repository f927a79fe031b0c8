"""Model configuration schema for the dense attention, vision-stub and
Mamba-1 families.

Port of ``repro/models/config.py`` (``AttnSpec``, ``SSMSpec``,
``BlockSpec``, ``VisionStubSpec``, ``ModelConfig``, ``reduced``). The MLA
and MoE fields, the encoder and the audio stub wait for their families
(ROADMAP A.13c-e); a config that needs them cannot be expressed here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["AttnSpec", "SSMSpec", "BlockSpec", "VisionStubSpec",
           "ModelConfig", "reduced"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Multi-head attention (MHA/GQA) with optional qk-norm, partial rotary
    and sliding window. ``window=None`` means full causal attention."""
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_frac: float = 1.0          # stablelm-2 uses 0.25 (partial rotary)
    rope_theta: float = 10000.0
    window: Optional[int] = None
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba-1 selective SSM [arXiv:2312.00752 / falcon-mamba 2410.05355]."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None   # default ceil(d_model/16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return (self.dt_rank if self.dt_rank is not None
                else max(1, math.ceil(d_model / 16)))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual layer: ``kind`` "attn" (attention, then a dense (Swi)GLU
    MLP if d_ff) or "mamba" (the Mamba-1 mixer alone: falcon-mamba has
    d_ff = 0)."""
    kind: str
    attn: Optional[AttnSpec] = None
    ssm: Optional[SSMSpec] = None
    d_ff: int = 0
    mlp_act: str = "swiglu"         # "swiglu" | "gelu"


@dataclasses.dataclass(frozen=True)
class VisionStubSpec:
    """The VLM vision tower is a stub: inputs are precomputed patch
    embeddings (B, n_image_tokens, d_model). llava-next's anyres tiling is
    the token count (base 576 + 4 tiles x 576)."""
    n_image_tokens: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    blocks: Tuple[BlockSpec, ...]
    norm: str = "rms"               # "rms" | "ln" | "nonparam" (olmo)
    tie_embeddings: bool = False
    vision: Optional[VisionStubSpec] = None     # llava
    max_seq: int = 8192
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    dist_mode: str = "replica"
    source: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.blocks)


def _shrink_attn(a: Optional[AttnSpec], heads: int,
                 head_dim: int) -> Optional[AttnSpec]:
    if a is None:
        return None
    return dataclasses.replace(
        a, n_heads=heads, n_kv_heads=min(a.n_kv_heads, heads),
        head_dim=head_dim, window=min(a.window, 64) if a.window else None)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 128,
            vocab: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family, as the reference's
    ``reduced``: <= 2 layers, 4 heads, d_ff = 2 * d_model, d_state 8 and
    dt_rank d_model // 16, 8 image tokens, tiny vocab."""
    heads = 4
    head_dim = d_model // heads
    blocks = [dataclasses.replace(
        b, attn=_shrink_attn(b.attn, heads, head_dim),
        ssm=(dataclasses.replace(b.ssm, d_state=8,
                                 dt_rank=max(1, d_model // 16))
             if b.ssm is not None else None),
        d_ff=(2 * d_model if b.d_ff else 0))
        for b in cfg.blocks[:n_layers]]
    while len(blocks) < n_layers:
        blocks.append(blocks[-1])
    vision = VisionStubSpec(n_image_tokens=8) if cfg.vision is not None \
        else None
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=d_model,
                               vocab=vocab, blocks=tuple(blocks), vision=vision,
                               max_seq=256, dist_mode="replica")
