"""Model configuration schema for the dense attention, vision-stub,
encoder-decoder, Mamba-1, routed-MoE and MLA (deepseek-v3) families.

Port of ``repro/models/config.py`` (``AttnSpec``, ``MLASpec``,
``SSMSpec``, ``MoESpec``, ``BlockSpec``, ``EncoderSpec``,
``VisionStubSpec``, ``AudioStubSpec``, ``ModelConfig`` with its
``block_kinds``, ``has_ssm`` and ``subquadratic``, ``reduced``), field for
field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["AttnSpec", "MLASpec", "SSMSpec", "MoESpec", "BlockSpec",
           "EncoderSpec", "VisionStubSpec", "AudioStubSpec", "ModelConfig",
           "reduced"]


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
    causal: bool = True             # encoder self-attention sets False
    cross: bool = False             # decoder cross-attention (enc-dec only)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """DeepSeek-V3 Multi-head Latent Attention [arXiv:2412.19437]: queries
    through a ``q_lora_rank`` latent, keys and values through one shared
    ``kv_lora_rank`` latent plus one shared ``qk_rope_dim`` RoPE key."""
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    window: Optional[int] = None


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
class MoESpec:
    """Top-k routed mixture of experts with optional shared expert."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_coef: float = 0.01          # load-balance loss weight
    router_scale: bool = True       # normalize top-k weights to sum 1


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual layer: ``kind`` "attn", "mla" or "mamba" (the mixer),
    then, in an enc-dec decoder, cross-attention (``cross_attn``), then a
    routed MoE (``moe``) or a dense (Swi)GLU MLP (``d_ff`` > 0) or neither
    (the Mamba-1 blocks of falcon-mamba have no MLP)."""
    kind: str
    attn: Optional[AttnSpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    cross_attn: Optional[AttnSpec] = None
    d_ff: int = 0
    moe: Optional[MoESpec] = None
    mlp_act: str = "swiglu"         # "swiglu" | "gelu"


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Audio encoder stack (whisper-style). The conv/mel frontend is a
    stub: inputs are precomputed frame embeddings (B, n_frames, d)."""
    n_layers: int
    n_frames: int
    attn: AttnSpec = None
    d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class VisionStubSpec:
    """The VLM vision tower is a stub: inputs are precomputed patch
    embeddings (B, n_image_tokens, d_model). llava-next's anyres tiling is
    the token count (base 576 + 4 tiles x 576)."""
    n_image_tokens: int


@dataclasses.dataclass(frozen=True)
class AudioStubSpec:
    n_frames: int                   # whisper-base: 1500 post-conv frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    blocks: Tuple[BlockSpec, ...]
    norm: str = "rms"               # "rms" | "ln" | "nonparam" (olmo)
    tie_embeddings: bool = False
    encoder: Optional[EncoderSpec] = None       # whisper
    vision: Optional[VisionStubSpec] = None     # llava
    mtp: bool = False               # DeepSeek-V3 multi-token prediction head
    mtp_coef: float = 0.3
    max_seq: int = 8192
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    dist_mode: str = "replica"
    source: str = ""

    @property
    def n_layers(self) -> int:
        return len(self.blocks)

    def block_kinds(self) -> Tuple[str, ...]:
        return tuple(b.kind for b in self.blocks)

    def has_ssm(self) -> bool:
        return any(b.kind == "mamba" for b in self.blocks)

    def subquadratic(self) -> bool:
        """True if the decode state is O(1) or O(window) per token: every
        attention layer (GQA or MLA) is windowed, or there is none."""
        for b in self.blocks:
            if b.kind == "attn" and b.attn.window is None:
                return False
            if b.kind == "mla" and b.mla.window is None:
                return False
        return True


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
    dt_rank d_model // 16, <= 4 experts (top_k <= 2, d_ff_expert =
    2 * d_model, <= 1 shared), MLA at q_lora 32, kv_lora 16, nope 16, rope
    8, v 16 (window <= 64), a 1-layer encoder over 16 frames, 8 image
    tokens, tiny vocab."""
    heads = 4
    head_dim = d_model // heads
    blocks = [dataclasses.replace(
        b, attn=_shrink_attn(b.attn, heads, head_dim),
        mla=(dataclasses.replace(
            b.mla, n_heads=heads, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
            window=min(b.mla.window, 64) if b.mla.window else None)
             if b.mla is not None else None),
        ssm=(dataclasses.replace(b.ssm, d_state=8,
                                 dt_rank=max(1, d_model // 16))
             if b.ssm is not None else None),
        moe=(dataclasses.replace(b.moe, n_experts=4,
                                 top_k=min(b.moe.top_k, 2),
                                 d_ff_expert=2 * d_model,
                                 n_shared=min(b.moe.n_shared, 1))
             if b.moe is not None else None),
        d_ff=(2 * d_model if b.d_ff else 0))
        for b in cfg.blocks[:n_layers]]
    while len(blocks) < n_layers:
        blocks.append(blocks[-1])
    encoder = None
    if cfg.encoder is not None:
        encoder = EncoderSpec(
            n_layers=1, n_frames=16,
            attn=_shrink_attn(cfg.encoder.attn, heads, head_dim),
            d_ff=2 * d_model)
    vision = VisionStubSpec(n_image_tokens=8) if cfg.vision is not None \
        else None
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", d_model=d_model,
                               vocab=vocab, blocks=tuple(blocks),
                               encoder=encoder, vision=vision, max_seq=256,
                               dist_mode="replica")
