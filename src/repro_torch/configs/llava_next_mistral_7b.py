"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf] — Mistral-7B
language backbone (32L, d=4096, GQA 32H/8KV, SwiGLU d_ff=14336, native
sliding window 4096 => sub-quadratic decode), vocab=32000. Port of
``repro/configs/llava_next_mistral_7b.py``.

The vision tower + projector are a STUB: inputs include precomputed patch
embeddings (B, n_image_tokens, 4096). anyres tiling is realized as the
image-token count: base 576 + 4 tiles x 576 = 2880.
"""
from repro_torch.models.config import (AttnSpec, BlockSpec, ModelConfig,
                                       VisionStubSpec)

_ATTN = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128, window=4096)

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    d_model=4096,
    vocab=32000,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, d_ff=14336)
                 for _ in range(32)),
    norm="rms",
    tie_embeddings=False,
    vision=VisionStubSpec(n_image_tokens=2880),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf] anyres tiling (stub tower)",
)
