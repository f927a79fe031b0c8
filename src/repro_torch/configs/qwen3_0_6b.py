"""qwen3-0.6b [hf:Qwen/Qwen3-8B family card] — dense, GQA (16H/8KV, head_dim
128 > d/H), per-head qk RMSNorm, SwiGLU d_ff=3072, tied embeddings,
vocab=151936. Port of ``repro/configs/qwen3_0_6b.py``."""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig

_ATTN = AttnSpec(n_heads=16, n_kv_heads=8, head_dim=128, qk_norm=True,
                 rope_theta=1_000_000.0)

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    d_model=1024,
    vocab=151936,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, d_ff=3072)
                 for _ in range(28)),
    norm="rms",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[hf:Qwen/Qwen3-8B] qk_norm, GQA",
)
