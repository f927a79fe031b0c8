"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense MHA (32H=32KV,
head_dim 64), PARTIAL rotary (25% of head_dim), LayerNorm, SwiGLU d_ff=5632,
vocab=100352. Port of ``repro/configs/stablelm_1_6b.py``."""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig

_ATTN = AttnSpec(n_heads=32, n_kv_heads=32, head_dim=64, rope_frac=0.25)

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    d_model=2048,
    vocab=100352,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, d_ff=5632)
                 for _ in range(24)),
    norm="ln",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[hf:stabilityai/stablelm-2-1_6b]",
)
