"""olmo-1b [arXiv:2402.00838] — dense MHA (16H=16KV), NON-PARAMETRIC
LayerNorm (no learnable scale/bias), SwiGLU d_ff=8192, vocab=50304, tied.
Port of ``repro/configs/olmo_1b.py``."""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig

_ATTN = AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128)

CONFIG = ModelConfig(
    name="olmo-1b",
    d_model=2048,
    vocab=50304,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, d_ff=8192)
                 for _ in range(16)),
    norm="nonparam",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[arXiv:2402.00838] non-parametric LN",
)
