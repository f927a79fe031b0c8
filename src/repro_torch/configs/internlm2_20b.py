"""internlm2-20b [arXiv:2403.17297] — dense GQA 48H/8KV, 48L, d_model=6144,
SwiGLU d_ff=16384, vocab=92544. Port of ``repro/configs/internlm2_20b.py``."""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig

_ATTN = AttnSpec(n_heads=48, n_kv_heads=8, head_dim=128)

CONFIG = ModelConfig(
    name="internlm2-20b",
    d_model=6144,
    vocab=92544,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, d_ff=16384)
                 for _ in range(48)),
    norm="rms",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[arXiv:2403.17297] GQA",
)
