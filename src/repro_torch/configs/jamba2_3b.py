"""AI21-Jamba2-3B (``model_type`` "jamba"; layer equations of
[arXiv:2403.19887]) — a Mamba-1 and attention hybrid at 13:1: 28 layers
at d_model 2560, attention where ``i % 14 == 7`` (layers 7 and 21, the
``jamba`` type's ``attn_layer_period`` 14 and ``attn_layer_offset`` 7),
Mamba-1 elsewhere (d_state 16, d_conv 4 with conv bias, expand 2, dt_rank
160, weighted RMSNorms on dt, B and C); every layer a SwiGLU MLP of 8192
(``num_experts`` 1: no MoE). Attention: 20 query heads of 128 over one
KV head (MQA), no positional encoding. RMSNorm eps 1e-6, vocab 65536,
tied embedding. Source: huggingface.co/ai21labs/AI21-Jamba2-3B
config.json. The reference package has no counterpart: ``list_archs``
keeps to its ten, ``get_config`` names this one too.

dist_mode="replica": 3.03B params, two replicas stacked fit one card.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig, SSMSpec

_ATTN = AttnSpec(n_heads=20, n_kv_heads=1, head_dim=128, rope_frac=0.0)
_SSM = SSMSpec(d_state=16, d_conv=4, expand=2, dt_rank=160,
               bcdt_norm="weighted")
PERIOD, OFFSET = 14, 7


def _block(i: int) -> BlockSpec:
    if i % PERIOD == OFFSET:
        return BlockSpec(kind="attn", attn=_ATTN, d_ff=8192)
    return BlockSpec(kind="mamba", ssm=_SSM, d_ff=8192)


CONFIG = ModelConfig(
    name="jamba2-3b",
    d_model=2560,
    vocab=65536,
    blocks=tuple(_block(i) for i in range(28)),
    norm="rms",
    tie_embeddings=True,
    max_seq=262144,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="AI21-Jamba2-3B config.json; [arXiv:2403.19887] Mamba-1+attn "
           "13:1, norms on dt/B/C, NoPE MQA",
)
