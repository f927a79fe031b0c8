"""deepseek-v3-671b [arXiv:2412.19437] — MLA (128 heads, q_lora 1536,
kv_lora 512, nope/rope 128/64, v 128), first 3 layers dense (d_ff=18432),
58 MoE layers (1 shared + 256 routed, top-8, expert d_ff=2048), MTP head,
vocab=129280. Port of ``repro/configs/deepseek_v3_671b.py``.

dist_mode="fsdp"; gossip replicas on the pod axis (hierarchical).
"""
from repro_torch.models.config import BlockSpec, MLASpec, ModelConfig, MoESpec

_MLA = MLASpec(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
               qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128)
_MOE = MoESpec(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
               capacity_factor=1.25)

_DENSE = BlockSpec(kind="mla", mla=_MLA, d_ff=18432)
_SPARSE = BlockSpec(kind="mla", mla=_MLA, moe=_MOE)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    d_model=7168,
    vocab=129280,
    blocks=(_DENSE,) * 3 + (_SPARSE,) * 58,
    norm="rms",
    tie_embeddings=False,
    mtp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="fsdp",
    source="[arXiv:2412.19437] MLA, 1 shared+256 routed top-8, MTP",
)
