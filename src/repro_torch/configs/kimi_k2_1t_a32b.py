"""kimi-k2-1t-a32b [arXiv:2501.kimi2] — trillion-parameter MoE (paper-table
entry): 61L, d_model=7168, GQA 64H/8KV, 384 routed experts top-8 with one
shared expert, expert d_ff=2048, vocab=163840. Port of
``repro/configs/kimi_k2_1t_a32b.py``.

dist_mode="fsdp": one logical copy sharded over (data x model); gossip
replicas live on the pod axis (hierarchical GossipGraD).
"""
from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig, MoESpec

_ATTN = AttnSpec(n_heads=64, n_kv_heads=8, head_dim=128)
_MOE = MoESpec(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
               capacity_factor=1.25)

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    d_model=7168,
    vocab=163840,
    blocks=tuple(BlockSpec(kind="attn", attn=_ATTN, moe=_MOE)
                 for _ in range(61)),
    norm="rms",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="fsdp",
    source="[arXiv:2501.kimi2] 1T MoE, 384e top-8",
)
