"""jamba-v0.1-52b [arXiv:2403.19887] — hybrid Mamba+attention 1:7 interleave
with MoE every other layer: 32 layers in 8-layer periodic units (attention at
unit position 4), MoE (16 experts, top-2, d_ff=14336) on odd layers, dense
SwiGLU d_ff=14336 on even layers. GQA 32H/8KV. vocab=65536. Port of
``repro/configs/jamba_v0_1_52b.py``.

dist_mode="fsdp": 52B params — one logical copy over (data x model); gossip
replicas on the pod axis.
"""
from repro_torch.models.config import (AttnSpec, BlockSpec, ModelConfig,
                                       MoESpec, SSMSpec)

_ATTN = AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128)
_SSM = SSMSpec(d_state=16, d_conv=4, expand=2)
_MOE = MoESpec(n_experts=16, top_k=2, d_ff_expert=14336)


def _block(i: int) -> BlockSpec:
    kind = "attn" if i % 8 == 4 else "mamba"
    if i % 2 == 1:
        return BlockSpec(kind=kind,
                         attn=_ATTN if kind == "attn" else None,
                         ssm=_SSM if kind == "mamba" else None,
                         moe=_MOE)
    return BlockSpec(kind=kind,
                     attn=_ATTN if kind == "attn" else None,
                     ssm=_SSM if kind == "mamba" else None,
                     d_ff=14336)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096,
    vocab=65536,
    blocks=tuple(_block(i) for i in range(32)),
    norm="rms",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="fsdp",
    source="[arXiv:2403.19887] Mamba+attn 1:7, MoE 16e top-2",
)
