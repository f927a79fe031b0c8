"""falcon-mamba-7b [arXiv:2410.05355] — attention-free Mamba-1 LM: 64
layers, d_model 4096 (d_inner 8192), ssm_state 16, vocab 65024, untied.
Mamba-1 blocks have no separate MLP (d_ff = 0): the mixer is the layer.
Port of ``repro/configs/falcon_mamba_7b.py``."""
from repro_torch.models.config import BlockSpec, ModelConfig, SSMSpec

_SSM = SSMSpec(d_state=16, d_conv=4, expand=2)

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    d_model=4096,
    vocab=65024,
    blocks=tuple(BlockSpec(kind="mamba", ssm=_SSM) for _ in range(64)),
    norm="rms",
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[arXiv:2410.05355] mamba1 arch, attn-free",
)
