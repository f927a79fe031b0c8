"""whisper-base [arXiv:2212.04356] — encoder-decoder, 6+6L, d_model=512,
8H MHA, d_ff=2048 (GELU), vocab=51865, LayerNorm. Port of
``repro/configs/whisper_base.py``.

The mel-spectrogram + conv frontend is a STUB: the encoder consumes
precomputed frame embeddings (B, 1500, 512). Decoder self-attention uses
RoPE in place of Whisper's learned positions, as the reference's does.
"""
from repro_torch.models.config import (AttnSpec, BlockSpec, EncoderSpec,
                                       ModelConfig)

_SELF = AttnSpec(n_heads=8, n_kv_heads=8, head_dim=64)
_CROSS = AttnSpec(n_heads=8, n_kv_heads=8, head_dim=64, cross=True,
                  causal=False, rope_frac=0.0)
_ENC = AttnSpec(n_heads=8, n_kv_heads=8, head_dim=64, causal=False,
                rope_frac=0.0)

CONFIG = ModelConfig(
    name="whisper-base",
    d_model=512,
    vocab=51865,
    blocks=tuple(BlockSpec(kind="attn", attn=_SELF, cross_attn=_CROSS,
                           d_ff=2048, mlp_act="gelu")
                 for _ in range(6)),
    norm="ln",
    tie_embeddings=True,
    encoder=EncoderSpec(n_layers=6, n_frames=1500, attn=_ENC, d_ff=2048),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    dist_mode="replica",
    source="[arXiv:2212.04356] enc-dec, conv frontend (stub)",
)
