"""A dense decoder configuration file as the program's ``ModelConfig``."""
from __future__ import annotations

from typing import Dict


def fixed_norm_eps(cfg: Dict) -> None:
    """The port's norms take no epsilon: they use 1e-6."""
    if cfg["norm_eps"] != 1e-6:
        raise ValueError(f"norm_eps {cfg['norm_eps']}: the port's norms "
                         "use 1e-6 and take no other")


def program_config(cfg: Dict):
    from repro_torch.models.config import AttnSpec, BlockSpec, ModelConfig
    fixed_norm_eps(cfg)
    attn = AttnSpec(n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
                    head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"])
    block = BlockSpec(kind="attn", attn=attn, d_ff=cfg["d_ff"])
    return ModelConfig(name=cfg["name"], d_model=cfg["d_model"],
                       vocab=cfg["vocab"], blocks=(block,) * cfg["n_layers"],
                       norm=cfg["norm"], tie_embeddings=cfg["tie_embeddings"],
                       max_seq=cfg["max_seq"], param_dtype=cfg["param_dtype"],
                       compute_dtype=cfg["compute_dtype"])


def matmul_params(cfg: Dict) -> int:
    """Weights that multiply activations: the attention projections, the
    SwiGLU MLP and the head (the tied embedding counts once, as the head)."""
    d, H, K, hd, F = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                      cfg["head_dim"], cfg["d_ff"])
    layer = 2 * d * H * hd + 2 * d * K * hd + 3 * d * F
    return cfg["n_layers"] * layer + d * cfg["vocab"]


def mixer_flops_per_token(cfg: Dict, seq_len: int) -> int:
    """Attention's scores and weighted sum, forward and backward: 12 L H hd S
    a token, every (query, key) pair counted (the port's plain attention
    computes the masked half too; no causal halving)."""
    return 12 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * seq_len
