"""A Mamba-1 configuration file as the program's ``ModelConfig``."""
from __future__ import annotations

from typing import Dict

from portbench.models.dense import fixed_norm_eps


def program_config(cfg: Dict):
    from repro_torch.models.config import BlockSpec, ModelConfig, SSMSpec
    fixed_norm_eps(cfg)
    if cfg.get("bcdt_rms"):
        raise ValueError("the port's Mamba-1 mixer has no norms on B, C "
                         "and dt")
    ssm = SSMSpec(d_state=cfg["d_state"], d_conv=cfg["d_conv"],
                  expand=cfg["expand"], dt_rank=cfg["dt_rank"])
    return ModelConfig(name=cfg["name"], d_model=cfg["d_model"],
                       vocab=cfg["vocab"],
                       blocks=(BlockSpec(kind="mamba", ssm=ssm),) * cfg["n_layers"],
                       norm=cfg["norm"], tie_embeddings=cfg["tie_embeddings"],
                       max_seq=cfg["max_seq"], param_dtype=cfg["param_dtype"],
                       compute_dtype=cfg["compute_dtype"])


def matmul_params(cfg: Dict) -> int:
    """in_proj, x_proj, dt_proj, out_proj a layer, and the untied head."""
    d, Di = cfg["d_model"], cfg["expand"] * cfg["d_model"]
    N, R = cfg["d_state"], cfg["dt_rank"]
    layer = d * 2 * Di + Di * (R + 2 * N) + R * Di + Di * d
    return cfg["n_layers"] * layer + d * cfg["vocab"]


def mixer_flops_per_token(cfg: Dict, seq_len: int) -> int:
    """The state's read-out ``h . C``, forward and backward: 6 L d_inner N a
    token (the scan's recurrence is elementwise and not counted)."""
    return 6 * cfg["n_layers"] * cfg["expand"] * cfg["d_model"] * cfg["d_state"]
