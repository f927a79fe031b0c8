"""An AI21-Jamba configuration file (the ``jamba`` type's own keys, as its
``config.json`` gives them) as the program's ``ModelConfig``: attention
where ``i % attn_layer_period == attn_layer_offset``, Mamba-1 with the
weighted norms on dt, B and C elsewhere, a SwiGLU MLP on every layer."""
from __future__ import annotations

from typing import Dict, List


def _kinds(cfg: Dict) -> List[str]:
    return ["attn" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
            else "mamba" for i in range(cfg["num_hidden_layers"])]


def _check(cfg: Dict) -> None:
    """What the port's blocks cannot state."""
    want = {"rms_norm_eps": 1e-6, "num_experts": 1, "hidden_act": "silu",
            "mamba_conv_bias": True, "mamba_proj_bias": False,
            "sliding_window": None}
    bad = {k: cfg[k] for k, v in want.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"{bad}: the port's hybrid blocks run {want}")


def program_config(cfg: Dict):
    from repro_torch.models.config import (AttnSpec, BlockSpec, ModelConfig,
                                           SSMSpec)
    _check(cfg)
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    attn = AttnSpec(n_heads=H, n_kv_heads=cfg["num_key_value_heads"],
                    head_dim=d // H, rope_frac=0.0)
    ssm = SSMSpec(d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                  expand=cfg["mamba_expand"], dt_rank=cfg["mamba_dt_rank"],
                  bcdt_norm="weighted")
    F = cfg["intermediate_size"]
    blocks = tuple(BlockSpec(kind="attn", attn=attn, d_ff=F) if k == "attn"
                   else BlockSpec(kind="mamba", ssm=ssm, d_ff=F)
                   for k in _kinds(cfg))
    return ModelConfig(name=cfg["name"], d_model=d, vocab=cfg["vocab_size"],
                       blocks=blocks, norm="rms",
                       tie_embeddings=cfg["tie_word_embeddings"],
                       max_seq=cfg["max_position_embeddings"],
                       param_dtype=cfg["param_dtype"],
                       compute_dtype=cfg["compute_dtype"])


def matmul_params(cfg: Dict) -> int:
    """Per Mamba layer in_proj, x_proj, dt_proj, out_proj; per attention
    layer the q, k, v and o projections; per layer the SwiGLU MLP; the
    head once (tied or not)."""
    d, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    Di, N, R = (cfg["mamba_expand"] * d, cfg["mamba_d_state"],
                cfg["mamba_dt_rank"])
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    per = {"mamba": d * 2 * Di + Di * (R + 2 * N) + R * Di + Di * d,
           "attn": 2 * d * H * hd + 2 * d * K * hd}
    return sum(per[k] + 3 * d * F for k in _kinds(cfg)) + d * V


def mixer_flops_per_token(cfg: Dict, seq_len: int) -> int:
    """Attention's scores and weighted sum, 12 H hd S a token and layer
    (every pair, no causal halving: the plain attention computes the
    masked half too), and the Mamba read-out ``h . C``, 6 d_inner N a token
    and layer, forward and backward."""
    ks = _kinds(cfg)
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    Di = cfg["mamba_expand"] * cfg["hidden_size"]
    return (12 * ks.count("attn") * cfg["num_attention_heads"] * hd * seq_len
            + 6 * ks.count("mamba") * Di * cfg["mamba_d_state"])
