"""Architecture registry and input shapes (port of
``repro/configs/__init__.py``).

All ten of the reference's archs are registered: the dense attention
members (qwen3-0.6b, olmo-1b, stablelm-1.6b, internlm2-20b and
llava-next-mistral-7b with its vision stub), falcon-mamba-7b, whisper-base
(encoder-decoder, audio stub), the routed-MoE members kimi-k2 and jamba
(with Mamba), and deepseek-v3 (MLA, MoE with a shared expert, the MTP
head). ``NOT_PORTED`` is empty.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "list_archs", "NOT_PORTED", "with_sliding_window", "SHAPES",
           "LONG_CONTEXT_WINDOW"]

_ARCH_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-0.6b": "qwen3_0_6b",
    "olmo-1b": "olmo_1b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "internlm2-20b": "internlm2_20b",
    "whisper-base": "whisper_base",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}

# the reference's archs whose families are not ported yet, and the ROADMAP
# item that ports each: none since deepseek-v3
NOT_PORTED: Dict[str, str] = {}

# (seq_len, global_batch, kind) — kind selects train_step vs serve_step.
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# sliding window of the sub-quadratic variant of full-attention archs on
# long_500k
LONG_CONTEXT_WINDOW = 8192


def list_archs():
    return sorted(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def with_sliding_window(cfg: ModelConfig, window: int) -> ModelConfig:
    """Windowed-attention variant (bounds the decode cache to O(window)),
    for GQA and MLA layers alike; a no-op for blocks that are already
    windowed or attention-free."""
    blocks = []
    for b in cfg.blocks:
        if b.kind == "attn" and b.attn.window is None:
            b = dataclasses.replace(b, attn=dataclasses.replace(
                b.attn, window=window))
        elif b.kind == "mla" and b.mla.window is None:
            b = dataclasses.replace(b, mla=dataclasses.replace(
                b.mla, window=window))
        blocks.append(b)
    return dataclasses.replace(cfg, name=cfg.name + f"-sw{window}",
                               blocks=tuple(blocks))
