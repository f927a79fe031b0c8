"""Architecture registry (port of ``repro/configs/__init__.py``).

qwen3-0.6b (the train path's) and falcon-mamba-7b (the Mamba forward's) are
ported; the other eight configs wait for their model families (ROADMAP
A.13).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["get_config", "list_archs"]

_ARCH_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-0.6b": "qwen3_0_6b",
}


def list_archs():
    return sorted(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
