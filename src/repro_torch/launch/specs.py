"""Meta-device stand-ins for every model input: the dry run's inputs.

Port of ``repro/launch/specs.py`` (``resolve_config``,
``train_input_specs``, ``serve_input_specs``, ``param_count``,
``active_param_count``). The reference builds ``ShapeDtypeStruct`` trees
with ``jax.eval_shape`` over its init functions; here the same trees are
tensors on PyTorch's ``meta`` device, which carry shapes and dtypes and
allocate nothing: params from ``models.transformer.lm_specs``, the state
from ``train.init_train_state`` and the caches from ``lm_cache_init``, all
on ``device="meta"``. Batches take the reference's shapes and dtypes:
tokens ``(dp, local_b, text_len + 1)`` int32, a VLM's ``image_embeds`` and
an enc-dec model's ``audio_frames`` in the compute dtype, decode's
``token`` (B,) and ``pos`` (), prefill's ``tokens`` (B, text_len).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import (LONG_CONTEXT_WINDOW, get_config,
                                 with_sliding_window)
from repro_torch.models import lm_axes, lm_cache_init, lm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.optim import Optimizer
from repro_torch.train import init_train_state
from repro_torch.train.sharding import Distribution
from repro_torch.tree import keystr, tree_flatten, tree_map

__all__ = ["resolve_config", "meta_params", "train_input_specs",
           "serve_input_specs", "param_count", "active_param_count"]

META = torch.device("meta")


def resolve_config(arch: str, shape: str) -> Tuple[ModelConfig, Dict]:
    """Arch config specialized for the input shape. ``long_500k`` swaps
    full attention for the sliding-window variant (a sub-quadratic decode
    cache); SSM and windowed archs run unmodified."""
    cfg = get_config(arch)
    notes = {}
    if shape == "long_500k" and not cfg.subquadratic():
        cfg = with_sliding_window(cfg, LONG_CONTEXT_WINDOW)
        notes["variant"] = f"sliding_window_{LONG_CONTEXT_WINDOW}"
    return cfg, notes


def meta_params(cfg: ModelConfig) -> Dict:
    """One replica's param tree as meta tensors (``lm_specs``' shapes and
    dtypes; nothing drawn)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=META), lm_specs(cfg))


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    n_img = cfg.vision.n_image_tokens if cfg.vision is not None else 0
    text_len = seq_len - n_img
    assert text_len > 2, "image tokens exceed sequence budget"
    return text_len


def _extras(cfg: ModelConfig, lead: Tuple[int, ...], device) -> Dict:
    """A VLM's image embeddings and an enc-dec model's audio frames with
    leading dims ``lead``, in the compute dtype."""
    dtype = dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.vision is not None:
        out["image_embeds"] = torch.empty(
            lead + (cfg.vision.n_image_tokens, cfg.d_model), dtype=dtype,
            device=device)
    if cfg.encoder is not None:
        out["audio_frames"] = torch.empty(
            lead + (cfg.encoder.n_frames, cfg.d_model), dtype=dtype,
            device=device)
    return out


def train_input_specs(cfg: ModelConfig, dist: Union[Distribution, int],
                      seq_len: int, global_batch: int, optimizer: Optimizer
                      ) -> Tuple[Any, Any, Dict]:
    """``(state, state_axes, batch)`` on meta: the state's leaves carry a
    leading replica axis of ``dist.dp`` (1 for a single-pod fsdp plan; or
    ``dist`` itself where it is a count of flat stacked replicas, as the
    dry run traces), ``state_axes`` annotate the params with an empty
    leading segment."""
    dp = dist if isinstance(dist, int) else max(dist.dp, 1)
    assert global_batch % dp == 0, (global_batch, dp)
    local_b = global_batch // dp
    state = init_train_state(cfg, optimizer, dp=dp, params=meta_params(cfg),
                             device=META)
    state_axes = tree_map(lambda a: "," + a, lm_axes(cfg))
    batch = {"tokens": torch.empty((dp, local_b, _text_len(cfg, seq_len) + 1),
                                   dtype=torch.int32, device=META)}
    batch.update(_extras(cfg, (dp, local_b), META))
    return state, state_axes, batch


def serve_input_specs(cfg: ModelConfig, dist: Distribution, seq_len: int,
                      global_batch: int, kind: str) -> Dict[str, Any]:
    """Meta inputs of the serve steps. kind: ``"decode"`` | ``"prefill"``.

    decode: {params, params_axes, cache(seq_len), token (B,), pos ()};
    prefill: {params, params_axes, cache(seq_len), tokens (B, S)} plus a
    VLM's ``image_embeds`` or an enc-dec model's ``audio_frames``."""
    del dist  # the reference takes it and reads nothing of it either
    out = {"params": meta_params(cfg), "params_axes": lm_axes(cfg),
           "cache": lm_cache_init(cfg, global_batch, seq_len, device=META)}
    if kind == "decode":
        out["token"] = torch.empty((global_batch,), dtype=torch.int32,
                                   device=META)
        out["pos"] = torch.empty((), dtype=torch.int32, device=META)
    else:
        out["tokens"] = torch.empty((global_batch, _text_len(cfg, seq_len)),
                                    dtype=torch.int32, device=META)
        out.update(_extras(cfg, (global_batch,), META))
    return out


def param_count(params) -> int:
    """Elements over every leaf (tensors or ``ParamSpec``s)."""
    return int(sum(int(np.prod(tuple(l.shape)))
                   for l in tree_flatten(params)[0]))


def active_param_count(cfg: ModelConfig, params) -> int:
    """Parameters touched per token: the reference's rule, which scales
    every ``'ff'`` ``w_gate`` / ``w_in`` / ``w_out`` leaf by
    ``top_k / n_experts`` when the config has MoE layers; everything else
    counts fully. Used for MODEL_FLOPS = 6·N·D. Paths are ``keystr`` of the
    port's tree, which equal the reference's."""
    leaves, td = tree_flatten(params)
    moe = next((b.moe for b in cfg.blocks if b.moe is not None), None)
    total = 0
    for path, leaf in zip(td.paths(), leaves):
        key = keystr(path)
        n = int(np.prod(tuple(leaf.shape)))
        if moe is not None and "'ff'" in key and (
                "w_gate" in key or "w_in" in key or "w_out" in key):
            n = int(n * moe.top_k / moe.n_experts)
        total += n
    return total
