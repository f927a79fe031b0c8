"""Serving steps: batched prefill and single-token decode.

Port of ``repro/serve/step.py`` (``cache_axes``, ``ServeBundle``,
``make_decode_step``, ``make_prefill_step``). The decode shapes
(``decode_32k``, ``long_500k``) run exactly this step: ONE new token
against a ``seq_len`` KV cache. Parameters are one logical copy (no replica
axis). The bundle carries the reference's placement plan: parameter specs
from ``train.sharding.Distribution.param_specs(replica_axis=False)`` and
cache specs from ``cache_axes`` (the batch over the data axes; where the
batch cannot shard, the cache sequence over ``data``). ``step_fn`` runs on
the one device its tensors live on. There is no ``jitted()``: the
reference's compiles the step with those shardings over a device mesh and
donates the cache, which the port has no counterpart of (as
``mesh_spec.py`` stands in for ``jax.sharding``); the port's step writes
the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.mesh_spec import PartitionSpec as P
from repro_torch.models import lm_decode, lm_prefill, segments_of
from repro_torch.models.blocks import _check_kind
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.train.sharding import Distribution
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["cache_axes", "make_decode_step", "make_prefill_step",
           "ServeBundle"]


def _block_cache_axes(spec: BlockSpec) -> Dict:
    _check_kind(spec)
    if spec.kind == "attn":
        a = {"kv": {"k": ",batch,kv_seq,kv_heads,",
                    "v": ",batch,kv_seq,kv_heads,"}}
    elif spec.kind == "mla":
        a = {"kv": {"c_kv": ",batch,kv_seq,", "k_rope": ",batch,kv_seq,"}}
    else:
        a = {"ssm": {"h": ",batch,inner,", "conv": ",batch,,inner"}}
    if spec.cross_attn is not None:
        a["mem_k"] = ",batch,,kv_heads,"
        a["mem_v"] = ",batch,,kv_heads,"
    return a


def cache_axes(cfg: ModelConfig):
    """Axes tree mirroring lm_cache_init (list/seg structure, leading repeat
    axis unannotated)."""
    return [[_block_cache_axes(spec) for spec in pattern]
            for pattern, _ in segments_of(cfg.blocks)]


class ServeBundle:
    def __init__(self, *, step_fn, param_specs, cache_specs, in_specs, dist,
                 cfg):
        self.step_fn = step_fn
        self.param_specs = param_specs
        self.cache_specs = cache_specs
        self.in_specs = in_specs
        self.dist = dist
        self.cfg = cfg


def _param_and_cache_specs(cfg: ModelConfig, dist: Distribution,
                           param_shapes: Any, param_axes: Any,
                           cache_shapes: Any):
    param_specs = dist.param_specs(param_shapes, param_axes,
                                   replica_axis=False)
    cache_specs = tree_map(
        lambda c, a: dist.leaf_spec(tuple(c.shape), a, False),
        cache_shapes, cache_axes(cfg))
    return param_specs, cache_specs


def _batch(cache_shapes) -> int:
    return tree_flatten(cache_shapes)[0][0].shape[1]


def make_decode_step(cfg: ModelConfig, dist: Distribution, *,
                     param_shapes: Any, param_axes: Any,
                     cache_shapes: Any) -> ServeBundle:
    """step(params, cache, token (B,), pos ()) -> (logits (B,V), cache)."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, token, pos):
        return lm_decode(params, cfg, token, cache, pos)

    tok_spec = dist.leaf_spec((_batch(cache_shapes),), "batch", False)
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=(tok_spec, P()),
                       dist=dist, cfg=cfg)


def make_prefill_step(cfg: ModelConfig, dist: Distribution, *,
                      param_shapes: Any, param_axes: Any,
                      cache_shapes: Any, with_image: bool = False,
                      with_audio: bool = False) -> ServeBundle:
    """step(params, cache, tokens (B,S) [, image_embeds (B,Ni,d)]
    [, audio_frames (B,F,d)]) -> (last-position logits, filled cache)."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, tokens, *extra):
        kw = {}
        i = 0
        if with_image:
            kw["image_embeds"] = extra[i]
            i += 1
        if with_audio:
            kw["audio_frames"] = extra[i]
        return lm_prefill(params, cfg, tokens, cache, **kw)

    batch = _batch(cache_shapes)
    in_specs = [dist.leaf_spec((batch, 1), "batch,", False)]
    for extra in (with_image, with_audio):
        if extra:
            in_specs.append(dist.leaf_spec((batch, 1, 1), "batch,,", False))
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=tuple(in_specs),
                       dist=dist, cfg=cfg)
