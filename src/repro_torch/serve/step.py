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

**Over a process mesh** (``group=``, a ``core.replica_group.ReplicaGroup``
joined with the plan): the step functions run under
``dist_ctx.use_distribution(dist, group)``, as the reference's run under
its plan (``src/repro/serve/step.py:96, :118``); that changes one thing in
the model, as in the reference: the MoE layers split their experts over
the rank's model group (``models.moe._expert_compute_manual``). A step
takes the global tokens and serves this rank's ``batch // batch_shards``
rows at its batch index, with a cache of only those rows
(``cache_shapes`` are the rank's), and returns the global logits,
all-gathered over the batch group in batch order. Where the batch does
not split over the batch group the step raises: the reference's
sequence-parallel cache (``kv_seq`` over ``data``, ``src/repro/serve/
step.py:1-8``) is not ported (ROADMAP A.12f). ``rank_serving_params``
turns a rank's pieces of the weights into its serving weights once:
every leaf whole, but under expert parallelism the experts, which are
the rank's ``E / M`` at its model index.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import build_layout
from repro_torch.core.buckets import gather_rows
from repro_torch.dist_ctx import use_distribution
from repro_torch.mesh_spec import PartitionSpec as P
from repro_torch.models import lm_decode, lm_prefill, lm_specs, segments_of
from repro_torch.models.blocks import _check_kind
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.train.sharding import Distribution
from repro_torch.train.step import expert_dims, in_replica_spec
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["cache_axes", "make_decode_step", "make_prefill_step",
           "ServeBundle", "serve_pieces", "rank_serving_params",
           "local_rows", "global_logits"]


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


def serve_pieces(cfg: ModelConfig, dist: Distribution):
    """The piece table of the serving weights under ``dist`` (a
    ``core.buckets.BucketLayout``; only its slots are read): each leaf
    partitioned over the plan's in-replica axes by its spec
    ``dist.param_specs(replica_axis=False)``, size-1 axes dropped, the
    train step's partition (``train.step._build_packed_layout``), so a
    rank's training pieces serve as they are."""
    specs = lm_specs(cfg)
    td = tree_flatten(specs)[1]
    spec_tree = dist.param_specs(specs, tree_map(lambda x: x.axes, specs),
                                 replica_axis=False)
    return build_layout(specs, shard_axes=dist.shard_axes,
                        shard_axis_sizes=dist.shard_axis_sizes,
                        shard_specs=td.unflatten(
                            [in_replica_spec(dist, p)
                             for p in td.flatten_up_to(spec_tree)]))


def rank_serving_params(cfg: ModelConfig, dist: Distribution, pieces, group):
    """A rank's serving weights from its pieces of one logical copy
    (``serve_pieces(cfg, dist).cut_pieces(params, group.shard)``), gathered
    once (the weights do not change while serving): every leaf whole over
    the in-replica group, but under expert parallelism an expert leaf over
    the batch group only, the rank's ``E / M`` experts
    (``BucketLayout.gather_pieces``)."""
    table = serve_pieces(cfg, dist)
    with torch.no_grad():
        tree = table.gather_pieces(tree_map(lambda x: x[None], pieces), group,
                                   expert_dims(cfg, dist, group))
    return tree_map(lambda x: x[0], tree)


def local_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of the global batch ``x``: ``batch //
    batch_shards`` of them at its batch index (all of them without a
    group)."""
    if group is None:
        return x
    n, b = group.batch_shards, x.shape[0]
    if b % n:
        raise ValueError(
            f"a batch of {b} does not split over the {n} ranks of the batch "
            "group; the reference serves it with a sequence-parallel cache "
            "(kv_seq over data, src/repro/serve/step.py:1-8), which is not "
            "ported (ROADMAP A.12f)")
    lo = group.batch_index * (b // n)
    return x[lo:lo + b // n]


def global_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """The global batch's logits from every rank's rows: an ``all_gather``
    over the batch group, in batch order (``logits`` without one)."""
    if group is None or group.batch is None:
        return logits
    return torch.cat(gather_rows(logits, group.batch, group.batch_shards))


def make_decode_step(cfg: ModelConfig, dist: Distribution, *,
                     param_shapes: Any, param_axes: Any,
                     cache_shapes: Any, group=None) -> ServeBundle:
    """step(params, cache, token (B,), pos ()) -> (logits (B,V), cache).
    Under ``group`` the token and the logits are the global batch's and
    the cache is the rank's rows."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, token, pos):
        with use_distribution(dist, group):
            logits, cache = lm_decode(params, cfg, local_rows(token, group),
                                      cache, pos)
            return global_logits(logits, group), cache

    tok_spec = dist.leaf_spec((_batch(cache_shapes),), "batch", False)
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=(tok_spec, P()),
                       dist=dist, cfg=cfg)


def make_prefill_step(cfg: ModelConfig, dist: Distribution, *,
                      param_shapes: Any, param_axes: Any,
                      cache_shapes: Any, with_image: bool = False,
                      with_audio: bool = False, group=None) -> ServeBundle:
    """step(params, cache, tokens (B,S) [, image_embeds (B,Ni,d)]
    [, audio_frames (B,F,d)]) -> (last-position logits, filled cache).
    Under ``group`` the inputs and the logits are the global batch's and
    the cache is the rank's rows."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, tokens, *extra):
        kw = {}
        i = 0
        if with_image:
            kw["image_embeds"] = local_rows(extra[i], group)
            i += 1
        if with_audio:
            kw["audio_frames"] = local_rows(extra[i], group)
        with use_distribution(dist, group):
            logits, cache = lm_prefill(params, cfg, local_rows(tokens, group),
                                       cache, **kw)
            return global_logits(logits, group), cache

    batch = _batch(cache_shapes)
    in_specs = [dist.leaf_spec((batch, 1), "batch,", False)]
    for extra in (with_image, with_audio):
        if extra:
            in_specs.append(dist.leaf_spec((batch, 1, 1), "batch,,", False))
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=tuple(in_specs),
                       dist=dist, cfg=cfg)
