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
``dist_ctx.use_distribution(dist, group, seq)``, as the reference's run
under its plan (``src/repro/serve/step.py:96, :118``); the MoE layers
split their experts over the rank's model group
(``models.moe._expert_compute_manual``). A step takes the global tokens
and returns the global logits on every rank. Where the batch splits over
the batch group, the rank serves its ``batch // batch_shards`` rows at
its batch index with a cache of only those rows, and the logits are
all-gathered over the batch group in batch order. Where it does not
(long_500k's batch of 1), every rank serves every row and the plan
decides leaf by leaf, as the reference's ``leaf_spec`` does for its cache
specs (``kv_seq`` on ``data`` once ``__batch__`` leaves ``data`` free,
``src/repro/train/sharding.py:40-43``, ``src/repro/serve/step.py:1-8``):
an attention or MLA leaf whose length ``L`` the batch group's ``n``
divides holds the rank's stretch ``[b L / n, (b + 1) L / n)``, and the
attention combines the ranks' partial softmaxes over the batch group
(``seq_shards``, ``rank_cache_init``; ``models.attention``); every other
leaf (the SSM state, cross-attention memory, a length ``n`` does not
divide) is whole on every rank. Such a step needs the cache's global
length, ``max_seq=``. ``rank_serving_params`` turns a rank's pieces of
the weights into its serving weights once: every leaf whole, but under
expert parallelism the experts, which are the rank's ``E / M`` at its
model index.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import build_layout
from repro_torch.core.buckets import gather_rows
from repro_torch.dist_ctx import SeqShards, use_distribution
from repro_torch.mesh_spec import PartitionSpec as P
from repro_torch.models import (lm_cache_init, lm_decode, lm_prefill,
                                lm_specs, segments_of)
from repro_torch.models.blocks import _check_kind
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import ax_names
from repro_torch.train.sharding import Distribution
from repro_torch.train.step import expert_dims, in_replica_spec
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["cache_axes", "make_decode_step", "make_prefill_step",
           "ServeBundle", "serve_pieces", "rank_serving_params",
           "rank_cache_init", "seq_shards", "batch_splits", "local_rows",
           "global_logits"]


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


def batch_splits(batch: int, group) -> bool:
    """Whether a global batch of ``batch`` rows splits over ``group``'s
    batch group (always without a group)."""
    return group is None or batch % group.batch_shards == 0


def seq_shards(cfg: ModelConfig, dist: Distribution, group, batch: int,
               max_seq: int) -> Optional[SeqShards]:
    """The sequence-parallel cache of a step serving ``batch`` rows over
    ``group`` with caches of ``max_seq`` positions: None where the batch
    splits (or without a group); else the cache lengths whose ``kv_seq``
    the plan puts on the batch group's mesh axes, by
    ``dist.leaf_spec`` of each global cache leaf under ``cache_axes``
    (the reference's rule: ``__batch__`` leaves ``data`` free, and
    ``kv_seq`` takes it where its length divides)."""
    if batch_splits(batch, group):
        return None
    axes = tuple(a for a in dist.shard_axes if a in dist.batch_axes)
    on = axes[0] if len(axes) == 1 else axes
    split = set()

    def one(c, ann):
        names = ax_names(ann)
        if "kv_seq" in names:
            d = names.index("kv_seq")
            if dist.leaf_spec(tuple(c.shape), ann, False)[d] == on:
                split.add(int(c.shape[d]))
    tree_map(one, lm_cache_init(cfg, batch, max_seq, device="meta"),
             cache_axes(cfg))
    return SeqShards(group=group, max_seq=max_seq, split=frozenset(split))


def rank_cache_init(cfg: ModelConfig, dist: Distribution, group, batch: int,
                    max_seq: int, dtype=None, *, device="cuda"):
    """A rank's zero decode caches for a global batch of ``batch`` rows of
    up to ``max_seq`` positions, in ``lm_cache_init``'s tree: its
    ``batch // batch_shards`` rows where the batch splits; else every row,
    each split leaf (``seq_shards``) only the rank's stretch of its
    ``kv_seq``, the other leaves whole."""
    if batch_splits(batch, group):
        rows = batch if group is None else batch // group.batch_shards
        return lm_cache_init(cfg, rows, max_seq, dtype, device=device)
    seq = seq_shards(cfg, dist, group, batch, max_seq)
    dev = torch.device(device)

    def one(c, ann):
        shape = list(c.shape)
        names = ax_names(ann)
        if "kv_seq" in names:
            d = names.index("kv_seq")
            shape[d] = seq.stretch(shape[d])[1]
        return torch.zeros(shape, dtype=c.dtype, device=dev)
    return tree_map(one, lm_cache_init(cfg, batch, max_seq, dtype,
                                       device="meta"), cache_axes(cfg))


def local_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of the global batch ``x``: ``batch //
    batch_shards`` of them at its batch index where the batch splits over
    the batch group, else all of them (and all without a group)."""
    b = x.shape[0]
    if group is None or not batch_splits(b, group):
        return x
    n = group.batch_shards
    lo = group.batch_index * (b // n)
    return x[lo:lo + b // n]


def global_logits(logits: torch.Tensor, group, batch: int) -> torch.Tensor:
    """The logits of the global batch of ``batch`` rows from every rank's
    rows: an ``all_gather`` over the batch group, in batch order, where
    the batch splits; else ``logits`` themselves, which every rank
    computed for every row (and without a group)."""
    if group is None or group.batch is None or not batch_splits(batch,
                                                                group):
        return logits
    return torch.cat(gather_rows(logits, group.batch, group.batch_shards))


def _step_seq(cfg, dist, group, batch: int, max_seq: Optional[int]):
    """``seq_shards`` of a step's global batch; a batch that does not
    split over the group needs the cache's ``max_seq``."""
    if batch_splits(batch, group):
        return None
    if max_seq is None:
        raise ValueError(
            f"a batch of {batch} does not split over the "
            f"{group.batch_shards} ranks of the batch group: the "
            "sequence-parallel cache needs its length, max_seq=")
    return seq_shards(cfg, dist, group, batch, max_seq)


def make_decode_step(cfg: ModelConfig, dist: Distribution, *,
                     param_shapes: Any, param_axes: Any,
                     cache_shapes: Any, group=None,
                     max_seq: Optional[int] = None) -> ServeBundle:
    """step(params, cache, token (B,), pos ()) -> (logits (B,V), cache).
    Under ``group`` the token and the logits are the global batch's and
    the cache is the rank's (``rank_cache_init``; a batch that does not
    split over the batch group needs the cache's ``max_seq``)."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, token, pos):
        B = token.shape[0]
        with use_distribution(dist, group,
                              _step_seq(cfg, dist, group, B, max_seq)):
            logits, cache = lm_decode(params, cfg, local_rows(token, group),
                                      cache, pos)
            return global_logits(logits, group, B), cache

    tok_spec = dist.leaf_spec((_batch(cache_shapes),), "batch", False)
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=(tok_spec, P()),
                       dist=dist, cfg=cfg)


def make_prefill_step(cfg: ModelConfig, dist: Distribution, *,
                      param_shapes: Any, param_axes: Any,
                      cache_shapes: Any, with_image: bool = False,
                      with_audio: bool = False, group=None,
                      max_seq: Optional[int] = None) -> ServeBundle:
    """step(params, cache, tokens (B,S) [, image_embeds (B,Ni,d)]
    [, audio_frames (B,F,d)]) -> (last-position logits, filled cache).
    Under ``group`` the inputs and the logits are the global batch's and
    the cache is the rank's (``make_decode_step``'s)."""
    param_specs, cache_specs = _param_and_cache_specs(
        cfg, dist, param_shapes, param_axes, cache_shapes)

    def step(params, cache, tokens, *extra):
        B = tokens.shape[0]
        kw = {}
        i = 0
        if with_image:
            kw["image_embeds"] = local_rows(extra[i], group)
            i += 1
        if with_audio:
            kw["audio_frames"] = local_rows(extra[i], group)
        with use_distribution(dist, group,
                              _step_seq(cfg, dist, group, B, max_seq)):
            logits, cache = lm_prefill(params, cfg, local_rows(tokens, group),
                                       cache, **kw)
            return global_logits(logits, group, B), cache

    batch = _batch(cache_shapes)
    in_specs = [dist.leaf_spec((batch, 1), "batch,", False)]
    for extra in (with_image, with_audio):
        if extra:
            in_specs.append(dist.leaf_spec((batch, 1, 1), "batch,,", False))
    return ServeBundle(step_fn=step, param_specs=param_specs,
                       cache_specs=cache_specs, in_specs=tuple(in_specs),
                       dist=dist, cfg=cfg)
