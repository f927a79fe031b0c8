"""Protocol-neutral train step over replicas stacked on one device, or over
one process per mesh position (a ``core.replica_group.ReplicaGroup``,
``group``).

Port of ``repro/train/step.py`` (``make_train_step_bundle``,
``init_train_state``). Every tensor carries the replica axis first: the
rows this process holds (all dp stacked, or one under a replica group).
The batch is ``(rows, b, S+1)``. One forward and one backward of the
summed per-replica losses leave every replica's own gradient in ``.grad``;
nothing mixes replicas unless the protocol does.

Step layout (GossipGraD Fig. 8/9):
    1. per-replica grads from the local batch shard
    2. protocol.comm_grads
    3. local optimizer update             } fused: one sweep per bucket
    4. protocol.comm_params (gossip mix)  } (mix + update, in place)
    5. ring-rotate the batch shards (§4.5.2; skipped with ``rotate=False``
       by a caller that draws the next batch itself, as the Trainer does)

The step, its forward, its backward and steps 2-4 run inside the
``repro_torch.spans`` ranges ``repro.step``, ``repro.forward``,
``repro.backward`` and ``repro.update``, which cost one C call each unless
a profiler records.

**Per-leaf** (``gossip_packed=False``, the reference's default): the params
are a tree of tensors, the autograd leaves; the loss runs over the tree,
then the tree-level ``optimizer.update``, then the per-leaf engine's
``comm_params`` (``core.gossip.make_gossip_mix``; ``mix_impl`` may put a
kernel such as ``kernels.gossip_mix_1d`` under every leaf). A compressed
wire or the fused engine needs the packed params and raises here, as in
the reference.

**Packed** (``gossip_packed=True``): every bucket is ``(rows, size)``;
the forward runs over ``PackedParams.unpack()``, so the gradients arrive
packed in ``bucket.grad``.

**The distribution plan** (``dist=``, a ``train.sharding.Distribution``
from ``make_distribution(launch.mesh.make_smoke_mesh(...), mode)``): dp
is ``dist.dp``, and when the plan shards inside a replica
(``dist.shard_axes``: fsdp's data and model, replica mode's model) the
packed engines run on the SHARD-LOCAL layout the reference builds
(``_build_packed_layout``): each in-replica position's pieces of every
leaf in its own stretch of every bucket. On one device the replicas stay
stacked and whole: the layout moves bytes, not arithmetic, so the step
computes what the flat layout computes (``unpack`` assembles each leaf).
lars's fused backend cannot run on it (fused then defaults off, and
asking for it raises), as in the reference. ``dp=`` without a plan
is the flat layout over dp stacked replicas.

**One process per mesh position** (``group``, a ``core.replica_group.
ReplicaGroup`` joined with the plan): each process holds one replica row,
and under a plan that shards inside a replica only its stretch of every
bucket (``init_train_state`` keeps its pieces of a drawn or given tree,
or its chunk of a ready stacked ``PackedParams``). The forward all-gathers
the replica's stretches and the backward reduce-scatters the gradient
(``PackedParams.unpack``); the batch rows of a replica split over the
shard axes that are batch axes (fsdp's ``data``), so a rank's loss is
scaled by ``1 / batch_shards`` and the summed gradient is the replica's
mean-loss gradient. The engines, the wire, the ring and the replica means
run over the cross-replica group on the stretches. The per-leaf engines
hold the rank's piece of every leaf instead (the same partition,
``BucketLayout.cut_pieces``; ``bundle.pieces`` is its table): the forward
all-gathers each leaf over the in-replica group and the backward
reduce-scatters its gradient over the batch group
(``BucketLayout.gather_pieces``), the optimizer runs on the pieces (lars
adds its squares over the replica's shards, then the replicas), and the
mix, the ring and the replica means run on them over the cross-replica
group, as the reference's per-leaf engine runs on its sharded arrays.
The step runs under ``dist_ctx.use_distribution(dist, group)``, as the
reference's runs under its plan.

**Expert parallelism** (a group whose model group has ``M > 1`` members,
MoE layers with ``E % M == 0``): a rank computes only its ``E / M``
experts and sums the partial outputs over its model group
(``models.moe._expert_compute_manual``). The per-leaf engines then
gather an expert leaf over the batch group only, the rank's block of its
experts (``BucketLayout.gather_pieces(experts=)``); the packed engines
gather whole buckets and the layer slices its experts. A stretch's or
piece's gradient stays the batch-group sum: rank ``(d, m)``'s piece of an
expert leaf lies in expert block ``m``, which only the members ``(d',
m)`` compute.

**Fused mix+apply** (default for packed sgd, adamw and lars, never
per-leaf): steps 3-4 are one single-sweep kernel per bucket that mixes with
the partner's PRE-update bucket (``core.gossip.make_packed_fused_update``),
the reference's GoSGD-style combined update; dp == 1, ``agd``,
``every_logp`` and ``none`` run it with alpha = 0. ``agd`` averages the
gradients before the sweep and ``every_logp`` averages the params after it
on its averaging steps (a separate pass, as in the reference).
``fused_update=False`` keeps the mix-then-apply composition.

**gossip_async** (``core.async_gossip``): the state carries the staleness-k
inbox ring (``state["inbox"]``). Unfused (per-leaf or packed), the masked
arrival mix of the oldest slot and the re-dispatch run BEFORE the forward
pass, in place under ``no_grad`` on the autograd leaves; fused, the ring's
oldest slot is the fused sweep's partner and each bucket is dispatched just
before its sweep. Both gossip protocols take the compressed /
partition-sampled wire on the packed engines (``wire_dtype``,
``gossip_subset``, ``wire_seed``) and rotate the batch shards.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import (PackedParams, build_layout, make_protocol,
                              make_ring_shuffle)
from repro_torch.core.async_gossip import (init_inbox_ring,
                                           init_wire_inbox_ring,
                                           make_packed_fused_async_update)
from repro_torch.core.gossip import (group_mean, local_rows,
                                     make_packed_fused_update, replica_mean)
from repro_torch.device import resolve_device
from repro_torch.dist_ctx import use_distribution
from repro_torch.core.replica_group import ReplicaGroup
from repro_torch.kernels.quantize import WireFormat
from repro_torch.mesh_spec import PartitionSpec
from repro_torch.models import lm_init, lm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer
from repro_torch.spans import BACKWARD, FORWARD, STEP, UPDATE, span
from repro_torch.tree import tree_flatten, tree_map

from .loss import make_loss_fn
from .sharding import Distribution

__all__ = ["TrainStepBundle", "make_train_step_bundle", "init_train_state",
           "expert_dims"]


class TrainStepBundle:
    def __init__(self, *, step_fn, protocol, cfg, optimizer, dp, layout,
                 fused, device, wire, group, dist=None, pieces=None):
        self.step_fn = step_fn      # (state, batch, phase, rotate) -> (state, next_batch, metrics)
        self.protocol = protocol
        self.cfg = cfg
        self.optimizer = optimizer
        self.dp = dp
        self.layout = layout        # BucketLayout of the packed engine (None per-leaf)
        self.fused = fused          # single-sweep fused mix+apply engine
        self.device = device
        self.wire = wire            # the protocol's WireFormat
        self.group = group          # this process's ReplicaGroup, or None
        self.dist = dist            # the Distribution it was built for, or None
        self.pieces = pieces        # a per-leaf rank's piece table (a
                                    # shard-local BucketLayout), or None

    def step(self, state, batch, phase: int, *, rotate: bool = True):
        """``(state, next_batch, metrics)``; ``rotate=False`` skips the ring
        shuffle and returns ``batch`` as ``next_batch``."""
        return self.step_fn(state, batch, phase % self.protocol.period,
                            rotate)


def _stacked(tree, cfg: ModelConfig, rows: int):
    """A param tree with ``rows`` replicas leading every leaf: a leaf of
    one replica's shape is copied to every row, a leaf that already leads
    with the replica axis is taken as it is."""
    specs, td = tree_flatten(lm_specs(cfg))
    out = []
    for spec, x in zip(specs, td.flatten_up_to(tree)):
        shape = tuple(spec.shape)
        if tuple(x.shape) == shape:
            x = x.detach().unsqueeze(0).expand((rows,) + shape).clone()
        elif tuple(x.shape) != (rows,) + shape:
            raise ValueError(f"leaf of shape {tuple(x.shape)}: want {shape} "
                             f"or {(rows,) + shape}")
        out.append(x)
    return td.unflatten(out)


def _resolve_dp(dp: Optional[int], dist: Optional[Distribution],
                group: Optional[ReplicaGroup]) -> int:
    """dp from ``dp=`` or from the plan (both: they must agree). A replica
    group must hold the plan's shards: one joined with the plan
    (``launch.mesh.init_replica_group(dist=...)``)."""
    if dist is None:
        if dp is None:
            raise TypeError("pass dp= or dist=")
        return int(dp)
    if dp is not None and int(dp) != dist.dp:
        raise ValueError(f"dp={dp} but the distribution gives dp={dist.dp}")
    if group is not None and dist.shard_axes:
        shards = int(np.prod(dist.shard_axis_sizes))
        if group.num_shards != shards:
            raise ValueError(
                f"the plan shards a replica {shards} ways (axes "
                f"{dist.shard_axes}) but the replica group holds "
                f"{group.num_shards}: join it with the plan "
                "(init_replica_group(dist=...))")
    return dist.dp


def _build_packed_layout(dist: Optional[Distribution], cfg: ModelConfig):
    """The packed engines' layout: flat without a plan or when the plan
    shards nothing inside a replica; else SHARD-LOCAL over
    ``dist.shard_axes``, each leaf's in-replica spec from its logical
    axes, as the reference's ``_build_packed_layout`` builds it
    (``src/repro/train/step.py``). ``Distribution.leaf_spec`` never puts
    a replica axis on a non-leading dim, so the in-replica spec is the
    rest of the leaf's spec."""
    specs = lm_specs(cfg)
    if dist is None or not dist.shard_axes:
        return build_layout(specs)
    leaves, td = tree_flatten(specs)
    full = [dist.leaf_spec(s.shape, s.axes, True) for s in leaves]
    return build_layout(specs, shard_axes=dist.shard_axes,
                        shard_axis_sizes=dist.shard_axis_sizes,
                        shard_specs=td.unflatten(
                            [in_replica_spec(dist, tuple(p)[1:])
                             for p in full]))


def in_replica_spec(dist: Distribution, dims) -> PartitionSpec:
    """A leaf's in-replica spec from its per-replica ``dims``: the mesh
    axes that shard inside a replica, size-1 axes dropped (they shard
    nothing)."""
    out = []
    for dim in dims:
        axes = dim if isinstance(dim, tuple) else (dim,) if dim else ()
        kept = tuple(a for a in axes if a in dist.shard_axes)
        out.append(kept if len(kept) > 1 else kept[0] if kept else None)
    return PartitionSpec(*out)


def _piece_layout(dist: Optional[Distribution], cfg: ModelConfig,
                  group: Optional[ReplicaGroup], packed: bool):
    """A per-leaf rank's piece table: the plan's shard-local layout
    (``_build_packed_layout``; only its slots are read) when the rank holds
    one shard of a replica that the plan splits, else None."""
    if packed or group is None or group.num_shards <= 1:
        return None
    if dist is None:
        raise ValueError("a replica group with in-replica shards needs the "
                         "plan it was joined with: pass dist=")
    return _build_packed_layout(dist, cfg)


def expert_dims(cfg: ModelConfig, dist: Optional[Distribution],
                group: Optional[ReplicaGroup]):
    """Per leaf of ``lm_specs(cfg)``, the dim of the experts that a rank of
    ``group`` owns ``E / M`` of (``Distribution.expert_dims``), where the
    rank has a model group of ``M > 1`` members; else None (no expert
    parallelism: every leaf is gathered whole)."""
    if dist is None or group is None or group.model is None:
        return None
    return dist.expert_dims(lm_specs(cfg))


def _rank_chunk(packed: PackedParams, group: ReplicaGroup,
                dev) -> PackedParams:
    """This rank's part of a ready ``PackedParams``: its replica's row of
    stacked buckets (a one-row ``PackedParams`` is every replica's), then
    its shard's chunk."""
    lay, out = packed.layout, []
    for b, x in enumerate(packed.buckets):
        x = x.detach()
        if x.shape[0] == group.dp and group.dp > 1:
            x = x[group.replica:group.replica + 1]
        elif x.shape[0] != 1:
            raise ValueError(f"bucket {b} has {x.shape[0]} rows for "
                             f"{group.dp} replicas")
        if x.shape[-1] != lay.bucket_sizes[b]:
            raise ValueError(f"bucket {b} of length {x.shape[-1]}: want "
                             f"{lay.bucket_sizes[b]}")
        stride = lay.strides[b]
        x = x[..., group.shard * stride:(group.shard + 1) * stride]
        out.append(x.to(dev).clone())
    return PackedParams(out, lay, group)


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *,
                     dp: Optional[int] = None,
                     dist: Optional[Distribution] = None,
                     packed: bool = False, layout=None, seed: int = 0,
                     params=None, device="cuda", inbox: int = 0,
                     wire: WireFormat = WireFormat(),
                     group: Optional[ReplicaGroup] = None):
    """``{"params", "opt"}`` with every replica holding the same initial
    params (the reference replicates one init): a tree of leaves
    ``(rows, *shape)``, or with ``packed`` a ``PackedParams`` of
    ``(rows, size)`` buckets (pass the bundle's ``layout``; a plan that
    shards inside a replica needs it). ``rows`` is dp (``dp=``, or
    ``dist.dp`` of the plan ``dist``), or 1 under a replica group (pass
    the bundle's ``group``), whose buckets are the rank's stretches.
    ``params`` may give that replica's tree (or a ready ``PackedParams``,
    e.g. from ``checkpoint.bridge``, of which a rank keeps its replica's
    row and its shard's chunk) instead of drawing it with ``seed``. A
    per-leaf rank of a plan that shards inside a replica keeps its piece
    of every leaf (``BucketLayout.cut_pieces``).

    ``inbox`` is the ring depth (pass the bundle's ``protocol.staleness``;
    0 = no ring) and ``wire`` the bundle's ``wire``: gossip_async carries a
    ring bootstrapped all-invalid, its slots copies of the params or, under
    a compressed wire (packed only), zero payloads."""
    dev = resolve_device(device)
    dp = _resolve_dp(dp, dist, group)
    rows = local_rows(dp, group)
    if not wire.is_default and inbox and not packed:
        raise ValueError("the compressed wire needs packed state")
    if packed:
        if layout is None and dist is not None and dist.shard_axes:
            raise ValueError(
                f"this distribution shards inside a replica (axes "
                f"{dist.shard_axes}); packed init needs the bundle's "
                "shard-local layout: pass layout=bundle.layout")
        layout = layout if layout is not None else build_layout(lm_specs(cfg))
        if isinstance(params, PackedParams) and group is not None:
            params = _rank_chunk(params, group, dev)
        elif not isinstance(params, PackedParams):
            tree = params if params is not None else lm_init(cfg, seed=seed,
                                                             device=dev)
            params = PackedParams.pack(tree, layout, lead=(rows,), device=dev,
                                       group=group)
        leaves = params.buckets
    else:
        tree = params if params is not None else lm_init(cfg, seed=seed,
                                                         device=dev)
        params = _stacked(tree_map(lambda x: x.to(dev), tree), cfg, rows)
        pieces = _piece_layout(dist, cfg, group, packed)
        if pieces is not None:
            params = pieces.cut_pieces(params, group.shard)
        leaves = tree_flatten(params)[0]
    for x in leaves:
        x.requires_grad_(True)
    state = {"params": params, "opt": optimizer.init(params)}
    if inbox:
        state["inbox"] = (init_inbox_ring(params, inbox, rows)
                          if wire.is_default
                          else init_wire_inbox_ring(params, inbox, rows, wire))
    return state


def make_train_step_bundle(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    dp: Optional[int] = None,
    dist: Optional[Distribution] = None,
    protocol: str = "gossip",
    topology: str = "dissemination",
    num_rotations: int = 2,
    gossip_mode: str = "static",
    gossip_packed: bool = False,
    gossip_alpha: float = 0.5,
    staleness: int = 1,
    drop_rate: float = 0.0,
    drop_seed: int = 0,
    wire_dtype: str = "fp32",
    gossip_subset: float = 1.0,
    wire_seed: int = 0,
    fused_update: Optional[bool] = None,
    mix_impl: Optional[Callable] = None,
    rotate_samples: Optional[bool] = None,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    ssm_scan_impl: Optional[Callable] = None,
    seed: int = 0,
    device="cuda",
    group: Optional[ReplicaGroup] = None,
) -> TrainStepBundle:
    """Build the train step for ``dp`` replicas (``dp=``, or the plan
    ``dist``, which also picks a shard-local layout for the packed engines
    when it shards inside a replica) under ``protocol``.
    ``gossip_packed`` picks the bucketed engines (default: the per-leaf
    ones, whose mix ``mix_impl`` may replace and whose phase ``gossip_mode``
    selects as ``core.gossip.make_gossip_mix`` does).
    ``fused_update=None`` turns the fused engine on when the params are
    packed and the optimizer has a fused backend that runs on the layout
    (lars's does not on a shard-local one, and asking for it there
    raises); the fused engine and a compressed wire need
    ``gossip_packed``. ``staleness``, ``drop_rate``
    and ``drop_seed`` configure gossip_async's ring; ``wire_dtype``,
    ``gossip_subset`` and ``wire_seed`` the gossip wire.
    ``rotate_samples`` (default: on for the gossip protocols) ring-rotates
    the batch shards after each step (§4.5.2). ``remat`` (default on, as
    the reference's) checkpoints each layer group and ``remat_policy``
    ("dots") saves its weight products (``models.blocks.stack_apply``): the
    same values, less activation memory, more time. ``ssm_scan_impl``
    replaces the Mamba layers' scan (e.g.
    ``models.mamba.ssm_scan_chunked_torch``, the long-sequence train scan).
    ``group`` runs one mesh position per process (a
    ``core.replica_group.ReplicaGroup``; None: the dp replicas stacked on
    ``device``); with a model group the MoE layers split their experts
    over it."""
    dev = resolve_device(device)
    dp = _resolve_dp(dp, dist, group)
    local_rows(dp, group)
    mesh = dist.mesh if dist is not None else None
    wire = WireFormat(dtype=wire_dtype, subset=gossip_subset, seed=wire_seed)
    if (not wire.is_default and protocol in ("gossip", "gossip_async")
            and not gossip_packed):
        raise ValueError(
            f"the compressed/partition-sampled wire (wire_dtype="
            f"{wire_dtype!r}, gossip_subset={gossip_subset}) needs "
            "gossip_packed=True: the per-leaf path has no lane-aligned "
            "buckets to quantize over")
    layout = None
    if gossip_packed:
        if not (optimizer.elementwise or optimizer.packed_aware):
            raise ValueError(
                "gossip_packed requires an elementwise or packed-aware "
                "optimizer: its per-leaf norms would span whole buckets; "
                "use sgd/adamw/lars or the per-leaf gossip path")
        layout = _build_packed_layout(dist, cfg)
    shard_local_ok = (layout is None or layout.num_shards == 1
                      or optimizer.fused_shard_local)
    if fused_update is None:
        fused_update = (gossip_packed and optimizer.fused_update is not None
                        and shard_local_ok)
    if fused_update and not gossip_packed:
        raise ValueError("fused_update needs the bucketed engine: pass "
                         "gossip_packed=True")
    if fused_update and optimizer.fused_update is None:
        raise ValueError("fused_update=True but this optimizer has no fused "
                         "backend; use sgd, adamw or lars, or "
                         "fused_update=False")
    if fused_update and not shard_local_ok:
        raise ValueError(
            "fused_update=True but this optimizer's fused backend does not "
            "support shard-local (hierarchical) bucket layouts; use "
            "sgd/adamw or fused_update=False")
    if gossip_packed and mix_impl is not None:
        raise ValueError("mix_impl replaces the per-leaf engine's mix; the "
                         "packed engines run the bucket kernels")
    proto = make_protocol(protocol, dp, topology=topology,
                          num_rotations=num_rotations, alpha=gossip_alpha,
                          staleness=staleness, drop_rate=drop_rate,
                          drop_seed=drop_seed, mode=gossip_mode,
                          mix_impl=mix_impl, packed_layout=layout,
                          seed=seed, wire_dtype=wire_dtype,
                          gossip_subset=gossip_subset, wire_seed=wire_seed,
                          group=group, mesh=mesh)
    ring = proto.staleness > 0
    fused_eng = None
    if fused_update:
        if ring:
            fused_eng = make_packed_fused_async_update(
                proto.schedule, layout, optimizer, alpha=gossip_alpha,
                staleness=proto.staleness, drop_rate=drop_rate,
                drop_seed=drop_seed, wire=proto.wire, group=group, mesh=mesh)
        else:
            gossiping = protocol == "gossip" and dp > 1
            fused_eng = make_packed_fused_update(
                proto.schedule if gossiping else None, layout, optimizer,
                alpha=gossip_alpha if gossiping else 0.0, wire=proto.wire,
                group=group, mesh=mesh)
    loss_fn = make_loss_fn(cfg, ssm_scan_impl=ssm_scan_impl, remat=remat,
                           remat_policy=remat_policy)
    if rotate_samples is None:
        rotate_samples = protocol in ("gossip", "gossip_async")
    shuffle = (make_ring_shuffle(dp, group) if rotate_samples and dp > 1
               else None)

    pieces = _piece_layout(dist, cfg, group, gossip_packed)
    experts = expert_dims(cfg, dist, group)

    def as_tree(params):
        if gossip_packed:
            return params.unpack()
        return (pieces.gather_pieces(params, group, experts) if pieces
                else params)

    def autograd_leaves(params):
        return params.buckets if gossip_packed else tree_flatten(params)[0]

    def grads_of(params):
        if gossip_packed:
            return params.like([b.grad for b in params.buckets])
        return tree_map(lambda x: x.grad, params)

    # a rank's rows are 1/batch_shards of its replica's: the batch group's
    # summed gradient is the replica's mean-loss gradient
    loss_scale = 1.0 / group.batch_shards if group is not None else 1.0

    def train_step(state, batch, phase: int, rotate: bool = True):
        with span(STEP):
            return step_body(state, batch, phase, rotate)

    def step_body(state, batch, phase: int, rotate: bool):
        params, inbox = state["params"], state.get("inbox")
        if ring and fused_eng is None:
            # bounded-delay arrival: mix the oldest slot in and re-dispatch,
            # in place on the autograd leaves, before the forward pass
            with torch.no_grad(), span(UPDATE):
                params, inbox = proto.comm_params(params, phase, inbox=inbox)
        with use_distribution(dist, group):
            with span(FORWARD):
                loss, metrics = loss_fn(as_tree(params), batch)
                # replica r's grad is d loss_r / d params_r
                total = loss.sum()
            with span(BACKWARD):
                (total * loss_scale if loss_scale != 1.0 else total).backward()
        grads = grads_of(params)
        with torch.no_grad(), span(UPDATE):
            grads = proto.comm_grads(grads, phase)
            if fused_eng is not None and ring:
                params, opt, inbox = fused_eng(params, grads, inbox,
                                               state["opt"], phase)
            elif fused_eng is not None:
                params, opt = fused_eng(params, grads, state["opt"], phase)
                if proto.name == "every_logp":
                    params = proto.comm_params(params, phase)
            else:
                params, opt = optimizer.update(params, grads, state["opt"],
                                               group=group)
                if not ring:
                    params = proto.comm_params(params, phase)
        for x in autograd_leaves(params):
            x.grad = None
        next_batch = (shuffle(batch) if shuffle is not None and rotate
                      else batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:
            metrics = {k: replica_mean(group_mean(v, group.batch,
                                                  group.batch_shards), group)
                       for k, v in metrics.items()}
        metrics = {k: v.mean() for k, v in metrics.items()}
        new_state = {"params": params, "opt": opt}
        if ring:
            new_state["inbox"] = inbox
        return new_state, next_batch, metrics

    return TrainStepBundle(step_fn=train_step, protocol=proto, cfg=cfg,
                           optimizer=optimizer, dp=dp, layout=layout,
                           fused=bool(fused_update), device=dev,
                           wire=proto.wire, group=group, dist=dist,
                           pieces=pieces)
