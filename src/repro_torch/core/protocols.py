"""Communication protocols around the local update (GossipGraD Table 6).

Port of ``repro/core/protocols.py`` (``Protocol``, ``make_protocol``,
``_replica_mean``) on the per-leaf and the packed engines, plus
``make_ring_shuffle`` from ``repro/core/shuffle.py``, on replicas stacked
on one device or one per process (a ``core.replica_group.ReplicaGroup``,
passed as ``group`` to ``make_protocol`` and ``make_ring_shuffle``).

    gossip        local update, then average params with the step's partner
                  (the paper's algorithm, §4);
    gossip_async  bounded-delay inbox ring (§4.2/§5, core.async_gossip): the
                  arrival mix of the oldest of k in-flight exchanges (a
                  dropped one is skipped) and the re-dispatch run BEFORE the
                  forward pass;
    agd           gradients averaged over the replicas every step, the
                  paper's all-reduce baseline (§3.1/§7.1);
    every_logp    params averaged over the replicas after every
                  ``schedule.substeps``-th step (ceil(log2 dp)), local
                  updates between (§7.5's amortized alternative);
    none          no communication (the ensemble extreme, §4.1).

The train step calls ``comm_grads`` before the optimizer and, for the
synchronous protocols, ``comm_params(params, phase)`` after it;
``gossip_async`` (``staleness > 0``) calls ``comm_params(params, phase,
inbox=ring) -> (params, ring)`` before the forward pass. A compressed or
partition-sampled wire (``wire_dtype``, ``gossip_subset``, ``wire_seed``)
applies to both gossip protocols; ``period`` is then the lcm of the partner
schedule and the subset rotation, and the trainer folds its step by it.
every_logp's ``period`` is its schedule's, so the folded phase still counts
the substeps.

Without ``packed_layout`` the gossip protocols build the per-leaf
engines (``core.gossip.make_gossip_mix``, ``core.async_gossip.
make_async_gossip_mix``) over a param tree; a compressed or
partition-sampled wire needs the packed engines and raises there, as in
the reference.

The replica mean is ``core.gossip.replica_mean`` on every bucket or leaf:
the reference's ``jnp.mean`` over the replica axis as XLA compiles it (the
replicas summed in fp32 in order from a zero, times the fp32 reciprocal of
dp; XLA rewrites the division by the constant dp as that product, so at
dp = 3 or 6 it is not the correctly rounded quotient), rounded once to the
tensor's dtype. ``core.simulate.allreduce_mean_sim`` is the same function.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.kernels.quantize import WireFormat
from repro_torch.tree import tree_flatten, tree_map

from .async_gossip import make_async_gossip_mix, make_packed_async_gossip_mix
from .buckets import BucketLayout, PackedParams
from .gossip import (_exchange, _RecvTables, make_gossip_mix,
                     make_packed_gossip_mix, replica_mean, wire_period,
                     wire_subset_of)
from .replica_group import ReplicaGroup
from .topology import GossipSchedule, build_schedule

__all__ = ["PROTOCOLS", "Protocol", "make_protocol", "make_ring_shuffle"]

PROTOCOLS = ("gossip", "gossip_async", "agd", "every_logp", "none")


def _replica_mean(params, group: Optional[ReplicaGroup] = None):
    """Every bucket (``PackedParams``) or leaf (a tree) replaced, in place,
    by its mean over the replicas."""
    xs = (params.buckets if isinstance(params, PackedParams)
          else tree_flatten(params)[0])
    for x in xs:
        x.copy_(replica_mean(x, group))
    return params


@dataclasses.dataclass
class Protocol:
    name: str
    dp: int
    schedule: Optional[GossipSchedule]
    _mix: Optional[Callable]
    # inbox-ring depth k of gossip_async at dp > 1; 0 for sync protocols
    staleness: int = 0
    # the gossip wire (the default one for a protocol that does not gossip)
    wire: WireFormat = dataclasses.field(default_factory=WireFormat)
    # lcm(schedule period, subset rotation), every_logp's schedule period;
    # the trainer folds its step by it
    period: int = 1
    # the replica group when this process holds one replica (None: stacked)
    group: Optional[ReplicaGroup] = None

    @property
    def carries_inbox(self) -> bool:
        """True when the train state carries the inbox ring."""
        return self.staleness > 0

    def comm_grads(self, grads, phase):
        if self.name == "agd" and self.dp > 1:
            return _replica_mean(grads, self.group)
        return grads

    def comm_params(self, params, phase, inbox=None):
        """Sync gossip: ``params`` after the update, mixed. gossip_async
        (dp > 1): ``(params, ring)`` before the forward pass."""
        if self.staleness > 0:
            if inbox is None:
                raise ValueError(
                    "gossip_async needs the inbox ring: comm_params(params, "
                    "phase, inbox): the train state must carry it")
            return self._mix(params, inbox, phase)
        if self.dp <= 1:
            return params
        if self.name == "gossip":
            return self._mix(params, phase)
        if self.name == "every_logp" and \
                (int(phase) + 1) % self.schedule.substeps == 0:
            return _replica_mean(params, self.group)
        return params


def make_protocol(name: str, dp: int, *, topology: str = "dissemination",
                  num_rotations: int = 2, alpha: float = 0.5,
                  staleness: int = 1, drop_rate: float = 0.0,
                  drop_seed: int = 0,
                  mode: str = "static", mix_impl: Callable | None = None,
                  packed_layout: BucketLayout | None = None,
                  seed: int = 0, wire_dtype: str = "fp32",
                  gossip_subset: float = 1.0, wire_seed: int = 0,
                  group: Optional[ReplicaGroup] = None,
                  mesh=None) -> Protocol:
    """Protocol over ``dp`` replicas. The gossip protocols at dp > 1 build
    the schedule and the engine: the packed bucket engine with
    ``packed_layout``, else the per-leaf one (``mode`` and ``mix_impl``
    as ``core.gossip.make_gossip_mix`` takes them); every_logp builds the
    schedule for its averaging period. ``staleness`` is gossip_async's
    ring depth k; ``drop_rate`` and ``drop_seed`` drive its
    ``exchange_ok`` drop injection. ``group``: the replica group when this
    process holds one replica (None: the replicas are stacked). ``mesh``
    (a ``mesh_spec.MeshSpec``) reaches the packed engines, which check a
    shard-local layout against it."""
    if name not in PROTOCOLS:
        raise ValueError(f"unknown protocol {name!r}; options {PROTOCOLS}")
    if name == "gossip_async" and staleness < 1:
        raise ValueError(f"gossip_async staleness must be >= 1, "
                         f"got {staleness}")
    wire = WireFormat(dtype=wire_dtype, subset=gossip_subset, seed=wire_seed)
    if (not wire.is_default and dp > 1 and name in ("gossip", "gossip_async")
            and packed_layout is None):
        raise ValueError(
            f"the compressed/partition-sampled wire (wire_dtype="
            f"{wire_dtype!r}, gossip_subset={gossip_subset}) needs the "
            "packed gossip engines: pass packed_layout")
    if name == "every_logp" and dp > 1:
        schedule = build_schedule(dp, topology=topology,
                                  num_rotations=num_rotations, seed=seed)
        return Protocol(name=name, dp=dp, schedule=schedule, _mix=None,
                        period=schedule.period, group=group)
    gossiping = dp > 1 and name in ("gossip", "gossip_async")
    if not gossiping:
        return Protocol(name=name, dp=dp, schedule=None, _mix=None,
                        group=group)
    schedule = build_schedule(dp, topology=topology,
                              num_rotations=num_rotations, seed=seed)
    if packed_layout is None:
        if name == "gossip":
            mix = make_gossip_mix(schedule, alpha=alpha, mode=mode,
                                  mix_impl=mix_impl, group=group)
        else:
            mix = make_async_gossip_mix(
                schedule, alpha=alpha, staleness=staleness,
                drop_rate=drop_rate, drop_seed=drop_seed, mode=mode,
                mix_impl=mix_impl, group=group)
        period = schedule.period
    else:
        if name == "gossip":
            mix = make_packed_gossip_mix(schedule, packed_layout, alpha=alpha,
                                         wire=wire, group=group, mesh=mesh)
        else:
            mix = make_packed_async_gossip_mix(
                schedule, packed_layout, alpha=alpha, staleness=staleness,
                drop_rate=drop_rate, drop_seed=drop_seed, wire=wire,
                group=group, mesh=mesh)
        period = wire_period(schedule,
                             wire_subset_of(wire, packed_layout.num_buckets))
    return Protocol(name=name, dp=dp, schedule=schedule, _mix=mix,
                    staleness=int(staleness) if name == "gossip_async" else 0,
                    wire=wire, period=period, group=group)


def make_ring_shuffle(p: int, group: Optional[ReplicaGroup] = None
                      ) -> Callable:
    """``shuffle(batch) -> batch`` rotating every replica's shard one ring
    position over ``p`` replicas (§4.5.2): replica j receives replica j-1's
    shard, the reference's ppermute with pairs (i, i+1), as one
    ``exchange`` over the ring topology's row (under a replica group a
    send of the rank's rows to the next replica at the same shard
    position), outside the exchange's span and counters."""
    recv = _RecvTables(build_schedule(p, topology="ring", num_rotations=1),
                       group)
    return lambda batch: tree_map(
        lambda x: _exchange(x, recv(0, x.device), group), batch)
