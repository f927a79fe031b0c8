"""Gossip mixing over replicas stacked on one device or one per process
(GossipGraD §4-5).

Port of ``repro/core/gossip.py`` (``wire_subset_of``, ``wire_period``,
``_encode_bucket``, ``linear_pairs``, ``make_gossip_mix``,
``make_packed_gossip_mix``, ``packed_fused_local_update``,
``make_packed_fused_update``, and the byte accounting
``gossip_bytes_per_step``, ``wire_bytes_per_step``; ``sent_bytes_at`` is
the port's own). The reference keeps one replica per device
and exchanges with ``jax.lax.ppermute`` inside ``shard_map``. Here the
replicas live either stacked on one device, as the leading axis of every
tensor, where the exchange is the single-device ``ppermute`` that
``core/simulate.py`` defines as equivalent (replica j receives
``x[recv_from[j]]``), or one per process of a ``core.replica_group.
ReplicaGroup``, where the same ``exchange`` sends and receives point to
point. ``replica_mean`` is the other primitive that reaches the other
replicas; engines see only these two (and the ring shuffle, an exchange),
so every engine runs either way. An engine takes its ``group`` (None:
stacked) when it is built and passes it to both.

* ``make_gossip_mix`` (per-leaf engine): per leaf of a param tree, one
  exchange and the mix ``x * (1 - alpha) + recv * alpha`` in the leaf's
  dtype, op by op as the reference's ``_mix_leaf``, or through
  ``mix_impl`` (e.g. ``kernels.gossip_mix_1d``, one kernel launch per
  leaf viewed as ``(rows, -1)``), in place on the leaves.
* ``make_packed_gossip_mix`` (unfused engine): per sent bucket, one
  exchange and one in-place mix kernel (``kernels.ops.gossip_mix_bucket``).
* ``make_packed_fused_update`` (fused engine): per bucket, the exchange of
  the partner's PRE-update params and then one single-sweep fused
  mix+update kernel of the optimizer (sgd, adamw or lars), the GoSGD-style
  combined update of the reference. With every replica in one tensor the
  updates run in place, so a bucket's exchange is taken right before that
  bucket's update, never after it.

The packed engines sweep a shard-local (hierarchical) layout's buckets
unchanged: shard s of a bucket is the row's stretch ``[s * stride, (s + 1)
* stride)``, and the wire encodes the whole row keyed by the global element
index, which is what the reference's per-shard encode at ``base_index = s *
stride`` computes (``stride`` is a LANE multiple, so no scale tile crosses
a shard).

Both engines run one path for every ``wire`` (``kernels.quantize.
WireFormat``): each bucket of the step's rotating subset is encoded on the
dispatch side (row r keyed on the phase and rank r), its payload exchanged
and decoded inside the mix or fused sweep; buckets outside the subset
exchange nothing and pass through (unfused) or take the pure local update
(fused). The default wire (fp32, every bucket) encodes a bucket as itself
and sends them all. Phases run modulo ``wire_period``, and the sync wire
keys its noise on that folded phase, as the reference does. Both engines
run in place on the buckets and return them.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.fused_update import device_scalar
from repro_torch.kernels.ops import gossip_mix_bucket
from repro_torch.kernels.quantize import (WireFormat, encode_wire, wire_itemsize,
                                          wire_key)
from repro_torch.tree import tree_flatten

from .buckets import LANE, BucketLayout, PackedParams, check_layout_mesh
from .replica_group import ReplicaGroup
from .topology import (BucketSubsetSchedule, GossipSchedule,
                       build_subset_schedule)

__all__ = ["exchange", "replica_mean", "replica_ranks", "replica_count",
           "local_rows", "wire_subset_of", "wire_period",
           "encode_bucket", "linear_pairs", "make_gossip_mix",
           "make_packed_gossip_mix", "packed_fused_local_update",
           "make_packed_fused_update", "gossip_bytes_per_step",
           "wire_bytes_per_step", "sent_bytes_at"]


def replica_ranks(rows: int, group: Optional[ReplicaGroup] = None
                  ) -> np.ndarray:
    """The replica ranks of a tensor's ``rows`` leading rows: all of them
    when stacked, this process's rank under a replica group."""
    return np.arange(rows) if group is None else group.ranks()


def replica_count(rows: int, group: Optional[ReplicaGroup] = None) -> int:
    """The number of replicas when this process holds ``rows`` of them."""
    return rows if group is None else group.world_size * rows


def local_rows(dp: int, group: Optional[ReplicaGroup] = None) -> int:
    """The replica rows this process holds of ``dp`` replicas: dp when
    stacked, one under a replica group of dp ranks."""
    if group is None:
        return dp
    if group.world_size != dp:
        raise ValueError(f"dp={dp} replicas but the replica group has "
                         f"{group.world_size} ranks")
    return 1


def _tensors(x) -> list:
    return list(x.values()) if isinstance(x, dict) else [x]


def _exchange_ranks(x, recv_from, group):
    """``exchange`` between processes: this rank sends its tensors to every
    rank j with ``recv_from[j] == rank`` and receives from
    ``recv_from[rank]``, all in one batch of point-to-point operations."""
    rf = np.asarray(recv_from.cpu() if isinstance(recv_from, torch.Tensor)
                    else recv_from).reshape(-1)
    if rf.shape[0] != group.world_size:
        raise ValueError(f"recv_from has {rf.shape[0]} entries for a world "
                         f"of {group.world_size}")
    me, src = group.rank, int(rf[group.rank])
    dsts = [int(j) for j in np.nonzero(rf == me)[0] if j != me]
    ins = _tensors(x)
    outs = [t.clone() if src == me else torch.empty_like(t) for t in ins]
    ops = []
    for tag, (t, o) in enumerate(zip(ins, outs)):
        t = t.contiguous()
        ops += [dist.P2POp(dist.isend, t, d, tag=tag) for d in dsts]
        if src != me:
            ops.append(dist.P2POp(dist.irecv, o, src, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if isinstance(x, dict):
        return dict(zip(x.keys(), outs))
    return outs[0]


def exchange(x, recv_from, group: Optional[ReplicaGroup] = None):
    """The step's ppermute: new tensors whose replica j holds replica
    ``recv_from[j]`` of ``x`` (a bucket, a leaf, or a wire payload's codes
    and scales alike). Stacked (``group`` None), ``recv_from`` is an index
    tensor on ``x``'s device and row j is row ``recv_from[j]``; under a
    replica group it is the whole row of ranks (host ints) and the rows
    move between processes."""
    if group is not None:
        return _exchange_ranks(x, recv_from, group)
    if isinstance(x, dict):
        return {k: v.index_select(0, recv_from) for k, v in x.items()}
    return x.index_select(0, recv_from)


def replica_mean(x: torch.Tensor,
                 group: Optional[ReplicaGroup] = None) -> torch.Tensor:
    """The mean over the replicas of ``x`` (replicas on the leading axis),
    broadcast back to ``x``'s shape and dtype: the reference's ``jnp.mean``
    over the replica axis as XLA compiles it, the rows summed in fp32 in
    rank order from a zero, times the fp32 reciprocal of the replica count
    (a 0-d device tensor, so the product is the same bits on the CPU and
    the card), rounded once. Under a replica group the rows come from an
    ``all_gather`` and are summed in the same order."""
    if group is None:
        rows = x.unbind(0)
    else:
        gathered = [torch.empty_like(x) for _ in range(group.world_size)]
        dist.all_gather(gathered, x.contiguous())
        rows = [r for g in gathered for r in g.unbind(0)]
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for r in rows:
        acc = acc + r.float()
    recip = device_scalar(np.float32(1) / np.float32(len(rows)), x)
    return (acc * recip).to(x.dtype).expand_as(x)


def wire_subset_of(wire: WireFormat,
                   num_buckets: int) -> BucketSubsetSchedule | None:
    """The rotating bucket-subset schedule of a wire format (None for full
    participation)."""
    return build_subset_schedule(num_buckets, wire.subset)


def wire_period(schedule: GossipSchedule | None,
                subset: BucketSubsetSchedule | None) -> int:
    """Phase period of a (partner schedule, bucket subset) pair: the lcm of
    the two rotations, the protocol's ``period``."""
    per = schedule.period if schedule is not None else 1
    if subset is None:
        return per
    return per * subset.period // math.gcd(per, subset.period)


def encode_bucket(wire: WireFormat, bucket: torch.Tensor, t: int,
                  bucket_index: int, group: Optional[ReplicaGroup] = None):
    """Dispatch-side encode of every replica row of one ``(dp, n)`` bucket,
    row r keyed on (``t``, rank r, bucket, seed)."""
    keys = (wire_key(t, replica_ranks(bucket.shape[0], group), bucket_index,
                     wire.seed)
            if wire.dtype == "int8" else None)
    return encode_wire(bucket, wire.dtype, keys=keys)


def send_masks(subset: BucketSubsetSchedule | None, num_buckets: int,
               phase: int) -> np.ndarray:
    """Buckets sent at ``phase`` (all of them without a subset)."""
    if subset is None:
        return np.ones(num_buckets, bool)
    return subset.selected(phase)


class _RecvTables:
    """``recv_from`` of every schedule phase as ``exchange`` takes it: index
    tensors, one copy per device, made on first use; the host row under a
    replica group."""

    def __init__(self, schedule: GossipSchedule,
                 group: Optional[ReplicaGroup] = None):
        self._rows = [schedule.recv_from(t) for t in range(schedule.period)]
        self._on: dict = {}
        self.group = group

    def __call__(self, phase: int, device: torch.device):
        ph = int(phase) % len(self._rows)
        if self.group is not None:
            return self._rows[ph]
        key = (ph, str(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(
                np.asarray(self._rows[ph], np.int64), device=device)
        return self._on[key]


def _check_dp(schedule: GossipSchedule, params,
              group: Optional[ReplicaGroup]) -> None:
    """The schedule's p against the replicas ``params`` (a ``PackedParams``
    or a tree) hold, all processes counted."""
    first = (params.buckets[0] if isinstance(params, PackedParams)
             else tree_flatten(params)[0][0])
    dp = replica_count(first.shape[0], group)
    if schedule.p != dp:
        raise ValueError(f"schedule built for p={schedule.p} but the params "
                         f"hold dp={dp} replicas")


def linear_pairs(schedule: GossipSchedule, step: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """(src, dst) pairs over the replica ranks at ``step``."""
    return tuple((int(i), int(d)) for i, d in enumerate(schedule.send_to(step)))


_MODES = ("static", "dynamic")


def _phase(phase, mode: str) -> int:
    """The host phase: an int in ``static`` mode; ``dynamic`` also takes a
    0-d tensor (the reference's traced phase), read once here."""
    if mode not in _MODES:
        raise ValueError(f"unknown gossip mode {mode!r}")
    if isinstance(phase, torch.Tensor):
        if mode == "static":
            raise TypeError("static mode takes an int phase; use "
                            "mode='dynamic' for a tensor phase")
        return int(phase.item())
    return int(phase)


def leaf_coefs(alpha: float, dtype: torch.dtype) -> Tuple[float, float]:
    """``(1 - alpha, alpha)`` rounded to ``dtype`` as JAX rounds a weak
    Python scalar multiplied into a leaf of that dtype."""
    return tuple(float(torch.tensor(c, dtype=torch.float64).to(dtype))
                 for c in (1.0 - float(alpha), float(alpha)))


def _mix_leaf(x: torch.Tensor, recv: torch.Tensor, alpha, mix_impl):
    """Mix one leaf in place against its exchanged partner. Without
    ``mix_impl``: ``x * (1 - alpha) + recv * alpha`` as two products and a
    sum, each rounded to the leaf's dtype (the reference's op order); a
    fp32 tensor alpha, one per row, promotes each op to fp32 as JAX
    promotes it, and the result is stored in the leaf's dtype.
    With ``mix_impl(a, b, alpha)``: called on the leaf and its partner
    viewed as ``(rows, -1)``, its result written back unless it wrote in
    place."""
    if mix_impl is not None:
        a = x.view(x.shape[0], -1)
        out = mix_impl(a, recv.reshape(a.shape), alpha)
        if out is not a:
            a.copy_(out)
        return x
    if isinstance(alpha, torch.Tensor):
        w = alpha.reshape(alpha.shape + (1,) * (x.dim() - alpha.dim()))
        x.copy_(x * (1.0 - w) + recv * w)
        return x
    keep, take = leaf_coefs(alpha, x.dtype)
    x.copy_(x * keep + recv * take)
    return x


def make_gossip_mix(schedule: GossipSchedule, *, alpha: float = 0.5,
                    mode: str = "static",
                    mix_impl: Callable | None = None,
                    group: Optional[ReplicaGroup] = None) -> Callable:
    """``mix(params, phase) -> params``, the per-leaf engine: per leaf of
    the tree (each with the replica axis leading), one exchange with
    schedule row ``phase`` and the mix, in place. ``mode`` is ``static``
    (an int phase) or ``dynamic`` (an int or a 0-d tensor), as in the
    reference; another mode raises ``ValueError``. ``group``: the replica
    group when this process holds one replica (None: stacked)."""
    if mode not in _MODES:
        raise ValueError(f"unknown gossip mode {mode!r}")
    recv = _RecvTables(schedule, group)

    def mix(params, phase):
        ph = _phase(phase, mode) % schedule.period
        _check_dp(schedule, params, group)
        leaves, _ = tree_flatten(params)
        rf = recv(ph, leaves[0].device)
        for x in leaves:
            _mix_leaf(x, exchange(x, rf, group), alpha, mix_impl)
        return params

    return mix


def make_packed_gossip_mix(schedule: GossipSchedule, layout: BucketLayout,
                           *, alpha: float = 0.5,
                           wire: WireFormat = WireFormat(),
                           group: Optional[ReplicaGroup] = None,
                           mesh=None) -> Callable:
    """``mix(packed, phase) -> packed``: one exchange + one in-place mix per
    sent bucket. ``mesh`` (a ``mesh_spec.MeshSpec``) is checked against a
    shard-local layout's axes (``check_layout_mesh``)."""
    if mesh is not None:
        check_layout_mesh(layout, mesh)
    recv = _RecvTables(schedule, group)
    subset = wire_subset_of(wire, layout.num_buckets)
    eff = wire_period(schedule, subset)

    def mix(params: PackedParams, phase: int) -> PackedParams:
        _check_dp(schedule, params, group)
        ph = int(phase) % eff
        rf = recv(ph, params.buckets[0].device)
        sel = send_masks(subset, layout.num_buckets, ph)
        for i, b in enumerate(params.buckets):
            if sel[i]:  # unsent: no exchange, untouched bits
                gossip_mix_bucket(
                    b, exchange(encode_bucket(wire, b, ph, i, group), rf,
                                group), alpha)
        return params

    return mix


def packed_fused_local_update(layout: BucketLayout, optimizer, *,
                              alpha: float) -> Callable:
    """``body(params, grads, opt_state, partner_of=None, alpha_eff=None) ->
    (params, opt_state)``: one ``optimizer.fused_update`` per bucket.
    ``partner_of(i)`` returns bucket i's mix operand (a wire payload, or
    None for the pure local update), taken just before bucket i is updated;
    ``alpha_eff`` overrides the closure alpha (the async engine's
    per-replica masked alpha tensor)."""
    if optimizer.fused_update is None:
        raise ValueError("optimizer has no fused_update backend; use sgd, "
                         "adamw or lars, or the unfused mix-then-apply path")
    moment_keys = tuple(optimizer.fused_moments)

    def body(params, grads, opt_state, partner_of: Optional[Callable] = None,
             alpha_eff=None):
        step = opt_state["step"]
        a = alpha if alpha_eff is None else alpha_eff
        for i in range(layout.num_buckets):
            moms = tuple(opt_state[k].buckets[i] if opt_state[k] is not None
                         else None for k in moment_keys)
            partner = partner_of(i) if partner_of is not None else None
            optimizer.fused_update(i, params.buckets[i], grads.buckets[i],
                                   partner, moms, step=step,
                                   alpha=a if partner is not None else 0.0,
                                   layout=layout)
        return params, dict(opt_state, step=step + 1)

    return body


def make_packed_fused_update(schedule: Optional[GossipSchedule],
                             layout: BucketLayout, optimizer, *,
                             alpha: float = 0.5,
                             wire: WireFormat = WireFormat(),
                             group: Optional[ReplicaGroup] = None,
                             mesh=None) -> Callable:
    """``update(params, grads, opt_state, phase) -> (params, opt_state)``,
    the synchronous fused engine. With a schedule each sent bucket mixes
    with the partner's pre-update bucket, encoded for the wire;
    with ``schedule=None`` (dp == 1 or a protocol without gossip) the same
    kernel runs with alpha = 0. ``mesh`` as in
    ``make_packed_gossip_mix``."""
    if mesh is not None:
        check_layout_mesh(layout, mesh)
    local = packed_fused_local_update(
        layout, optimizer, alpha=alpha if schedule is not None else 0.0)
    if schedule is None:
        def update(params, grads, opt_state, phase=None):
            return local(params, grads, opt_state, None)
        return update

    recv = _RecvTables(schedule, group)
    subset = wire_subset_of(wire, layout.num_buckets)
    eff = wire_period(schedule, subset)

    def update(params, grads, opt_state, phase):
        _check_dp(schedule, params, group)
        ph = int(phase) % eff
        rf = recv(ph, params.buckets[0].device)
        sel = send_masks(subset, layout.num_buckets, ph)

        def partner_of(i):
            if not sel[i]:
                return None
            return exchange(encode_bucket(wire, params.buckets[i], ph, i,
                                          group), rf, group)

        return local(params, grads, opt_state, partner_of)

    return update


def gossip_bytes_per_step(replica_bytes: int, dp: int,
                          model_shards: int = 1) -> dict:
    """Analytic per-step communication volume (the paper's Table 1).

    ``replica_bytes`` is the byte size of ONE model replica; each replica is
    sharded ``model_shards``-way, so a chip's local shard is
    ``replica_bytes / model_shards``. Gossip sends exactly that local shard
    to one partner, independent of dp (the paper's O(1)). A ring all-reduce
    moves ``2·shard·(dp-1)/dp`` per chip in ``~log2(dp)`` latency steps."""
    shard = replica_bytes / max(model_shards, 1)
    return {
        "replica_bytes": replica_bytes,
        "gossip_bytes_per_chip": shard if dp > 1 else 0.0,
        "allreduce_bytes_per_chip": (2.0 * shard * (dp - 1) / dp
                                     if dp > 1 else 0.0),
        "allreduce_latency_steps": int(np.ceil(np.log2(max(dp, 2)))),
        "gossip_latency_steps": 1,
    }


def wire_bytes_per_step(layout: BucketLayout,
                        wire: WireFormat | None = None) -> dict:
    """Per-chip wire bytes of ONE packed gossip exchange under a wire
    format, reckoned on the host from the layout's per-shard strides and
    dtype strings. ``code_bytes`` counts the exchanged codes; the fp32
    per-tile scales are apart (``scale_bytes``), so int8 is exactly 4x
    fewer code bytes than the fp32 wire and int8 at subset 0.5 8x.
    ``subset_fraction`` averages the rotating bucket subset over one
    rotation period."""
    wire = wire or WireFormat()
    subset = wire_subset_of(wire, layout.num_buckets)
    raw, code, scale = 0.0, 0.0, 0.0
    frac = 1.0 if subset is None else subset.fraction
    for n, dt in zip((int(s) for s in layout.strides), layout.bucket_dtypes):
        raw += n * wire_itemsize("fp32", dt)
        code += n * wire_itemsize(wire.dtype, dt) * frac
        if wire.dtype in ("int8", "fp8"):
            scale += (n // LANE) * 4 * frac
    return {
        "raw_bytes": raw,
        "code_bytes": code,
        "scale_bytes": scale,
        "total_bytes": code + scale,
        "reduction_codes": raw / code if code else float("inf"),
        "reduction_total": (raw / (code + scale) if code + scale
                            else float("inf")),
        "subset_fraction": frac,
        "wire_dtype": wire.dtype,
    }


def sent_bytes_at(layout: BucketLayout, wire: WireFormat | None,
                  phase: int) -> dict:
    """Per-chip bytes of the exchange at ``phase``: the codes and scales of
    the buckets the rotating subset sends then (every bucket without a
    subset), as ints. Summed over a subset period this is what the packed
    engines send; ``wire_bytes_per_step``'s ``subset_fraction`` average
    equals that sum only when every bucket goes out equally often (a window
    that wraps the bucket list sends its first buckets twice a period)."""
    wire = wire or WireFormat()
    sel = send_masks(wire_subset_of(wire, layout.num_buckets),
                     layout.num_buckets, phase)
    code = scale = 0
    for i, (n, dt) in enumerate(zip(layout.strides, layout.bucket_dtypes)):
        if sel[i]:
            code += int(n) * wire_itemsize(wire.dtype, dt)
            if wire.dtype in ("int8", "fp8"):
                scale += (int(n) // LANE) * 4
    return {"code_bytes": code, "scale_bytes": scale,
            "total_bytes": code + scale}
