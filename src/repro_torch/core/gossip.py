"""Gossip mixing over replicas stacked on one device (GossipGraD §4-5).

Port of ``repro/core/gossip.py`` (``wire_subset_of``, ``wire_period``,
``_encode_bucket``, ``make_packed_gossip_mix``,
``packed_fused_local_update``, ``make_packed_fused_update``). The reference
keeps one replica per device and exchanges with ``jax.lax.ppermute`` inside
``shard_map``. Here the dp replicas live stacked on one device as the
leading axis of every bucket, and the exchange is the single-device
``ppermute`` that ``repro/core/simulate.py`` defines as equivalent: replica
j receives ``x[recv_from[j]]`` (``exchange``). Multi-process
``torch.distributed`` send/recv comes later behind the same function.

* ``make_packed_gossip_mix`` (unfused engine): per sent bucket, one
  exchange and one in-place mix kernel (``kernels.ops.gossip_mix_bucket``).
* ``make_packed_fused_update`` (fused engine): per bucket, the exchange of
  the partner's PRE-update params and then one single-sweep fused
  mix+update kernel of the optimizer (sgd, adamw or lars), the GoSGD-style
  combined update of the reference. With every replica in one tensor the
  updates run in place, so a bucket's exchange is taken right before that
  bucket's update, never after it.

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
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import gossip_mix_bucket
from repro_torch.kernels.quantize import WireFormat, encode_wire, wire_key

from .buckets import BucketLayout, PackedParams
from .topology import (BucketSubsetSchedule, GossipSchedule,
                       build_subset_schedule)

__all__ = ["exchange", "wire_subset_of", "wire_period", "encode_bucket",
           "make_packed_gossip_mix", "packed_fused_local_update",
           "make_packed_fused_update"]


def exchange(x, recv_from: torch.Tensor):
    """The step's ppermute on stacked replicas: new tensors whose row j is
    row ``recv_from[j]`` of ``x`` (a bucket, or a wire payload's codes and
    scales alike)."""
    if isinstance(x, dict):
        return {k: v.index_select(0, recv_from) for k, v in x.items()}
    return x.index_select(0, recv_from)


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
                  bucket_index: int):
    """Dispatch-side encode of every replica row of one ``(dp, n)`` bucket,
    row r keyed on (``t``, rank r, bucket, seed)."""
    keys = (wire_key(t, np.arange(bucket.shape[0]), bucket_index, wire.seed)
            if wire.dtype == "int8" else None)
    return encode_wire(bucket, wire.dtype, keys=keys)


def send_masks(subset: BucketSubsetSchedule | None, num_buckets: int,
               phase: int) -> np.ndarray:
    """Buckets sent at ``phase`` (all of them without a subset)."""
    if subset is None:
        return np.ones(num_buckets, bool)
    return subset.selected(phase)


class _RecvTables:
    """``recv_from`` of every schedule phase as index tensors, one copy per
    device, made on first use."""

    def __init__(self, schedule: GossipSchedule):
        self._rows = [schedule.recv_from(t) for t in range(schedule.period)]
        self._on: dict = {}

    def __call__(self, phase: int, device: torch.device) -> torch.Tensor:
        key = (int(phase) % len(self._rows), str(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(
                np.asarray(self._rows[key[0]], np.int64), device=device)
        return self._on[key]


def _check_dp(schedule: GossipSchedule, params: PackedParams) -> None:
    dp = params.buckets[0].shape[0]
    if schedule.p != dp:
        raise ValueError(f"schedule built for p={schedule.p} but buckets hold "
                         f"dp={dp} replicas")


def make_packed_gossip_mix(schedule: GossipSchedule, layout: BucketLayout,
                           *, alpha: float = 0.5,
                           wire: WireFormat = WireFormat()) -> Callable:
    """``mix(packed, phase) -> packed``: one exchange + one in-place mix per
    sent bucket."""
    recv = _RecvTables(schedule)
    subset = wire_subset_of(wire, layout.num_buckets)
    eff = wire_period(schedule, subset)

    def mix(params: PackedParams, phase: int) -> PackedParams:
        _check_dp(schedule, params)
        ph = int(phase) % eff
        rf = recv(ph, params.buckets[0].device)
        sel = send_masks(subset, layout.num_buckets, ph)
        for i, b in enumerate(params.buckets):
            if sel[i]:  # unsent: no exchange, untouched bits
                gossip_mix_bucket(
                    b, exchange(encode_bucket(wire, b, ph, i), rf), alpha)
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
                             wire: WireFormat = WireFormat()) -> Callable:
    """``update(params, grads, opt_state, phase) -> (params, opt_state)``,
    the synchronous fused engine. With a schedule each sent bucket mixes
    with the partner's pre-update bucket, encoded for the wire;
    with ``schedule=None`` (dp == 1 or a protocol without gossip) the same
    kernel runs with alpha = 0."""
    local = packed_fused_local_update(
        layout, optimizer, alpha=alpha if schedule is not None else 0.0)
    if schedule is None:
        def update(params, grads, opt_state, phase=None):
            return local(params, grads, opt_state, None)
        return update

    recv = _RecvTables(schedule)
    subset = wire_subset_of(wire, layout.num_buckets)
    eff = wire_period(schedule, subset)

    def update(params, grads, opt_state, phase):
        _check_dp(schedule, params)
        ph = int(phase) % eff
        rf = recv(ph, params.buckets[0].device)
        sel = send_masks(subset, layout.num_buckets, ph)

        def partner_of(i):
            if not sel[i]:
                return None
            return exchange(encode_bucket(wire, params.buckets[i], ph, i), rf)

        return local(params, grads, opt_state, partner_of)

    return update
