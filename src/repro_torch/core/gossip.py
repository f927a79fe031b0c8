"""Gossip mixing over replicas stacked on one device (GossipGraD §4-5).

Port of ``repro/core/gossip.py`` (``make_packed_gossip_mix``,
``packed_fused_local_update``, ``make_packed_fused_update``). The reference
keeps one replica per device and exchanges with ``jax.lax.ppermute`` inside
``shard_map``. In this slice the dp replicas live stacked on one device as
the leading axis of every bucket, and the exchange is the single-device
``ppermute`` that ``repro/core/simulate.py`` defines as equivalent: replica
j receives ``x[recv_from[j]]`` (``exchange``). Multi-process
``torch.distributed`` send/recv comes later behind the same function.

* ``make_packed_gossip_mix`` (unfused engine): per bucket, one exchange and
  one in-place mix kernel (``kernels.ops.gossip_mix_bucket``).
* ``make_packed_fused_update`` (fused engine): per bucket, the exchange of
  the partner's PRE-update params and then one single-sweep fused mix+SGD
  kernel (the GoSGD-style combined update of the reference). With every
  replica in one tensor the updates run in place, so a bucket's exchange is
  taken right before that bucket's update, never after it.

Both run in place on the buckets and return them. Compressed wires and the
async ring wait for later slices (ROADMAP A.9, A.10).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import gossip_mix_bucket

from .buckets import BucketLayout, PackedParams
from .topology import GossipSchedule

__all__ = ["exchange", "make_packed_gossip_mix", "packed_fused_local_update",
           "make_packed_fused_update"]


def exchange(bucket: torch.Tensor, recv_from: torch.Tensor) -> torch.Tensor:
    """The step's ppermute on stacked replicas: a new tensor whose row j is
    ``bucket[recv_from[j]]``."""
    return bucket.index_select(0, recv_from)


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


def make_packed_gossip_mix(schedule: GossipSchedule, *,
                           alpha: float = 0.5) -> Callable:
    """``mix(packed, phase) -> packed``: one exchange + one in-place mix per
    bucket."""
    recv = _RecvTables(schedule)

    def mix(params: PackedParams, phase: int) -> PackedParams:
        _check_dp(schedule, params)
        rf = recv(phase, params.buckets[0].device)
        for b in params.buckets:
            gossip_mix_bucket(b, exchange(b, rf), alpha)
        return params

    return mix


def packed_fused_local_update(layout: BucketLayout, optimizer, *,
                              alpha: float) -> Callable:
    """``body(params, grads, opt_state, partner_of=None) -> (params,
    opt_state)``: one ``optimizer.fused_update`` per bucket. ``partner_of(i)``
    returns bucket i's mix operand, taken just before bucket i is updated;
    None is the pure local update (alpha treated as 0)."""
    if optimizer.fused_update is None:
        raise ValueError("optimizer has no fused_update backend; use sgd or "
                         "the unfused mix-then-apply path")
    moment_keys = tuple(optimizer.fused_moments)

    def body(params, grads, opt_state, partner_of: Optional[Callable] = None):
        step = opt_state["step"]
        a = alpha if partner_of is not None else 0.0
        for i in range(layout.num_buckets):
            moms = tuple(opt_state[k].buckets[i] if opt_state[k] is not None
                         else None for k in moment_keys)
            partner = partner_of(i) if partner_of is not None else None
            optimizer.fused_update(i, params.buckets[i], grads.buckets[i],
                                   partner, moms, step=step, alpha=a,
                                   layout=layout)
        return params, dict(opt_state, step=step + 1)

    return body


def make_packed_fused_update(schedule: Optional[GossipSchedule],
                             layout: BucketLayout, optimizer, *,
                             alpha: float = 0.5) -> Callable:
    """``update(params, grads, opt_state, phase) -> (params, opt_state)``,
    the synchronous fused engine. With a schedule each bucket mixes with the
    partner's pre-update bucket; with ``schedule=None`` (dp == 1 or a
    protocol without gossip) the same kernel runs with alpha = 0."""
    local = packed_fused_local_update(
        layout, optimizer, alpha=alpha if schedule is not None else 0.0)
    if schedule is None:
        def update(params, grads, opt_state, phase=None):
            return local(params, grads, opt_state, None)
        return update

    recv = _RecvTables(schedule)

    def update(params, grads, opt_state, phase):
        _check_dp(schedule, params)
        rf = recv(phase, params.buckets[0].device)
        return local(params, grads, opt_state,
                     lambda i: exchange(params.buckets[i], rf))

    return update
