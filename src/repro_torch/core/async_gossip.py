"""Bounded-delay asynchronous gossip: the staleness-k inbox ring
(GossipGraD §4.2/§5).

Port of ``repro/core/async_gossip.py`` (``exchange_ok``,
``init_inbox_ring``, ``init_wire_inbox_ring``, ``_ring_advance``,
``make_async_gossip_mix``, ``make_packed_async_gossip_mix``,
``make_packed_fused_async_update``) on replicas stacked on one device, or
one per process of a ``core.replica_group.ReplicaGroup``, passed as
``group`` when an engine is built (the exchange and the drop flags then
run per rank, and ``valid`` has one row). The ring
entering step t (k = staleness):

    slots[0..k-1]   payloads dispatched at steps t-k .. t-1, oldest first:
                    per-leaf, a param tree of exchanged leaves; packed,
                    under the fp32 full-participation wire a
                    ``PackedParams`` of exchanged buckets (the reference's
                    slot, which checkpoints through the leaf view); under
                    another wire a list over buckets of (dp, n) tensors or
                    wire payload dicts, a bucket the subset did not send
                    holding the reference's zero payload as zero-stride
                    views (never consumed)
    valid (dp, k)   landed flags, numpy float32 on the host
    t               dispatch counter, a host int

One step: the masked alpha ``a_eff = alpha * valid[:, 0]`` is one value per
replica row, uploaded as a (dp,) tensor that the kernels read on the
device. The reference hands ``mix_impl`` one scalar, ``a.reshape(-1)[0]``,
because each of its devices holds one replica; on stacked replicas every
row keeps its own value, so a drop on any replica skips that replica
alone. The oldest slot is mixed in
(skip-on-timeout: a dropped exchange mixes at alpha 0); the step's payload
is exchanged with schedule row ``phase`` and appended with its landed flags
``exchange_ok(t, j)`` for each receiving row j. ``valid`` and ``t`` are
integer logic, computed on the host exactly as the reference computes them,
so a step never reads the device back.

Both engines run one path for every ``WireFormat``: ring slots hold wire
payloads, encoded with noise keyed on the ring counter ``t`` (the sync
engines key on the folded phase); buckets are consumed under
``selected(phase - k)`` and sent under ``selected(phase)`` (every bucket
under full participation). The unfused engine encodes the MIXED bucket; the
fused engine encodes the RAW pre-update bucket, just before that bucket's
in-place sweep, as the sync fused engine's exchange does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import gossip_mix_bucket
from repro_torch.kernels.quantize import (WireFormat, _mix32_np, _u32,
                                          unsent_payload_like,
                                          zero_payload_like)
from repro_torch.tree import tree_flatten, tree_map

from .buckets import BucketLayout, PackedParams, check_layout_mesh
from .replica_group import ReplicaGroup
from .gossip import (_MODES, _check_dp, _mix_leaf, _phase, _RecvTables,
                     encode_bucket, exchange, packed_fused_local_update,
                     replica_ranks, send_masks, wire_period, wire_subset_of)
from .topology import GossipSchedule

__all__ = ["exchange_ok", "init_inbox_ring", "init_wire_inbox_ring",
           "ring_advance", "masked_alpha", "make_async_gossip_mix",
           "make_packed_async_gossip_mix", "make_packed_fused_async_update"]


def exchange_ok(t, rank, seed: int = 0, rate: float = 0.0) -> np.ndarray:
    """Emulated-wire drop injection: 1.0 where the exchange dispatched at
    step ``t`` lands at receiver ``rank`` in time, 0.0 where it is dropped.
    The reference's splitmix32 hash in numpy uint32, bit for bit."""
    if rate <= 0.0:
        return np.ones(np.shape(rank), np.float32)
    t, rank = np.broadcast_arrays(np.asarray(t), np.asarray(rank))
    x = (_u32(t) * np.uint32(0x9E3779B9)
         ^ _u32(rank) * np.uint32(0x85EBCA6B)
         ^ np.uint32(seed & 0xFFFFFFFF))
    thresh = np.uint32(min(int(rate * (1 << 32)), (1 << 32) - 1))
    return (_mix32_np(x) >= thresh).astype(np.float32).reshape(rank.shape)


def _ring(slots: List[List], dp: int) -> Dict:
    if len(slots) < 1:
        raise ValueError(f"inbox ring needs staleness >= 1, got {len(slots)}")
    return {"slots": tuple(slots),
            "valid": np.zeros((max(dp, 1), len(slots)), np.float32), "t": 0}


def init_inbox_ring(params, staleness: int, dp: int) -> Dict:
    """Fresh-run ring: k slots of copies of ``params`` (copies: the engines
    update the live tensors in place), ``PackedParams`` of bucket copies
    for packed params and trees of leaf copies for a param tree; all
    invalid, counter 0. ``dp`` is the replica rows this process holds."""
    if isinstance(params, PackedParams):
        def copy():
            return PackedParams([b.detach().clone() for b in params.buckets],
                                params.layout)
    else:
        def copy():
            return tree_map(lambda x: x.detach().clone(), params)
    return _ring([copy() for _ in range(int(staleness))], dp)


def init_wire_inbox_ring(params: PackedParams, staleness: int, dp: int,
                         wire: WireFormat) -> Dict:
    """Fresh-run ring of a compressed wire: every slot holds all-zero wire
    payloads (consumed only at alpha = 0). Payloads are read-only, so the k
    bootstrap slots share one set of zeros."""
    zeros = [zero_payload_like(b.detach(), wire.dtype) for b in params.buckets]
    return _ring([list(zeros) for _ in range(int(staleness))], dp)


def ring_advance(ring: Dict, payload: List, ok: np.ndarray) -> Dict:
    """FIFO advance: drop the consumed slot, append the fresh dispatch with
    its landed flags, count the dispatch."""
    return {"slots": tuple(ring["slots"][1:]) + (payload,),
            "valid": np.concatenate([ring["valid"][:, 1:],
                                     np.asarray(ok, np.float32)[:, None]],
                                    axis=1),
            "t": ring["t"] + 1}


def masked_alpha(alpha: float, valid: np.ndarray,
                 device: torch.device) -> torch.Tensor:
    """``alpha * valid[:, 0]`` in fp32, one per replica row, on ``device``
    (one small asynchronous host-to-device copy; nothing is read back)."""
    a = np.float32(alpha) * np.asarray(valid[:, 0], np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


class _Ring:
    """What both async engines share: the wire's subset and period, the
    receive tables and the drop injection."""

    def __init__(self, schedule, layout, *, staleness, drop_rate, drop_seed,
                 wire, group):
        if staleness < 1:
            raise ValueError(f"gossip_async needs staleness >= 1, "
                             f"got {staleness}")
        self.schedule, self.layout, self.k = schedule, layout, int(staleness)
        self.drop_rate, self.drop_seed = drop_rate, drop_seed
        self.wire = wire
        self.subset = wire_subset_of(self.wire, layout.num_buckets)
        self.period = wire_period(schedule, self.subset)
        self.group = group
        self.recv = _RecvTables(schedule, group)

    def masks(self, phase: int):
        """(consumed, sent) bucket masks at ``phase``: the slot consumed now
        was dispatched k steps ago."""
        nb = self.layout.num_buckets
        return (send_masks(self.subset, nb, phase - self.k),
                send_masks(self.subset, nb, phase))

    def dispatch(self, bucket, i, sent, t, rf):
        """Bucket i's exchanged wire payload; a zero payload when the subset
        does not send it."""
        if not sent[i]:
            return unsent_payload_like(bucket, self.wire.dtype)
        return exchange(encode_bucket(self.wire, bucket, t, i, self.group),
                        rf, self.group)

    def ok(self, t, rows) -> np.ndarray:
        return exchange_ok(t, replica_ranks(rows, self.group),
                           self.drop_seed, self.drop_rate)

    def slot(self, payload: List):
        """The ring slot of one dispatch: a ``PackedParams`` under the fp32
        full-participation wire, as ``init_inbox_ring`` makes them."""
        if self.wire.is_default:
            return PackedParams(payload, self.layout)
        return payload


def make_async_gossip_mix(schedule: GossipSchedule, *, alpha: float = 0.5,
                          staleness: int = 1, drop_rate: float = 0.0,
                          drop_seed: int = 0, mode: str = "static",
                          mix_impl: Callable | None = None,
                          group: Optional[ReplicaGroup] = None) -> Callable:
    """``mix(params, ring, phase) -> (params, ring)``, the per-leaf engine,
    in place on the leaves: mix every leaf with the oldest slot's leaf at
    the masked alpha (one value per replica row; ``mix_impl(a, b, alpha)``
    gets that (rows,) tensor, the leaf viewed as ``(rows, -1)``), then
    exchange the mixed leaves with schedule row ``phase`` and append them
    with their landed flags. ``mode`` and ``group`` as in
    ``make_gossip_mix``."""
    if staleness < 1:
        raise ValueError(f"gossip_async needs staleness >= 1, got {staleness}")
    if mode not in _MODES:
        raise ValueError(f"unknown gossip mode {mode!r}")
    k = int(staleness)
    recv = _RecvTables(schedule, group)

    def mix(params, ring: Dict, phase):
        if len(ring["slots"]) != k:
            raise ValueError(f"ring carries {len(ring['slots'])} slots but "
                             f"the engine was built for staleness {k}")
        ph = _phase(phase, mode) % schedule.period
        _check_dp(schedule, params, group)
        leaves, td = tree_flatten(params)
        dev, rows = leaves[0].device, leaves[0].shape[0]
        rf = recv(ph, dev)
        a = masked_alpha(alpha, ring["valid"], dev)
        payload = []
        for x, b in zip(leaves, td.flatten_up_to(ring["slots"][0])):
            _mix_leaf(x, b, a, mix_impl)
            payload.append(exchange(x, rf, group))
        ok = exchange_ok(ring["t"], replica_ranks(rows, group), drop_seed,
                         drop_rate)
        return params, ring_advance(ring, td.unflatten(payload), ok)

    return mix


def make_packed_async_gossip_mix(schedule: GossipSchedule,
                                 layout: BucketLayout, *, alpha: float = 0.5,
                                 staleness: int = 1, drop_rate: float = 0.0,
                                 drop_seed: int = 0,
                                 wire: WireFormat = WireFormat(),
                                 group: Optional[ReplicaGroup] = None,
                                 mesh=None) -> Callable:
    """``mix(params, ring, phase) -> (params, ring)``, in place on the
    buckets: mix the oldest slot in (masked alpha, consumed buckets only),
    then dispatch the mixed buckets, encoded for the wire, with schedule row
    ``phase``. ``mesh`` (a ``mesh_spec.MeshSpec``) is checked against a
    shard-local layout's axes (``check_layout_mesh``)."""
    if mesh is not None:
        check_layout_mesh(layout, mesh)
    st = _Ring(schedule, layout, staleness=staleness, drop_rate=drop_rate,
               drop_seed=drop_seed, wire=wire, group=group)

    def mix(params: PackedParams, ring: Dict, phase: int):
        _check_dp(schedule, params, group)
        dev = params.buckets[0].device
        ph = int(phase) % st.period
        rf = st.recv(ph, dev)
        a = masked_alpha(alpha, ring["valid"], dev)
        cons, sent = st.masks(ph)
        payload = []
        for i, x in enumerate(params.buckets):
            if cons[i]:
                gossip_mix_bucket(x, ring["slots"][0][i], a)
            payload.append(st.dispatch(x, i, sent, ring["t"], rf))
        dp = params.buckets[0].shape[0]
        return params, ring_advance(ring, st.slot(payload),
                                    st.ok(ring["t"], dp))

    return mix


def make_packed_fused_async_update(schedule: GossipSchedule,
                                   layout: BucketLayout, optimizer, *,
                                   alpha: float = 0.5, staleness: int = 1,
                                   drop_rate: float = 0.0, drop_seed: int = 0,
                                   wire: WireFormat = WireFormat(),
                                   group: Optional[ReplicaGroup] = None,
                                   mesh=None) -> Callable:
    """``update(params, grads, ring, opt_state, phase) -> (params,
    opt_state, ring)``: per bucket, dispatch the RAW pre-update bucket
    encoded for the wire, then one fused mix+update sweep (the optimizer's
    ``fused_update``) against the oldest slot's payload at the masked alpha
    (the pure local update for a bucket outside the consumed subset).
    ``mesh`` as in ``make_packed_async_gossip_mix``."""
    if mesh is not None:
        check_layout_mesh(layout, mesh)
    st = _Ring(schedule, layout, staleness=staleness, drop_rate=drop_rate,
               drop_seed=drop_seed, wire=wire, group=group)
    local = packed_fused_local_update(layout, optimizer, alpha=alpha)

    def update(params, grads, ring, opt_state, phase):
        _check_dp(schedule, params, group)
        dev = params.buckets[0].device
        ph = int(phase) % st.period
        rf = st.recv(ph, dev)
        a = masked_alpha(alpha, ring["valid"], dev)
        cons, sent = st.masks(ph)
        outbox = []

        def partner_of(i):
            # called right before bucket i's in-place sweep: the outbox
            # takes the bucket before the update overwrites it
            outbox.append(st.dispatch(params.buckets[i], i, sent, ring["t"],
                                      rf))
            return ring["slots"][0][i] if cons[i] else None

        params, opt = local(params, grads, opt_state, partner_of, alpha_eff=a)
        dp = params.buckets[0].shape[0]
        return params, opt, ring_advance(ring, st.slot(outbox),
                                         st.ok(ring["t"], dp))

    return update
