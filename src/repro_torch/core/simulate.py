"""Single-process p-replica simulator for the GossipGraD protocols: the
port's oracle, on the CPU and on the card.

Port of ``repro/core/simulate.py`` (``replicate``, ``gossip_mix_sim``,
``gossip_mix_sim_delayed``, ``gossip_mix_sim_delayed_k``,
``gossip_mix_sim_quantized``, ``gossip_mix_sim_quantized_k``,
``allreduce_mean_sim``, ``replica_variance``, ``gossip_mix_sim_masked``,
``make_sim_train_step``, ``make_async_sim_train_step``). Every leaf carries
the leading replica axis, and the communication primitives are gathers
over it:

    ppermute(x, recv_from)  ==  x[recv_from]
    mean over the replicas  ==  core.gossip.replica_mean

These functions are written apart from the engines (out of place, whole
trees or bucket lists at a time, no kernels), so the engines are held
against code that is not their own. The quantized oracles encode and decode
through ``kernels.quantize``, the wire the engines use. A ring here is the
port's: ``valid`` a numpy float32 array and ``t`` a host int.

The train steps differ from the reference in two ways that change no
result. The gradient is one backward of the summed per-replica losses over
the stacked replicas, where the reference vmaps ``value_and_grad``:
``loss_fn(params, batch)`` takes the stacked tree and batch and returns one
loss per replica (or ``(losses, aux)``). The steps update in place, as the
port's optimizers do. One difference is by design: ``drop_prob > 0`` draws
the dropped exchanges of ``make_sim_train_step`` from a ``torch.Generator``
seeded with ``seed + 7919`` and the step (the reference folds the step into
a ``jax.random`` key, which torch cannot replay), so only the masks differ.
``make_async_sim_train_step`` drops through ``exchange_ok``, bit for bit.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip_mix import mix_weights
from repro_torch.kernels.quantize import (LANE, WireFormat, decode_wire,
                                          encode_wire, wire_key)
from repro_torch.tree import tree_flatten, tree_map

from .async_gossip import exchange_ok
from .gossip import leaf_coefs, replica_mean
from .topology import GossipSchedule, build_subset_schedule

__all__ = ["replicate", "gossip_mix_sim", "gossip_mix_sim_delayed",
           "gossip_mix_sim_delayed_k", "gossip_mix_sim_quantized",
           "gossip_mix_sim_quantized_k", "allreduce_mean_sim",
           "replica_variance", "gossip_mix_sim_masked",
           "make_sim_train_step", "make_async_sim_train_step"]

SIM_PROTOCOLS = ("gossip", "gossip_grad", "agd", "every_logp", "none")


def _index(recv_from, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(recv_from.cpu() if isinstance(
        recv_from, torch.Tensor) else recv_from, np.int64), device=like.device)


def _gather(x: torch.Tensor, recv_from) -> torch.Tensor:
    return x.index_select(0, _index(recv_from, x))


def _rowwise(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (p,) weight shaped to broadcast over ``x``'s rows."""
    return w.reshape(w.shape + (1,) * (x.dim() - 1))


def _first(tree) -> torch.Tensor:
    return tree_flatten(tree)[0][0]


def replicate(params, p: int):
    """Every leaf tiled with a leading replica axis of size p (copies)."""
    return tree_map(lambda x: x.unsqueeze(0).expand((p,) + tuple(x.shape))
                    .clone(), params)


def gossip_mix_sim(params, recv_from):
    """w_j <- (w_j + w_{recv_from[j]}) / 2 over the leading replica axis."""
    return tree_map(lambda x: (x + _gather(x, recv_from)) * 0.5, params)


def gossip_mix_sim_delayed(params, inbox, recv_from, alpha: float = 0.5):
    """Delayed-mix oracle of the staleness-1 async protocol: ``mixed_j =
    (1-alpha) * params_j + alpha * inbox_j``; the new inbox is
    ``mixed[recv_from]``."""
    def mix(x, b):
        keep, take = leaf_coefs(alpha, x.dtype)
        return x * keep + b * take
    mixed = tree_map(mix, params, inbox)
    return mixed, tree_map(lambda m: _gather(m, recv_from), mixed)


def _ring_next(ring: Dict, payload, ok, p: int) -> Dict:
    if ok is None:
        ok = np.ones((p,), np.float32)
    ok = np.asarray(ok.cpu() if isinstance(ok, torch.Tensor) else ok,
                    np.float32)
    return {"slots": tuple(ring["slots"][1:]) + (payload,),
            "valid": np.concatenate([np.asarray(ring["valid"])[:, 1:],
                                     ok[:, None]], axis=1),
            "t": int(ring["t"]) + 1}


def _masked_alpha(alpha: float, valid, like: torch.Tensor) -> torch.Tensor:
    a = np.float32(alpha) * np.asarray(valid, np.float32)[:, 0]
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def gossip_mix_sim_delayed_k(params, ring: Dict, recv_from,
                             alpha: float = 0.5, ok=None):
    """Bounded-delay oracle of the staleness-k inbox ring (the per-leaf
    and packed-default async engines): ``a_j = alpha * valid[j, 0]``,
    ``mixed_j = (1 - a_j) * params_j + a_j * slots[0]_j``, the payload
    ``mixed[recv_from]`` appended with landed flags ``ok`` (all ones by
    default). Returns ``(mixed, new_ring)``."""
    a = _masked_alpha(alpha, ring["valid"], _first(params))

    def mix(x, b):
        w = _rowwise(a, x)
        return x * (1.0 - w) + b * w

    mixed = tree_map(mix, params, ring["slots"][0])
    payload = tree_map(lambda m: _gather(m, recv_from), mixed)
    return mixed, _ring_next(ring, payload, ok, a.shape[0])


def _sent(subset, t: int, n: int) -> np.ndarray:
    return np.ones(n, bool) if subset is None else subset.selected(t)


def gossip_mix_sim_quantized(buckets, recv_from, t: int, *, wire: WireFormat,
                             alpha: float = 0.5):
    """Quantized-wire oracle of the synchronous packed engines: per
    ``(p, n)`` bucket sent at ``t``, every row encoded keyed on (``t``, its
    rank, the bucket, the seed), the payloads gathered by ``recv_from`` and
    decoded, then ``(1-alpha) * x + alpha * decoded`` in fp32, rounded to
    the bucket's dtype; buckets outside the subset pass through."""
    subset = build_subset_schedule(len(buckets), wire.subset)
    p = int(buckets[0].shape[0])
    sel = _sent(subset, int(t), len(buckets))
    keep, take = mix_weights(alpha)
    out = []
    for i, x in enumerate(buckets):
        if not sel[i]:
            out.append(x)
            continue
        enc = encode_wire(x, wire.dtype,
                          keys=wire_key(int(t), np.arange(p), i, wire.seed))
        b = decode_wire(tree_map(lambda e: _gather(e, recv_from), enc))
        out.append((x.float() * keep + b.float() * take).to(x.dtype))
    return out


def gossip_mix_sim_quantized_k(buckets, ring: Dict, recv_from, *,
                               wire: WireFormat, alpha: float = 0.5,
                               ok=None):
    """Quantized-wire oracle of the staleness-k async ring over ``(p, n)``
    buckets: the buckets of the consumed subset ``selected(t - k)`` mix
    with the decoded oldest slot at ``alpha * valid[:, 0]`` in fp32; every
    mixed bucket of the sent subset ``selected(t)`` is encoded keyed on the
    ring counter ``t`` and gathered by ``recv_from``, the others append an
    all-zero payload. Returns ``(mixed_buckets, new_ring)``."""
    subset = build_subset_schedule(len(buckets), wire.subset)
    slots, t = ring["slots"], int(ring["t"])
    k, nb, p = len(slots), len(buckets), int(buckets[0].shape[0])
    a = _masked_alpha(alpha, ring["valid"], buckets[0])
    cons, sent = _sent(subset, t - k, nb), _sent(subset, t, nb)
    mixed = []
    for i, x in enumerate(buckets):
        if not cons[i]:
            mixed.append(x)
            continue
        w = _rowwise(a, x)
        b = decode_wire(slots[0][i])
        mixed.append((x.float() * (1.0 - w) + b.float() * w).to(x.dtype))
    payload = []
    for i, m in enumerate(mixed):
        enc = encode_wire(m, wire.dtype,
                          keys=wire_key(t, np.arange(p), i, wire.seed))
        g = tree_map(lambda e: _gather(e, recv_from), enc)
        if not sent[i]:
            g = tree_map(torch.zeros_like, g)
        payload.append(g)
    return mixed, _ring_next(ring, payload, ok, p)


def allreduce_mean_sim(params):
    """All replicas replaced by the replica mean (one all-reduce):
    ``core.gossip.replica_mean`` of every leaf, the arithmetic the engines'
    ``agd`` and ``every_logp`` use."""
    return tree_map(lambda x: replica_mean(x).contiguous(), params)


def replica_variance(params) -> torch.Tensor:
    """Mean squared deviation of the replicas from their mean, over every
    element: the model drift the paper's diffusion argument keeps
    bounded."""
    tot, n = 0.0, 0
    for x in tree_flatten(params)[0]:
        tot = tot + ((x - replica_mean(x)) ** 2).sum()
        n += x.numel()
    return tot / n


def gossip_mix_sim_masked(params, recv_from, ok):
    """Gossip mix where replica j mixes only if ``ok[j]`` (a failed exchange
    leaves the local model unchanged, §4.2): weight ``0.5 * ok_j`` in fp32,
    promoted with the leaf as JAX promotes it."""
    m = torch.as_tensor(np.asarray(ok.cpu() if isinstance(ok, torch.Tensor)
                                   else ok), dtype=torch.float32)

    def mix(x):
        w = _rowwise(m.to(x.device) * 0.5, x)
        return x * (1.0 - w) + _gather(x, recv_from) * w

    return tree_map(mix, params)


def _losses(loss_fn, params, batch) -> Tuple[torch.Tensor, list]:
    """Per-replica losses and their gradients from one backward of their
    sum over the stacked replicas."""
    leaves, td = tree_flatten(params)
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in leaves]
        out = loss_fn(td.unflatten(xs), batch)
        losses = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(losses.sum(), xs)
    return losses.detach(), td.unflatten(list(grads))


def _recv_table(schedule: GossipSchedule):
    return [schedule.recv_from(t) for t in range(schedule.period)]


def drop_mask(seed: int, step: int, p: int, drop_prob: float) -> np.ndarray:
    """``make_sim_train_step``'s landed flags at ``step``: p uniforms from a
    CPU ``torch.Generator`` seeded with ``seed + 7919`` and the step,
    compared with ``drop_prob`` (1.0 where the exchange happens)."""
    if drop_prob <= 0.0:
        return np.ones((p,), np.float32)
    g = torch.Generator().manual_seed(((seed + 7919) << 32)
                                      | (int(step) & 0xFFFFFFFF))
    return (torch.rand((p,), generator=g) >= drop_prob).numpy().astype(
        np.float32)


def make_sim_train_step(loss_fn: Callable, optimizer,
                        schedule: GossipSchedule, protocol: str = "gossip",
                        drop_prob: float = 0.0, seed: int = 0) -> Callable:
    """``step(opt_state, params, batch, step_idx) -> (opt_state, params,
    metrics)`` over p stacked replicas, for the protocols of the paper's
    Table 6 and its ablations:

      gossip      local update, then the pairwise mix with the step's
                  partner (the paper's algorithm);
      gossip_grad the partner's gradients mixed in before the update (the
                  variant the paper argues against);
      agd         gradients averaged over the replicas every step;
      every_logp  params averaged after every ``schedule.substeps``-th step;
      none        no communication.

    ``drop_prob > 0`` drops single exchanges of the gossip protocols."""
    if protocol not in SIM_PROTOCOLS:
        raise ValueError(f"unknown protocol {protocol!r}")
    p = schedule.p
    table = _recv_table(schedule)

    def step(opt_state, params, batch, step_idx):
        t = int(step_idx)
        losses, grads = _losses(loss_fn, params, batch)
        recv = table[t % schedule.period]
        ok = drop_mask(seed, t, p, drop_prob)
        with torch.no_grad():
            if protocol == "agd":
                grads = allreduce_mean_sim(grads)
            elif protocol == "gossip_grad":
                grads = gossip_mix_sim_masked(grads, recv, ok)
            params, opt_state = optimizer.update(params, grads, opt_state)
            if protocol == "gossip":
                params = gossip_mix_sim_masked(params, recv, ok)
            elif protocol == "every_logp" and (t + 1) % schedule.substeps == 0:
                params = allreduce_mean_sim(params)
            metrics = {"loss": losses.mean(),
                       "replica_variance": replica_variance(params)}
        return opt_state, params, metrics

    return step


def _roundtrip(m: torch.Tensor, wire: WireFormat, t: int,
               leaf_idx: int) -> torch.Tensor:
    """Encode and decode one ``(p, ...)`` leaf through the wire, the leaf
    zero-padded to a LANE multiple for the per-tile scales."""
    if wire.dtype == "bf16":
        return m.to(torch.bfloat16).to(m.dtype)
    p = m.shape[0]
    flat = m.reshape(p, -1).float()
    n = flat.shape[1]
    pad = (-n) % LANE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    keys = wire_key(t, np.arange(p), leaf_idx, wire.seed)
    dec = decode_wire(encode_wire(flat, wire.dtype, keys=keys))
    return dec[:, :n].reshape(m.shape).to(m.dtype)


def make_async_sim_train_step(loss_fn: Callable, optimizer,
                              schedule: GossipSchedule, alpha: float = 0.5,
                              staleness: int = 1, drop_rate: float = 0.0,
                              drop_seed: int = 0, wire_dtype: str = "fp32",
                              gossip_subset: float = 1.0,
                              wire_seed: int = 0) -> Callable:
    """``step(opt_state, params, ring, batch, step_idx) -> (opt_state,
    params, ring, metrics)`` of the bounded-delay ``gossip_async`` protocol
    over p stacked replicas: the arrival mix first
    (``gossip_mix_sim_delayed_k`` with ``exchange_ok`` drops), then the
    gradient at the mixed params and the update. Start from
    ``core.async_gossip.init_inbox_ring(params, staleness, p)``.

    A compressed wire (``wire_dtype``, ``gossip_subset``, ``wire_seed``)
    treats every leaf as one wire bucket: the mixed leaf goes through an
    encode-decode roundtrip before it lands in the ring, and leaves outside
    the rotating subset ship zeros and are consumed at alpha 0. This is the
    reference's science twin of the wire, not an oracle of the packed
    engines (``gossip_mix_sim_quantized*`` are those)."""
    p = schedule.p
    k = int(staleness)
    table = _recv_table(schedule)
    wire = WireFormat(dtype=wire_dtype, subset=gossip_subset, seed=wire_seed)

    def mix(params, ring, recv, ok):
        if wire.is_default:
            return gossip_mix_sim_delayed_k(params, ring, recv, alpha, ok)
        t = int(ring["t"])
        leaves, td = tree_flatten(params)
        slot = td.flatten_up_to(ring["slots"][0])
        a = _masked_alpha(alpha, ring["valid"], leaves[0])
        subset = build_subset_schedule(len(leaves), wire.subset)
        cons = _sent(subset, t - k, len(leaves))
        sent = _sent(subset, t, len(leaves))
        mixed = []
        for i, (x, b) in enumerate(zip(leaves, slot)):
            w = _rowwise(a, x)
            mixed.append(x * (1.0 - w) + b * w if cons[i] else x)
        payload = []
        for i, m in enumerate(mixed):
            g = _gather(_roundtrip(m, wire, t, i), recv)
            payload.append(g if sent[i] else torch.zeros_like(g))
        return (td.unflatten(mixed),
                _ring_next(ring, td.unflatten(payload), ok, p))

    def step(opt_state, params, ring, batch, step_idx):
        if len(ring["slots"]) != k:
            raise ValueError(f"ring carries {len(ring['slots'])} slots but "
                             f"the step was built for staleness {k}")
        recv = table[int(step_idx) % schedule.period]
        ok = exchange_ok(int(ring["t"]), np.arange(p), drop_seed, drop_rate)
        with torch.no_grad():
            mixed, new_ring = mix(params, ring, recv, ok)
        losses, grads = _losses(loss_fn, mixed, batch)
        with torch.no_grad():
            metrics = {"loss": losses.mean(),
                       "replica_variance": replica_variance(mixed)}
            new_params, opt_state = optimizer.update(mixed, grads, opt_state)
        return opt_state, new_params, new_ring, metrics

    return step

