"""Protocol-neutral train step over replicas stacked on one device.

Port of ``repro/train/step.py`` (``make_train_step_bundle``,
``init_train_state``) for the packed engine. Every bucket carries the
replica axis first, ``(dp, stride)``; the batch is ``(dp, b, S+1)``. One
forward over ``PackedParams.unpack()`` views and one backward of the summed
per-replica losses leave every replica's own gradient, already packed, in
``bucket.grad``; nothing mixes replicas unless the protocol does.

Step layout (GossipGraD Fig. 8/9):
    1. per-replica grads from the local batch shard
    2. protocol.comm_grads
    3. local optimizer update             } fused: one sweep per bucket
    4. protocol.comm_params (gossip mix)  } (mix + update, in place)
    5. ring-rotate the batch shards (§4.5.2)

**Fused mix+apply** (default for packed sgd, adamw and lars): steps 3-4
are one single-sweep kernel per bucket that mixes with the partner's PRE-update
bucket (``core.gossip.make_packed_fused_update``), the reference's
GoSGD-style combined update; dp == 1, ``agd``, ``every_logp`` and ``none``
run it with alpha = 0. ``agd`` averages the gradients before the sweep and
``every_logp`` averages the params after it on its averaging steps (a
separate pass, as in the reference). ``fused_update=False`` keeps the
mix-then-apply composition.

**gossip_async** (``core.async_gossip``): the state carries the staleness-k
inbox ring (``state["inbox"]``). Unfused, the masked arrival mix of the
oldest slot and the re-dispatch run BEFORE the forward pass, in place under
``no_grad`` on the buckets (which are autograd leaves); fused, the ring's
oldest slot is the fused sweep's partner and each bucket is dispatched just
before its sweep. Both gossip protocols take the compressed /
partition-sampled wire (``wire_dtype``, ``gossip_subset``, ``wire_seed``)
and rotate the batch shards.

The per-leaf engine waits for a later slice (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import (PackedParams, build_layout, make_protocol,
                              make_ring_shuffle)
from repro_torch.core.async_gossip import (init_inbox_ring,
                                           init_wire_inbox_ring,
                                           make_packed_fused_async_update)
from repro_torch.core.gossip import make_packed_fused_update
from repro_torch.device import resolve_device
from repro_torch.kernels.quantize import WireFormat
from repro_torch.models import lm_init, lm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer

from .loss import make_loss_fn

__all__ = ["TrainStepBundle", "make_train_step_bundle", "init_train_state"]


class TrainStepBundle:
    def __init__(self, *, step_fn, protocol, cfg, optimizer, dp, layout,
                 fused, device, wire):
        self.step_fn = step_fn      # (state, batch, phase) -> (state, next_batch, metrics)
        self.protocol = protocol
        self.cfg = cfg
        self.optimizer = optimizer
        self.dp = dp
        self.layout = layout        # BucketLayout of the packed engine
        self.fused = fused          # single-sweep fused mix+apply engine
        self.device = device
        self.wire = wire            # the protocol's WireFormat

    def step(self, state, batch, phase: int):
        return self.step_fn(state, batch, phase % self.protocol.period)


def _packed_only(gossip_packed: bool) -> None:
    if not gossip_packed:
        raise NotImplementedError(
            "the per-leaf (unpacked) engine is not ported yet (ROADMAP A.7); "
            "use gossip_packed=True")


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *, dp: int,
                     packed: bool = False, layout=None, seed: int = 0,
                     params=None, device="cuda", inbox: int = 0,
                     wire: WireFormat = WireFormat()):
    """``{"params", "opt"}`` with every bucket ``(dp, stride)`` holding the
    same initial replica (the reference replicates one init). ``params`` may
    give that replica's tree (or a ready ``PackedParams``, e.g. from
    ``checkpoint.bridge``) instead of drawing it with ``seed``.

    ``inbox`` is the ring depth (pass the bundle's ``protocol.staleness``;
    0 = no ring) and ``wire`` the bundle's ``wire``: gossip_async carries a
    ring bootstrapped all-invalid, its slots bucket copies or, under a
    compressed wire, zero payloads."""
    _packed_only(packed)
    dev = resolve_device(device)
    layout = layout if layout is not None else build_layout(lm_specs(cfg))
    if not isinstance(params, PackedParams):
        tree = params if params is not None else lm_init(cfg, seed=seed,
                                                         device=dev)
        params = PackedParams.pack(tree, layout, lead=(dp,), device=dev)
    for b in params.buckets:
        b.requires_grad_(True)
    state = {"params": params, "opt": optimizer.init(params)}
    if inbox:
        state["inbox"] = (init_inbox_ring(params, inbox, dp)
                          if wire.is_default
                          else init_wire_inbox_ring(params, inbox, dp, wire))
    return state


def make_train_step_bundle(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    dp: int,
    protocol: str = "gossip",
    topology: str = "dissemination",
    num_rotations: int = 2,
    gossip_packed: bool = False,
    gossip_alpha: float = 0.5,
    staleness: int = 1,
    drop_rate: float = 0.0,
    drop_seed: int = 0,
    wire_dtype: str = "fp32",
    gossip_subset: float = 1.0,
    wire_seed: int = 0,
    fused_update: Optional[bool] = None,
    rotate_samples: Optional[bool] = None,
    seed: int = 0,
    device="cuda",
) -> TrainStepBundle:
    """Build the train step for ``dp`` stacked replicas under ``protocol``.
    ``fused_update=None`` turns the fused engine on whenever the params are
    packed and the optimizer has a fused backend. ``staleness``,
    ``drop_rate`` and ``drop_seed`` configure gossip_async's ring;
    ``wire_dtype``, ``gossip_subset`` and ``wire_seed`` the gossip wire.
    ``rotate_samples`` (default: on for the gossip protocols) ring-rotates
    the batch shards after each step (§4.5.2)."""
    _packed_only(gossip_packed)
    dev = resolve_device(device)
    layout = build_layout(lm_specs(cfg))
    if fused_update is None:
        fused_update = optimizer.fused_update is not None
    if fused_update and optimizer.fused_update is None:
        raise ValueError("fused_update=True but this optimizer has no fused "
                         "backend; use sgd, adamw or lars, or "
                         "fused_update=False")
    proto = make_protocol(protocol, dp, topology=topology,
                          num_rotations=num_rotations, alpha=gossip_alpha,
                          staleness=staleness, drop_rate=drop_rate,
                          drop_seed=drop_seed, packed_layout=layout,
                          seed=seed, wire_dtype=wire_dtype,
                          gossip_subset=gossip_subset, wire_seed=wire_seed)
    ring = proto.staleness > 0
    fused_eng = None
    if fused_update:
        if ring:
            fused_eng = make_packed_fused_async_update(
                proto.schedule, layout, optimizer, alpha=gossip_alpha,
                staleness=proto.staleness, drop_rate=drop_rate,
                drop_seed=drop_seed, wire=proto.wire)
        else:
            gossiping = protocol == "gossip" and dp > 1
            fused_eng = make_packed_fused_update(
                proto.schedule if gossiping else None, layout, optimizer,
                alpha=gossip_alpha if gossiping else 0.0, wire=proto.wire)
    loss_fn = make_loss_fn(cfg)
    if rotate_samples is None:
        rotate_samples = protocol in ("gossip", "gossip_async")
    shuffle = make_ring_shuffle() if rotate_samples and dp > 1 else None

    def train_step(state, batch, phase: int):
        params, inbox = state["params"], state.get("inbox")
        if ring and fused_eng is None:
            # bounded-delay arrival: mix the oldest slot in and re-dispatch,
            # in place on the leaf buckets, before the forward pass
            with torch.no_grad():
                params, inbox = proto.comm_params(params, phase, inbox=inbox)
        loss, metrics = loss_fn(params.unpack(), batch)
        loss.sum().backward()  # replica r's grad is d loss_r / d params_r
        grads = PackedParams([b.grad for b in params.buckets], layout)
        with torch.no_grad():
            grads = proto.comm_grads(grads, phase)
            if fused_eng is not None and ring:
                params, opt, inbox = fused_eng(params, grads, inbox,
                                               state["opt"], phase)
            elif fused_eng is not None:
                params, opt = fused_eng(params, grads, state["opt"], phase)
                if proto.name == "every_logp":
                    params = proto.comm_params(params, phase)
            else:
                params, opt = optimizer.update(params, grads, state["opt"])
                if not ring:
                    params = proto.comm_params(params, phase)
        for b in params.buckets:
            b.grad = None
        next_batch = shuffle(batch) if shuffle is not None else batch
        metrics = {k: v.detach().mean() for k, v in metrics.items()}
        new_state = {"params": params, "opt": opt}
        if ring:
            new_state["inbox"] = inbox
        return new_state, next_batch, metrics

    return TrainStepBundle(step_fn=train_step, protocol=proto, cfg=cfg,
                           optimizer=optimizer, dp=dp, layout=layout,
                           fused=bool(fused_update), device=dev,
                           wire=proto.wire)
