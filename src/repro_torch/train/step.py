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
    4. protocol.comm_params (gossip mix)  } (mix + SGD, in place)
    5. ring-rotate the batch shards (§4.5.2)

**Fused mix+apply** (default for packed sgd): steps 3-4 are one
single-sweep kernel per bucket that mixes with the partner's PRE-update
bucket (``core.gossip.make_packed_fused_update``), the reference's
GoSGD-style combined update; dp == 1 and ``none`` run it with alpha = 0.
``fused_update=False`` keeps the mix-then-apply composition.

The per-leaf engine, the async ring and the compressed wire wait for later
slices (ROADMAP A.7, A.9, A.10).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import (PackedParams, build_layout, make_protocol,
                              make_ring_shuffle)
from repro_torch.core.gossip import make_packed_fused_update
from repro_torch.device import resolve_device
from repro_torch.models import lm_init, lm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer

from .loss import make_loss_fn

__all__ = ["TrainStepBundle", "make_train_step_bundle", "init_train_state"]


class TrainStepBundle:
    def __init__(self, *, step_fn, protocol, cfg, optimizer, dp, layout,
                 fused, device):
        self.step_fn = step_fn      # (state, batch, phase) -> (state, next_batch, metrics)
        self.protocol = protocol
        self.cfg = cfg
        self.optimizer = optimizer
        self.dp = dp
        self.layout = layout        # BucketLayout of the packed engine
        self.fused = fused          # single-sweep fused mix+apply engine
        self.device = device

    def step(self, state, batch, phase: int):
        return self.step_fn(state, batch, phase % self.protocol.period)


def _packed_only(gossip_packed: bool) -> None:
    if not gossip_packed:
        raise NotImplementedError(
            "the per-leaf (unpacked) engine is not ported yet (ROADMAP A.7); "
            "use gossip_packed=True")


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *, dp: int,
                     packed: bool = False, layout=None, seed: int = 0,
                     params=None, device="cuda"):
    """``{"params", "opt"}`` with every bucket ``(dp, stride)`` holding the
    same initial replica (the reference replicates one init). ``params`` may
    give that replica's tree (or a ready ``PackedParams``, e.g. from
    ``checkpoint.bridge``) instead of drawing it with ``seed``."""
    _packed_only(packed)
    dev = resolve_device(device)
    layout = layout if layout is not None else build_layout(lm_specs(cfg))
    if not isinstance(params, PackedParams):
        tree = params if params is not None else lm_init(cfg, seed=seed,
                                                         device=dev)
        params = PackedParams.pack(tree, layout, lead=(dp,), device=dev)
    for b in params.buckets:
        b.requires_grad_(True)
    return {"params": params, "opt": optimizer.init(params)}


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
    fused_update: Optional[bool] = None,
    seed: int = 0,
    device="cuda",
) -> TrainStepBundle:
    """Build the train step for ``dp`` stacked replicas under ``protocol``.
    ``fused_update=None`` turns the fused engine on whenever the params are
    packed and the optimizer has a fused backend."""
    _packed_only(gossip_packed)
    dev = resolve_device(device)
    layout = build_layout(lm_specs(cfg))
    if fused_update is None:
        fused_update = optimizer.fused_update is not None
    if fused_update and optimizer.fused_update is None:
        raise ValueError("fused_update=True but this optimizer has no fused "
                         "backend; use sgd or fused_update=False")
    proto = make_protocol(protocol, dp, topology=topology,
                          num_rotations=num_rotations, alpha=gossip_alpha,
                          packed_layout=layout, seed=seed)
    fused_eng = None
    if fused_update:
        gossiping = protocol == "gossip" and dp > 1
        fused_eng = make_packed_fused_update(
            proto.schedule if gossiping else None, layout, optimizer,
            alpha=gossip_alpha if gossiping else 0.0)
    loss_fn = make_loss_fn(cfg)
    # gossip rotates the sample shards around the replica ring (§4.5.2)
    shuffle = make_ring_shuffle() if (protocol == "gossip" and dp > 1) else None

    def train_step(state, batch, phase: int):
        params = state["params"]
        loss, metrics = loss_fn(params.unpack(), batch)
        loss.sum().backward()  # replica r's grad is d loss_r / d params_r
        grads = PackedParams([b.grad for b in params.buckets], layout)
        with torch.no_grad():
            grads = proto.comm_grads(grads, phase)
            if fused_eng is not None:
                params, opt = fused_eng(params, grads, state["opt"], phase)
            else:
                params, opt = optimizer.update(params, grads, state["opt"])
                params = proto.comm_params(params, phase)
        for b in params.buckets:
            b.grad = None
        next_batch = shuffle(batch) if shuffle is not None else batch
        metrics = {k: v.detach().mean() for k, v in metrics.items()}
        return {"params": params, "opt": opt}, next_batch, metrics

    return TrainStepBundle(step_fn=train_step, protocol=proto, cfg=cfg,
                           optimizer=optimizer, dp=dp, layout=layout,
                           fused=bool(fused_update), device=dev)
