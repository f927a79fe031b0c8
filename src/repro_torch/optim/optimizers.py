"""SGD with momentum: the tree-level update and the fused bucket backend.

Port of ``repro/optim/optimizers.py`` (``Optimizer``, ``sgd``). States mirror
the param layout: for packed params the momentum is a ``PackedParams`` of
zero buckets in the params' dtype (as ``zeros_like`` gives it in the
reference), so a bf16 bucket keeps a bf16 momentum.

Both paths update in place (the reference returns new arrays and donates
the old ones):

* ``update`` is the tree-level rule, bucket by bucket in the reference's
  dtypes: the momentum arithmetic runs in the momentum's dtype (bf16 for a
  bf16 bucket) and the param step in fp32;
* ``fused_update`` is one single-sweep kernel per bucket
  (``kernels.ops.fused_sgd_bucket``), all arithmetic in fp32 before the
  stores. The two do not agree in bf16, as in the reference. Its partner
  is a bucket-shaped tensor or a quantized ``{"q", "s"}`` wire payload,
  and ``alpha`` a float or a tensor of one value per replica row.

adamw and lars wait for their kernels (ROADMAP A.11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.core.buckets import PackedParams
from repro_torch.kernels.ops import fused_sgd_bucket

from .schedules import Schedule, constant

__all__ = ["Optimizer", "sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    # state keys (beyond "step") holding per-param moment buffers, in the
    # order fused_update takes and returns them
    fused_moments: Tuple[str, ...] = ()
    # fused_update(bucket_idx, p, g, partner, moments, *, step, alpha,
    #              layout=None) -> (p, moments), in place; partner is a
    #              wire payload or None, alpha a float or a (dp,) tensor
    fused_update: Callable | None = None


def _buckets(x):
    if not isinstance(x, PackedParams):
        raise NotImplementedError(
            "the port's optimizers run on packed params only; the per-leaf "
            "engine is not ported yet (ROADMAP A.7)")
    return x.buckets


def sgd(schedule: Schedule | float, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD + momentum — the paper's optimizer (Caffe default momentum 0.9).
    ``schedule`` maps the host step counter to a float32 learning rate."""
    sched = constant(schedule) if isinstance(schedule, (int, float)) else schedule

    def init(params):
        mom = None
        if momentum:
            mom = PackedParams([torch.zeros_like(b, requires_grad=False)
                                for b in _buckets(params)], params.layout)
        return {"step": 0, "mom": mom}

    @torch.no_grad()
    def update(params, grads, state):
        lr = sched(state["step"])
        for i, (p, g) in enumerate(zip(_buckets(params), _buckets(grads))):
            if weight_decay:
                g = g + weight_decay * p.to(g.dtype)
            if momentum:
                m = state["mom"].buckets[i]
                m.copy_(momentum * m + g.to(m.dtype))
                p.copy_((p - lr * m.float()).to(p.dtype))
            else:
                p.copy_((p - lr * g.float()).to(p.dtype))
        return params, {"step": state["step"] + 1, "mom": state["mom"]}

    def fused_update(bucket_idx, p, g, partner, moments, *, step, alpha,
                     layout=None):
        (mom,) = moments
        new_p, new_m = fused_sgd_bucket(
            p, g, partner, mom, lr=sched(step), alpha=alpha,
            momentum=momentum, weight_decay=weight_decay)
        return new_p, (new_m,)

    return Optimizer(init, update, fused_moments=("mom",),
                     fused_update=fused_update)
