"""SGD-momentum, AdamW and LARS: the tree-level updates and the fused bucket
backends.

Port of ``repro/optim/optimizers.py`` (``Optimizer``, ``sgd``, ``adamw``,
``lars``, ``_lars_row_scale``). States mirror the params: for packed params
every moment is a ``PackedParams`` of zero buckets, for a param tree (the
per-leaf engines) a tree of zero leaves. sgd's momentum
keeps the params' dtype (as ``zeros_like`` gives it in the reference), so a
bf16 bucket keeps a bf16 momentum; adamw's ``m``, ``v`` and lars's ``mom``
are fp32 whatever the bucket dtype.

Both paths update in place (the reference returns new arrays and donates
the old ones):

* ``update`` is the tree-level rule in the reference's dtypes and op order:
  sgd and adamw bucket by bucket or leaf by leaf (they are elementwise),
  lars leaf by leaf, through the ``PackedParams.unpack()`` views when
  packed;
* ``fused_update`` is one single-sweep kernel per bucket
  (``kernels.ops.fused_{sgd,adamw,lars}_bucket``), all arithmetic in fp32
  before the stores. Its partner is a bucket-shaped tensor or a quantized
  ``{"q", "s"}`` wire payload, and ``alpha`` a float or a tensor of one
  value per replica row. sgd's two paths do not agree in bf16 (its
  tree-level momentum runs in bf16), as in the reference.

Step-dependent scalars (the learning rate, adamw's bias corrections
``1 - beta^(step+1)``) are numpy float32 on the host, in the reference's op
order; XLA's float32 ``pow`` may differ from numpy's by an ulp or two
(ROADMAP C).

``Optimizer`` carries the reference's ``elementwise``, ``packed_aware``
and ``fused_shard_local`` fields: sgd and adamw are elementwise, so they
sweep any bucket layout; lars reads per-layer norms through the
``PackedParams.unpack()`` view (packed-aware). On a shard-local layout the
unpacked leaves are assembled copies, so lars's tree-level update takes
each norm over the whole leaf and writes the results back into the
buckets; its fused backend, whose prepass reads one bucket at a time, is
refused there, as in the reference. On one process per mesh position
lars's norms span what the stacked run's span: a rank's packed state
gathers its replica's leaves, and a per-leaf rank (``update(...,
group=)``) adds its pieces' squares over the in-replica group in shard
order, then every rank's over the replicas in replica order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.buckets import LANE, PackedParams
from repro_torch.core.gossip import gather_rows
from repro_torch.kernels.fused_update import (_adamw_math, _mix_f32,
                                              _sqrt_rn, device_scalar)
from repro_torch.kernels.ops import (fused_adamw_bucket, fused_lars_bucket,
                                     fused_sgd_bucket)
from repro_torch.kernels.quantize import dequant_flat
from repro_torch.tree import tree_flatten, tree_map

from .schedules import Schedule, constant

__all__ = ["Optimizer", "sgd", "adamw", "lars"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    # update(params, grads, state, group=None) -> (params, state), in
    # place; ``group`` is a per-leaf rank's ReplicaGroup (read by lars's
    # norms; the elementwise rules need no other rank)
    update: Callable
    # state keys (beyond "step") holding per-param moment buffers, in the
    # order fused_update takes and returns them
    fused_moments: Tuple[str, ...] = ()
    # fused_update(bucket_idx, p, g, partner, moments, *, step, alpha,
    #              layout=None) -> (p, moments), in place; partner is a
    #              wire payload or None, alpha a float or a (dp,) tensor
    fused_update: Callable | None = None
    # True when update is elementwise per bucket or leaf, so the bucketed
    # engines may run it over whole buckets (sgd, adamw)
    elementwise: bool = True
    # a non-elementwise update that reads its per-leaf norms through the
    # ``PackedParams.unpack()`` view (lars)
    packed_aware: bool = False
    # False when the fused backend cannot run on shard-local layouts
    # (lars: its norm prepass reads one bucket, a layer spans shards)
    fused_shard_local: bool = True


def _parts(x):
    """The tensors an elementwise rule sweeps: the buckets of a
    ``PackedParams``, the leaves of a tree."""
    if isinstance(x, PackedParams):
        return x.buckets
    return tree_flatten(x)[0]


def _like(params, fn):
    """A state mirroring ``params``: ``fn`` of every bucket or leaf (a
    rank's stretches stay its stretches)."""
    if isinstance(params, PackedParams):
        return params.like([fn(b) for b in params.buckets])
    return tree_map(fn, params)


def _schedule(schedule: Schedule | float) -> Schedule:
    return constant(schedule) if isinstance(schedule, (int, float)) else schedule


def _zeros_f32(params):
    return _like(params, lambda b: torch.zeros_like(b, dtype=torch.float32,
                                                    requires_grad=False))


def sgd(schedule: Schedule | float, momentum: float = 0.9,
        weight_decay: float = 0.0) -> Optimizer:
    """SGD + momentum — the paper's optimizer (Caffe default momentum 0.9).
    ``schedule`` maps the host step counter to a float32 learning rate."""
    sched = _schedule(schedule)

    def init(params):
        mom = None
        if momentum:
            mom = _like(params, lambda b: torch.zeros_like(
                b, requires_grad=False))
        return {"step": 0, "mom": mom}

    @torch.no_grad()
    def update(params, grads, state, group=None):
        lr = sched(state["step"])
        moms = _parts(state["mom"]) if momentum else None
        for i, (p, g) in enumerate(zip(_parts(params), _parts(grads))):
            if weight_decay:
                g = g + weight_decay * p.to(g.dtype)
            if momentum:
                m = moms[i]
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


def bias_correction(beta: float, t: int) -> float:
    """``1 - beta^t`` as the reference computes it on the int32 step cast
    to float32, here in numpy float32: a Python float that is exactly that
    float32."""
    return float(np.float32(1) - np.power(np.float32(beta), np.float32(t)))


def adamw(schedule: Schedule | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with decoupled weight decay, ``u + wd * p`` added to the Adam
    direction (the reference's form); fp32 moments ``m``, ``v``."""
    sched = _schedule(schedule)
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def init(params):
        return {"step": 0, "m": _zeros_f32(params), "v": _zeros_f32(params)}

    @torch.no_grad()
    def update(params, grads, state, group=None):
        lr, t = sched(state["step"]), state["step"] + 1
        ms, vs = _parts(state["m"]), _parts(state["v"])
        for i, (p, g) in enumerate(zip(_parts(params), _parts(grads))):
            m, v = ms[i], vs[i]
            new_p, new_m, new_v = _adamw_math(
                p.float(), g.float(), m, v, lr,
                device_scalar(bias_correction(b1, t), p),
                device_scalar(bias_correction(b2, t), p), **hyper)
            m.copy_(new_m)
            v.copy_(new_v)
            p.copy_(new_p.to(p.dtype))
        return params, {"step": t, "m": state["m"], "v": state["v"]}

    def fused_update(bucket_idx, p, g, partner, moments, *, step, alpha,
                     layout=None):
        m, v = moments
        new_p, new_m, new_v = fused_adamw_bucket(
            p, g, partner, m, v, lr=sched(step),
            c1=bias_correction(b1, step + 1), c2=bias_correction(b2, step + 1),
            alpha=alpha, **hyper)
        return new_p, (new_m, new_v)

    return Optimizer(init, update, fused_moments=("m", "v"),
                     fused_update=fused_update)


def _trust(wn, gn, *, trust_coef: float, weight_decay: float, eps: float):
    """``trust_coef * |w| / (|g| + wd * |w| + eps)`` where both norms are
    positive, else 1."""
    return torch.where((wn > 0) & (gn > 0),
                       trust_coef * wn / (gn + weight_decay * wn + eps), 1.0)


def _lars_row_scale(layout, bucket_idx: int, p, g, partner, *, alpha,
                    weight_decay: float, trust_coef: float, eps: float):
    """LARS norm prepass for one bucket: per-layer trust ratios, PER REPLICA
    ROW (each rank owns a distinct model), expanded to one fp32 scale per
    (row, 128) tile, shape ``p.shape[:-1] + (n // 128,)``.

    Reads the mixed params (``_mix_f32``, the same op and the same alpha,
    static, () or per row, as the fused kernel, so the mixed values are the
    kernel's bit for bit) and ``g + wd * p``, and takes each slot's norm as
    a few ops over the whole bucket: sums of squares per 128-element row,
    added into the row's slot with ``index_add_`` (the layout's
    ``row_slots`` table), square roots, the trust table with padding at
    1.0, gathered back per row. Slot offsets are LANE multiples and gaps
    zero, so the row sums see exactly each slot's values; the summation
    order differs from the reference's ``jnp.linalg.norm`` (and is not
    fixed on CUDA, where ``index_add_`` adds atomically), so the ratios
    match the reference's to fp32 rounding, not bit for bit. A shard-local
    layout raises: a layer's pieces lie in every shard."""
    if layout.num_shards > 1:
        raise ValueError(
            "lars has no fused backend for shard-local (hierarchical) "
            "layouts: the trust ratio needs per-LAYER norms and each shard "
            "holds only its piece of every layer; use sgd/adamw, or lars "
            "with fused_update=False (its tree-level update reads whole "
            "leaves through the unpack view)")
    n = int(p.shape[-1])
    rows = n // LANE
    row_map, nslots = layout.row_slots(bucket_idx, p.device)
    p2 = p.reshape(-1, n)
    dp = p2.shape[0]
    pf = _mix_f32(p2.float(), partner.reshape(-1, n)
                  if partner is not None else None, alpha, p.dtype)
    gf = g.reshape(-1, n).float()
    if weight_decay:
        gf = gf + weight_decay * pf

    def slot_norms(x):
        sq = (x * x).view(dp, rows, LANE).sum(-1)
        acc = torch.zeros((dp, nslots + 1), dtype=torch.float32,
                          device=p.device)
        return _sqrt_rn(acc.index_add_(1, row_map, sq))

    trust = _trust(slot_norms(pf), slot_norms(gf), trust_coef=trust_coef,
                   weight_decay=weight_decay, eps=eps)
    trust[:, nslots] = 1.0
    return trust.index_select(1, row_map).reshape(tuple(p.shape[:-1])
                                                  + (rows,))


def lars(schedule: Schedule | float, momentum: float = 0.9,
         trust_coef: float = 1e-3, weight_decay: float = 0.0,
         eps: float = 1e-9) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling [You et al., the paper's §8 pointer
    for large-batch hyperparameter scaling]: per-layer LR is scaled by
    trust_coef * ||w|| / (||g|| + wd*||w||); fp32 momentum."""
    sched = _schedule(schedule)
    hyper = dict(trust_coef=trust_coef, weight_decay=weight_decay, eps=eps)

    def init(params):
        return {"step": 0, "mom": _zeros_f32(params)}

    def leaves(x):
        return tree_flatten(x.unpack() if isinstance(x, PackedParams)
                            else x)[0]

    def direction(p, g):
        pf, gf = p.float(), g.float()
        if weight_decay:
            gf = gf + weight_decay * pf
        return pf, gf

    def summed(sq, pg, n):
        """``sq`` added over the ``n`` members of ``pg`` in member order
        from zero (``sq`` itself for one member)."""
        if n <= 1:
            return sq
        acc = torch.zeros_like(sq)
        for part in gather_rows(sq, pg, n):
            acc = acc + part
        return acc

    def squares(ps, gs, group, pieces):
        """Per leaf ``(|w|^2, |g + wd w|^2)`` in fp32, ``(leaves, 2)``;
        with ``pieces`` (a per-leaf rank's pieces, which tile each leaf
        once) first added over the in-replica group in shard order; under
        a replica group then over the replicas in replica order (the
        stacked leaf spans them all)."""
        sq = []
        for p, g in zip(ps, gs):
            pf, gf = direction(p, g)
            sq.append(torch.stack([(pf * pf).sum(), (gf * gf).sum()]))
        sq = torch.stack(sq)
        if group is None:
            return sq
        if pieces:
            sq = summed(sq, group.inner, group.num_shards)
        return summed(sq, group.cross, group.dp)

    @torch.no_grad()
    def update(params, grads, state, group=None):
        """In place, leaf by leaf (on the ``unpack()`` views when packed).
        Each norm spans
        the leaf AS GIVEN, i.e. across the stacked replica axis, exactly as
        the reference's unfused trainer computes it on its global arrays
        (ROADMAP C); the fused backend's prepass is per replica row. On a
        shard-local layout the leaves are assembled copies, updated and
        then packed back into the buckets. A rank's packed state
        (``PackedParams.group``) gathers its replica's leaves and adds the
        replicas' sums of squares in replica order, so its norms span what
        the stacked ones span; it writes back its own pieces. A per-leaf
        rank passes its ``group``: its tree holds its replica's leaves, or
        under in-replica shards its pieces of them, whose squares are
        added over the replica's shards before the replicas."""
        lr = sched(state["step"])
        ps, ms = leaves(params), leaves(state["mom"])
        gs = leaves(grads)
        packed = isinstance(params, PackedParams)
        group = params.group if packed else group
        sq = squares(ps, gs, group, pieces=not packed and group is not None
                     and group.num_shards > 1)
        for i, (p, g, m) in enumerate(zip(ps, gs, ms)):
            pf, gf = direction(p, g)
            trust = _trust(_sqrt_rn(sq[i, 0]), _sqrt_rn(sq[i, 1]), **hyper)
            m.copy_(momentum * m + gf * trust)
            p.copy_((pf - lr * m).to(p.dtype))
        if isinstance(params, PackedParams) and params.layout.hierarchical:
            td = params.layout.treedef
            params.pack_into(td.unflatten(ps))
            state["mom"].pack_into(td.unflatten(ms))
        return params, {"step": state["step"] + 1, "mom": state["mom"]}

    def fused_update(bucket_idx, p, g, partner, moments, *, step, alpha,
                     layout=None):
        """Two phases: the norm prepass (``_lars_row_scale``, plain PyTorch
        as the reference's is jnp) and the single-sweep kernel. A quantized
        partner is decoded once before both, as the reference does: the
        prepass reads the mixed params, so the decode cannot stay in the
        sweep."""
        if layout is None:
            raise ValueError("lars.fused_update needs the BucketLayout for "
                             "its per-layer norm prepass")
        if isinstance(partner, dict):
            partner = dequant_flat(partner["q"], partner["s"])
        (mom,) = moments
        scale = _lars_row_scale(layout, bucket_idx, p, g, partner,
                                alpha=alpha, **hyper)
        new_p, new_m = fused_lars_bucket(
            p, g, partner, mom, scale, lr=sched(step), alpha=alpha,
            momentum=momentum, weight_decay=weight_decay)
        return new_p, (new_m,)

    return Optimizer(init, update, fused_moments=("mom",),
                     fused_update=fused_update, elementwise=False,
                     packed_aware=True, fused_shard_local=False)
