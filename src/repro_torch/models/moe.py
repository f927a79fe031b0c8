"""Top-k routed mixture of experts (DeepSeek-V3 [arXiv:2412.19437],
Kimi-K2, Jamba [arXiv:2403.19887]).

Port of ``repro/models/moe.py`` (``moe_capacity``, ``moe_init``,
``_dispatch_one_group``, ``_expert_ffn``, ``_combine_scatter`` as
``_combine``, ``_expert_compute_auto``, ``moe_apply``), plain torch as the
reference's is jnp. Tokens are grouped by batch row (and replica: x is
(dp, b, S, d), expert weights (dp, E, d, f)); within each group they are
sorted by destination expert and gathered into a fixed-capacity (E, C, d)
buffer, GShard's capacity semantics with the reference's sort-based
dispatch. Capacity overflow drops a token's choice (the residual path keeps
the token); ``moe_dropped_frac`` reports the share per replica.

Parity with the reference, where torch and jnp differ:
* ``_top_k`` takes the k largest router probabilities from a stable
  descending sort, so ties go to the lower expert index as
  ``jax.lax.top_k``'s do (``torch.topk`` promises no order).
* The dispatch tables are integer logic from a stable ``argsort``,
  ``searchsorted`` and gathers.
  They equal the reference's bit for bit, and nothing in them depends
  on the order of a scatter.
* The combine adds each token's k weighted slot outputs into zeros in
  ascending slot order, as the reference's scatter-add into zeros does:
  a gather through the inverse table and k adds, never atomics, so the
  card and the CPU add in one order at any k.

The combined output's last add runs under ``moe_combine_output()``, which
``blocks.stack_apply``'s ``remat_policy="save_moe_combine"`` reads, as the
reference names it ``checkpoint_name(y, "moe_combine")``.

``_expert_compute_manual`` is expert parallelism (ref ``moe.py:109-166``,
under ``shard_map``), on one process per mesh position: a rank whose
model group (``core.replica_group``) has ``M > 1`` members, under a plan
with ``model`` in its axes and ``E % M == 0`` (the reference's condition,
``moe.py:192-200``; a rank's rows are its batch index's already), computes
only its ``E / M`` experts and sums the partial outputs over the model
group in fp32, in model order, then rounds once to the compute dtype, as
the reference's ``parts.sum(axis=0).astype(dtype)``. The per-leaf path
hands it those experts (``core.buckets.BucketLayout.gather_pieces``), the
packed path all ``E`` (the whole buckets), of which it slices its own.
Every run without ranks (stacked replicas, one device, the dry run) and
every ``M = 1`` keeps ``_expert_compute_auto``, which the manual path
equals there but for the rounding at its fp32 boundary.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.buckets import gather_rows
from repro_torch.dist_ctx import current_distribution, current_group

from .config import MoESpec
from .layers import (Param, dense_param, mlp_apply, mlp_init, replica_matmul,
                     silu, weight_einsum)

__all__ = ["moe_init", "moe_apply", "moe_capacity", "moe_combine_output"]


def moe_capacity(tokens_per_group: int, spec: MoESpec) -> int:
    c = math.ceil(tokens_per_group * spec.top_k * spec.capacity_factor
                  / spec.n_experts)
    return max(1, min(c, tokens_per_group))


def moe_init(d: int, spec: MoESpec, dtype=torch.float32) -> Dict:
    E, f = spec.n_experts, spec.d_ff_expert
    p = {"router": dense_param(d, (E,), "embed", (None,), dtype=dtype),
         "w_gate": Param((E, d, f), ("experts", "embed", "expert_ffn"),
                         scale=1.0 / math.sqrt(d), dtype=dtype),
         "w_in": Param((E, d, f), ("experts", "embed", "expert_ffn"),
                       scale=1.0 / math.sqrt(d), dtype=dtype),
         "w_out": Param((E, f, d), ("experts", "expert_ffn", "embed"),
                        scale=1.0 / math.sqrt(f), dtype=dtype)}
    if spec.n_shared:
        p["shared"] = mlp_init(d, f * spec.n_shared, "swiglu", dtype=dtype)
    return p


# Set while the combine's last add runs: remat's "save_moe_combine" policy
# saves exactly that op's output (``blocks._remat_context``).
_MOE_COMBINE = contextvars.ContextVar("moe_combine", default=False)


@contextlib.contextmanager
def _combine_output():
    token = _MOE_COMBINE.set(True)
    try:
        yield
    finally:
        _MOE_COMBINE.reset(token)


def moe_combine_output() -> bool:
    """True while the op that produces an MoE layer's combined output runs."""
    return _MOE_COMBINE.get()


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    ties to the lower index (a stable descending sort)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _dispatch_one_group(topi: torch.Tensor, E: int, C: int):
    """The reference's per-group dispatch, for every group at once: topi
    (G, S, k) expert choices. Returns

    * ``table`` (G, E*C): slot -> token (S for an empty slot), which gathers
      tokens into the expert buffers;
    * ``inv`` (G, S, k): choice -> slot (E*C for a dropped choice), which
      gathers the expert outputs back;
    * ``dropped`` (G,) fp32: the share of choices past capacity;
    * ``choice`` (G, E*C): slot -> flat choice index t*k + j (S*k for an
      empty slot), which gathers the router weights into the slots.

    Choices are sorted by expert, stably, so within an expert they keep
    token order; the first C of each expert get its slots."""
    G, S, k = topi.shape
    n = S * k
    dev = topi.device
    eids = topi.reshape(G, n)
    order = torch.argsort(eids, dim=-1, stable=True)
    se = eids.gather(1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - start
    pos = torch.arange(n, device=dev) - start.gather(1, se)
    valid = pos < C
    slot = torch.where(valid, se * C + pos, E * C)
    inv = slot.gather(1, torch.argsort(order, dim=1))  # order's inverse
    c = torch.arange(C, device=dev)
    at = (start[:, :, None] + c).clamp(max=n - 1).reshape(G, E * C)
    filled = (c < counts[:, :, None]).reshape(G, E * C)
    choice = torch.where(filled, order.gather(1, at), n)
    table = torch.where(filled, choice // k, S)
    dropped = (~valid).sum(1).float() / torch.tensor(
        n, dtype=torch.float32, device=dev)
    return table, inv.view(G, S, k), dropped, choice


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (G, N, d), idx (G, M) -> (G, M, d): row idx[g, m] of group g."""
    G, N, d = src.shape
    flat = idx + torch.arange(G, device=idx.device)[:, None] * N
    return src.reshape(G * N, d).index_select(0, flat.reshape(-1)).view(
        G, idx.shape[1], d)


def _expert_ffn(wg, wi, wo, xe, out_dtype):
    """xe (dp, b, E, C, d) through each replica's per-expert SwiGLU
    (weights (dp, E, d, f) and (dp, E, f, d))."""
    h = silu(weight_einsum("rbecd,redf->rbecf", xe, wg)) \
        * weight_einsum("rbecd,redf->rbecf", xe, wi)
    return weight_einsum("rbecf,refd->rbecd", h, wo).to(out_dtype)


def _combine(ye: torch.Tensor, inv: torch.Tensor,
             output: bool = True) -> torch.Tensor:
    """ye (G, E*C, d) weighted slot outputs, inv (G, S, k) -> (G, S, d):
    each token's slot outputs added into zeros in ascending slot order (a
    dropped choice reads a zero row), the reference's scatter-add order.
    With ``output`` the last add is the layer's combined output
    (``_combine_output``); a rank's partial under expert parallelism is
    not."""
    G, _, d = ye.shape
    k = inv.shape[2]
    ye = torch.cat([ye, ye.new_zeros(G, 1, d)], dim=1)
    slots = torch.sort(inv, dim=-1).values
    y = ye.new_zeros(G, inv.shape[1], d)
    for j in range(k):
        rows = _gather_rows(ye, slots[:, :, j])
        if j < k - 1 or not output:
            y = y + rows
        else:
            with _combine_output():
                y = y + rows
    return y


def _expert_compute_auto(p, x: torch.Tensor, table, wslot, inv, C: int):
    """x (dp, b, S, d) gathered into the slots, through the experts,
    weighted by ``wslot`` (dp, b, E, C) and combined back to (dp, b, S, d)."""
    dp, B, S, d = x.shape
    E = wslot.shape[2]
    x_pad = torch.cat([x, x.new_zeros(dp, B, 1, d)], dim=2)
    xe = _gather_rows(x_pad.view(dp * B, S + 1, d), table).view(
        dp, B, E, C, d)
    ye = _expert_ffn(p["w_gate"], p["w_in"], p["w_out"], xe, x.dtype)
    ye = ye * wslot[..., None]
    return _combine(ye.reshape(dp * B, E * C, d), inv).view(dp, B, S, d)


# Collectives over the model group, counted where they are issued: the
# partial sum of each manual forward (remat's recompute replays it) and
# the entry op's gradient sum of each backward.
model_collectives = {"partial_sum": 0, "grad_sum": 0}


def _sum_over_model(parts, dtype) -> torch.Tensor:
    """fp32 tensors of one shape, one per model index: their sum from zero
    in model order, rounded once to ``dtype``, its last op under
    ``_combine_output`` (the layer's combined output)."""
    acc = torch.zeros_like(parts[0])
    for part in parts[:-1]:
        acc = acc + part
    if dtype == torch.float32:
        with _combine_output():
            return acc + parts[-1]
    acc = acc + parts[-1]
    with _combine_output():
        return acc.to(dtype)


class _GatherPartials(torch.autograd.Function):
    """Forward: every model-group member's partial output, in fp32 and in
    model order, one ``all_gather`` moved as raw bits. Backward: the
    cotangent of this rank's own partial, passed on unchanged (rounded to
    the partial's dtype, exact where it came from it)."""

    @staticmethod
    def forward(ctx, part, group):
        ctx.index, ctx.dtype = group.model_index, part.dtype
        model_collectives["partial_sum"] += 1
        return torch.stack(gather_rows(part.float(), group.model,
                                       group.model_shards))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return grad[ctx.index].to(ctx.dtype), None


class _ModelEntry(torch.autograd.Function):
    """The identity on the tokens and the slot weights that every member
    of the model group holds alike; backward sums their gradients over the
    group in fp32, in model order, and rounds once: the transpose of the
    reference's inputs replicated over ``model``, without which ``dx`` and
    the router's gradient would miss the other ranks' experts."""

    @staticmethod
    def forward(ctx, x, wslot, group):
        ctx.group = group
        return x.view_as(x), wslot.view_as(wslot)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gx, gw):
        group = ctx.group
        model_collectives["grad_sum"] += 1
        flat = torch.cat([gx.reshape(-1).float(), gw.reshape(-1).float()])
        acc = torch.zeros_like(flat)
        for part in gather_rows(flat, group.model, group.model_shards):
            acc = acc + part
        n = gx.numel()
        return (acc[:n].view(gx.shape).to(gx.dtype),
                acc[n:].view(gw.shape).to(gw.dtype), None)


def _expert_parallel(E: int):
    """The active step's ``ReplicaGroup`` where its rank computes only
    ``E / M`` experts (expert parallelism): a plan with ``model`` in its
    axes, a model group of ``M > 1`` members and ``E % M == 0``, the
    reference's condition (``src/repro/models/moe.py:192-200``); else
    None."""
    dist, group = current_distribution(), current_group()
    if (dist is None or group is None or group.model is None
            or "model" not in dist.axis_names):
        return None
    return group if E % group.model_shards == 0 else None


def _expert_compute_manual(p, x: torch.Tensor, table, wslot, inv, C: int,
                           group):
    """``_expert_compute_auto`` on this rank's experts ``[m E/M, (m+1)
    E/M)`` (m its model index): their columns of the dispatch table and
    of ``wslot``, their FFN, the combine of their slots (the other
    experts' slots read the zero row, as dropped choices do), then the
    fp32 sum of every rank's partial in model order, rounded once to the
    compute dtype (ref ``moe.py:109-166``). The expert leaves hold either
    all ``E`` experts (the packed path) or this rank's (the per-leaf
    path)."""
    dp, B, S, d = x.shape
    E = wslot.shape[2]
    e, m = E // group.model_shards, group.model_index
    lo = m * e
    w = [p[k] if p[k].shape[-3] == e else p[k][..., lo:lo + e, :, :]
         for k in ("w_gate", "w_in", "w_out")]
    x, wslot = _ModelEntry.apply(x, wslot, group)
    x_pad = torch.cat([x, x.new_zeros(dp, B, 1, d)], dim=2)
    mine = table.view(dp * B, E, C)[:, lo:lo + e].reshape(dp * B, e * C)
    xe = _gather_rows(x_pad.view(dp * B, S + 1, d), mine).view(
        dp, B, e, C, d)
    ye = _expert_ffn(*w, xe, x.dtype) * wslot[:, :, lo:lo + e, :, None]
    own = (inv >= lo * C) & (inv < (lo + e) * C)
    part = _combine(ye.reshape(dp * B, e * C, d),
                    torch.where(own, inv - lo * C, e * C), output=False)
    parts = _GatherPartials.apply(part, group).unbind(0)
    return _sum_over_model(parts, x.dtype).view(dp, B, S, d)


def moe_apply(p, spec: MoESpec, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (dp, b, S, d) -> (y (dp, b, S, d), {"moe_aux", "moe_dropped_frac"}),
    each metric (dp,) fp32: the Switch load-balance loss ``E * sum_e f_e *
    P_e`` averaged over the batch rows times ``aux_coef``, and the share of
    dropped choices."""
    dp, B, S, d = x.shape
    E, k = spec.n_experts, spec.top_k
    C = moe_capacity(S, spec)
    logits = replica_matmul(x, p["router"]).float()          # (dp,b,S,E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, k)
    if spec.router_scale:
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    G = dp * B
    table, inv, dropped, choice = _dispatch_one_group(topi.view(G, S, k),
                                                      E, C)
    # slot weights: each slot's router weight, zero for an empty slot
    w = torch.cat([topw.reshape(G, S * k).to(x.dtype),
                   x.new_zeros(G, 1)], dim=1)
    wslot = w.gather(1, choice).view(dp, B, E, C)
    group = _expert_parallel(E)
    y = (_expert_compute_manual(p, x, table, wslot, inv, C, group)
         if group is not None
         else _expert_compute_auto(p, x, table, wslot, inv, C))
    if spec.n_shared:
        y = y + mlp_apply(p["shared"], x, "swiglu")
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    counts = torch.zeros(G, E, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, topi.reshape(G, S * k),
                        torch.ones(G, S * k, device=x.device))
    f_e = (counts / torch.tensor(S * k, dtype=torch.float32,
                                 device=x.device)).view(dp, B, E)
    P_e = probs.mean(dim=2)                                   # (dp,b,E)
    aux = E * (f_e * P_e).sum(-1).mean(-1)
    return y, {"moe_aux": aux * spec.aux_coef,
               "moe_dropped_frac": dropped.view(dp, B).mean(-1)}
