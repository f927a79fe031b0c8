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

``_expert_compute_manual`` (expert parallelism under ``shard_map``, ref
``moe.py:109-166``) is not ported: every process runs
``_expert_compute_auto`` on its replica's whole expert weights, the ranks
of one replica gathering them with the rest of its stretches (ROADMAP
A.12d).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Tuple

import torch

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


def _combine(ye: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """ye (G, E*C, d) weighted slot outputs, inv (G, S, k) -> (G, S, d):
    each token's slot outputs added into zeros in ascending slot order (a
    dropped choice reads a zero row), the reference's scatter-add order."""
    G, _, d = ye.shape
    k = inv.shape[2]
    ye = torch.cat([ye, ye.new_zeros(G, 1, d)], dim=1)
    slots = torch.sort(inv, dim=-1).values
    y = ye.new_zeros(G, inv.shape[1], d)
    for j in range(k):
        rows = _gather_rows(ye, slots[:, :, j])
        if j < k - 1:
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
    y = _expert_compute_auto(p, x, table, wslot, inv, C)
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
