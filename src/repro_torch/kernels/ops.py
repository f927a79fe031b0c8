"""Bucket-level wrappers the engines call, and the model-level entry points
of the forward-only kernels.

Port of ``repro/kernels/ops.py`` (``gossip_mix_flat``, ``gossip_mix_tree``,
``gossip_mix_bucket`` with the reference's
``gossip_mix_wire_bucket`` folded in, ``fused_sgd_bucket``,
``fused_adamw_bucket``, ``fused_lars_bucket``, ``ssm_scan``,
``flash_mha``). The dispatch
rule is the tensor's device and nothing else: a CPU tensor gets the plain
PyTorch version, a CUDA tensor gets the hand-written kernel or an
exception. There is no ``impl`` override, no capability check and no
fallback. Each kernel keeps its launch count on its module
(``gossip_mix.launches``, ``gossip_mix.q_launches``,
``fused_update.launches``, ``fused_update.adamw_launches``,
``fused_update.lars_launches``, ``ssm_scan_kernel.launches``,
``flash_attention.launches``).

Every wrapper takes the partner as a wire payload: a raw tensor (fp32 or
bf16 wire) or a quantized ``{"q": codes, "s": tile scales}`` dict
(``kernels.quantize``), whose decode runs inside the mix, SGD or AdamW
sweep. The LARS sweep takes a raw partner, so ``fused_lars_bucket`` decodes
a dict first with ``dequant_flat`` (lars's optimizer hands it the decoded
partner its norm prepass read, as the reference does).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map

from .flash_attention import flash_attention
from .fused_update import fused_adamw_1d, fused_lars_1d, fused_sgd_1d
from .gossip_mix import LANE, gossip_mix_1d, gossip_mix_out, gossip_mix_q2d
from .quantize import dequant_flat
from .ssm_scan_kernel import ssm_scan_chunked

__all__ = ["gossip_mix_flat", "gossip_mix_tree", "gossip_mix_bucket", "fused_sgd_bucket", "fused_adamw_bucket",
           "fused_lars_bucket", "ssm_scan", "flash_mha"]


def gossip_mix_flat(a: torch.Tensor, b: torch.Tensor,
                    alpha: float = 0.5) -> torch.Tensor:
    """Mix two same-shape buffers of any shape out of place: a new tensor
    of ``a``'s shape and dtype, ``a`` untouched, as the reference returns a
    new array. One ``gossip_mix`` launch on a CUDA tensor (counted on
    ``gossip_mix.launches``; a ragged length is handled in the launch), the
    plain version on a CPU tensor."""
    flat = gossip_mix_out(a.contiguous().view(-1), b.contiguous().view(-1),
                          alpha)
    return flat.view(a.shape)


def gossip_mix_tree(a, b, alpha: float = 0.5):
    """Per-leaf mix of two param trees (one ``gossip_mix_flat`` per leaf):
    the per-leaf engines' ``mix_impl`` signature ``(local, received,
    alpha)``."""
    return tree_map(lambda x, y: gossip_mix_flat(x, y, alpha=alpha), a, b)


def _check_bucket(x: torch.Tensor) -> None:
    if x.shape[-1] % LANE:
        raise ValueError(f"bucket {tuple(x.shape)} is not LANE-aligned")


def _codes(payload):
    """``(partner, scales)`` of a wire payload (scales None when raw)."""
    if isinstance(payload, dict):
        return payload["q"], payload["s"]
    return payload, None


def gossip_mix_bucket(a: torch.Tensor, payload, alpha=0.5) -> torch.Tensor:
    """Mix one persistent gossip bucket in place against an arrived wire
    payload (any leading axes, e.g. the replica axis, over the LANE-aligned
    flat dim): one ``gossip_mix`` launch for a raw tensor, one
    ``gossip_mix_q`` launch for a quantized dict, over the whole
    replica-stacked bucket. Returns ``a``."""
    _check_bucket(a)
    if not isinstance(payload, dict):
        return gossip_mix_1d(a, payload, alpha)
    n = a.shape[-1]
    gossip_mix_q2d(a.view(-1, n), payload["q"].view(-1, n),
                   payload["s"].view(-1, n // LANE), alpha)
    return a


def fused_sgd_bucket(p, g, partner, mom, *, lr, alpha=0.5, momentum=0.9,
                     weight_decay=0.0):
    """Single-sweep fused mix+SGD over one bucket, in place over ``p`` and
    ``mom`` (one launch for the replica-stacked bucket). ``partner`` is a
    wire payload or None. Returns ``(p, mom)``."""
    _check_bucket(p)
    partner, scales = _codes(partner)
    return fused_sgd_1d(p, g, partner, mom, lr=lr, alpha=alpha,
                        momentum=momentum, weight_decay=weight_decay,
                        partner_scales=scales)


def fused_adamw_bucket(p, g, partner, m, v, *, lr, c1, c2, alpha=0.5, b1=0.9,
                       b2=0.95, eps=1e-8, weight_decay=0.0):
    """Single-sweep fused mix+AdamW over one bucket, in place over ``p`` and
    the fp32 ``m``, ``v`` (one launch for the replica-stacked bucket).
    ``partner`` is a wire payload or None. Returns ``(p, m, v)``."""
    _check_bucket(p)
    partner, scales = _codes(partner)
    return fused_adamw_1d(p, g, partner, m, v, lr=lr, c1=c1, c2=c2,
                          alpha=alpha, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay, partner_scales=scales)


def fused_lars_bucket(p, g, partner, mom, row_scale, *, lr, alpha=0.5,
                      momentum=0.9, weight_decay=0.0):
    """Single-sweep fused mix+LARS over one bucket with the per-row trust
    scale of the norm prepass, in place over ``p`` and the fp32 ``mom``
    (one launch for the replica-stacked bucket). ``partner`` is a wire
    payload or None; codes are decoded to fp32 before the sweep. Returns
    ``(p, mom)``."""
    _check_bucket(p)
    if isinstance(partner, dict):
        partner = dequant_flat(partner["q"], partner["s"])
    return fused_lars_1d(p, g, partner, mom, row_scale, lr=lr, alpha=alpha,
                         momentum=momentum, weight_decay=weight_decay)


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, chunk: int = 128,
             block_d: int = 256) -> torch.Tensor:
    """(B,S,D,N) fp32 selective scan through the ``ssm_scan`` kernel, the
    Mamba mixer's ``scan_impl`` hook. The reference pads S to a ``chunk``
    multiple and D to a ``block_d`` multiple for its TPU tiling and crops
    after; the Hopper kernel walks all of S in each thread and takes any D,
    so nothing is padded or cropped here: the whole of S and D goes to
    ``ssm_scan_chunked`` as one chunk and one block, and the two tile sizes
    (kept so that callers of the reference's signature run unchanged) are
    unused."""
    del chunk, block_d
    return ssm_scan_chunked(dA, dBx, chunk=None, block_d=None)


def flash_mha(q, k, v, *, causal=True, window=None, block_q=128,
              block_k=128):
    """(B,H,S,d) x (B,H,T,d) flash attention (full heads): one
    ``flash_attention`` launch per call on the card."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)
