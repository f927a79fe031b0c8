"""Next-token cross entropy plus the MoE load-balance aux and, with an MTP
head, the weighted multi-token-prediction CE, per replica.

Port of ``repro/train/loss.py`` (``cross_entropy``, ``make_loss_fn``).
The reference's loss is per replica under a ``vmap``; here it is a vector
over the leading replica axis, and the train step back-propagates its sum,
which gives every replica exactly the gradient of its own loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import lm_apply
from repro_torch.models.config import ModelConfig

__all__ = ["cross_entropy", "make_loss_fn"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE per replica in fp32: logits (dp, ..., V) of any float
    dtype, labels (dp, ...) int -> (dp,)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).flatten(1).mean(1)


def make_loss_fn(cfg: ModelConfig, ssm_scan_impl=None, remat: bool = False,
                 remat_policy: Optional[str] = None):
    """``loss_fn(params, batch) -> (loss (dp,), metrics)`` for params with a
    leading replica axis and ``batch["tokens"]`` of shape (dp, b, S+1), plus
    ``batch["image_embeds"]`` (dp, b, Ni, d) for a VLM and
    ``batch["audio_frames"]`` (dp, b, F, d) for an enc-dec model. The loss
    is ``ce + moe_aux``, plus ``cfg.mtp_coef * mtp_ce`` with an MTP head
    (``mtp_ce``: the head's logits at t against token t+2); the metrics
    ``ce``, ``moe_aux``, ``moe_dropped_frac``, ``mtp_ce`` (with MTP) and
    ``loss``, each (dp,). ``ssm_scan_impl``
    replaces the Mamba layers' scan; ``remat`` and ``remat_policy``
    checkpoint the layers (``lm_apply``)."""

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        tokens = batch["tokens"]
        logits, aux = lm_apply(params, cfg, tokens[..., :-1],
                               image_embeds=batch.get("image_embeds"),
                               audio_frames=batch.get("audio_frames"),
                               ssm_scan_impl=ssm_scan_impl, remat=remat,
                               remat_policy=remat_policy)
        ce = cross_entropy(logits, tokens[..., 1:])
        loss = ce + aux["moe_aux"]
        metrics = {"ce": ce, "moe_aux": aux["moe_aux"],
                   "moe_dropped_frac": aux["moe_dropped_frac"]}
        if cfg.mtp:
            mtp_ce = cross_entropy(aux["mtp_logits"], tokens[..., 2:])
            loss = loss + cfg.mtp_coef * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn
