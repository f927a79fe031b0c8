"""Minimal batched serving engine (what the CLI runs).

Port of ``repro/serve/engine.py``. Greedy decoding over a fixed request
batch: one prefill, then single-token decode steps, through the same
``lm_prefill`` / ``lm_decode`` the serve steps run (``serve/step.py``). The
reference jits both; here they run eagerly under ``torch.inference_mode``.
Tokens and positions stay on the device through the loop (no ``.item()``),
and the tokens come back to the host in one transfer after it.

On one device by default; over a process mesh with ``dist`` and ``group``
(a ``core.replica_group.ReplicaGroup``), as the serve steps run there: the
rank's pieces of the weights gathered once into its serving weights
(``serve.step.rank_serving_params``), its cache from
``serve.step.rank_cache_init``, the steps under ``use_distribution(dist,
group, seq)`` (the MoE layers' experts split over the model group). Where
the batch splits over the batch group the rank serves its rows and every
step's logits are gathered over the group; where it does not (batch 1),
every rank serves every row over its stretch of the sequence-parallel
cache (``serve.step.seq_shards``). Either way every rank returns the
global greedy tokens.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist_ctx import use_distribution
from repro_torch.models import lm_decode, lm_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

from .step import (global_logits, local_rows, rank_cache_init,
                   rank_serving_params, seq_shards)

__all__ = ["ServingEngine"]


class ServingEngine:
    """``params`` is one replica's tree (``lm_init``'s), moved to
    ``device`` (default cuda, which raises without a card). Under a
    ``group`` (with the plan ``dist`` it was joined with) ``params`` are
    the rank's pieces of that tree (``serve.step.serve_pieces(cfg,
    dist).cut_pieces(tree, group.shard)``), gathered here once."""

    def __init__(self, cfg: ModelConfig, params: Any, max_seq: int,
                 device="cuda", dist=None, group=None):
        if group is not None and dist is None:
            raise ValueError("a group serves under the plan it was joined "
                             "with: pass dist=")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dist, self.group = dist, group
        params = tree_map(lambda w: w.to(self.device), params)
        self.params = (params if group is None
                       else rank_serving_params(cfg, dist, params, group))
        self.max_seq = max_seq

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 image_embeds: Optional[np.ndarray] = None,
                 audio_frames: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts (B, S_prompt) int -> (B, max_new_tokens) int32 greedy
        tokens. A VLM's ``image_embeds`` (B, n_image_tokens, d) are
        prefilled ahead of the prompt, so decode starts at S + n_img; an
        enc-dec model's ``audio_frames`` (B, n_frames, d) run through the
        encoder once, in prefill."""
        B, S = prompts.shape
        n_img = self.cfg.vision.n_image_tokens if (
            self.cfg.vision is not None and image_embeds is not None) else 0
        assert S + n_img + max_new_tokens <= self.max_seq, "cache too small"
        dev, group = self.device, self.group

        def rows(x):   # this rank's rows of a global input
            return None if x is None else local_rows(
                torch.as_tensor(x).to(dev), group)

        seq = seq_shards(self.cfg, self.dist, group, B, self.max_seq)
        with torch.inference_mode(), use_distribution(self.dist, group, seq):
            toks = rows(np.asarray(prompts, dtype=np.int64))
            cache = rank_cache_init(self.cfg, self.dist, group, B,
                                    self.max_seq, device=dev)
            pos = torch.full((), S + n_img, dtype=torch.int64, device=dev)
            logits, cache = lm_prefill(
                self.params, self.cfg, toks, cache,
                image_embeds=rows(image_embeds),
                audio_frames=rows(audio_frames))
            out = []
            tok = global_logits(logits, group, B).argmax(-1)
            for t in range(max_new_tokens):
                out.append(tok)
                logits, cache = lm_decode(self.params, self.cfg,
                                          local_rows(tok, group), cache,
                                          pos + t)
                tok = global_logits(logits, group, B).argmax(-1)
            return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
