"""Minimal batched serving engine (one device; what the CLI runs).

Port of ``repro/serve/engine.py``. Greedy decoding over a fixed request
batch: one prefill, then single-token decode steps, through the same
``lm_prefill`` / ``lm_decode`` the serve steps run (``serve/step.py``). The
reference jits both; here they run eagerly under ``torch.inference_mode``.
Tokens and positions stay on the device through the loop (no ``.item()``),
and the tokens come back to the host in one transfer after it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm_cache_init, lm_decode, lm_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

__all__ = ["ServingEngine"]


class ServingEngine:
    """``params`` is one replica's tree (``lm_init``'s), moved to
    ``device`` (default cuda, which raises without a card)."""

    def __init__(self, cfg: ModelConfig, params: Any, max_seq: int,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda w: w.to(self.device), params)
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
        dev = self.device
        with torch.inference_mode():
            cache = lm_cache_init(self.cfg, B, self.max_seq, device=dev)
            pos = torch.full((), S + n_img, dtype=torch.int64, device=dev)
            if image_embeds is not None:
                image_embeds = torch.as_tensor(image_embeds).to(dev)
            if audio_frames is not None:
                audio_frames = torch.as_tensor(audio_frames).to(dev)
            logits, cache = lm_prefill(
                self.params, self.cfg,
                torch.as_tensor(prompts, dtype=torch.int64).to(dev), cache,
                image_embeds=image_embeds, audio_frames=audio_frames)
            out = []
            tok = logits.argmax(-1)
            for t in range(max_new_tokens):
                out.append(tok)
                logits, cache = lm_decode(self.params, self.cfg, tok, cache,
                                          pos + t)
                tok = logits.argmax(-1)
            return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
