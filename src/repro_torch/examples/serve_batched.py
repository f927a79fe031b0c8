"""Batched serving example: prefill a batch of prompts, then greedy-decode,
through the same ``lm_prefill`` / ``lm_decode`` the ``decode_32k`` /
``long_500k`` dry-run shapes trace. Includes the VLM and audio stub
frontends.

Port of the reference's ``examples/serve_batched.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        [--arch qwen3-0.6b] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import lm_init, reduced
from repro_torch.serve import ServingEngine

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the example; returns the generated ``tokens`` (B, new) and
    ``tok_per_s``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(reduced(get_config(args.arch)),
                              param_dtype="float32", compute_dtype="float32")
    engine = ServingEngine(cfg, lm_init(cfg, seed=0, device=dev), max_seq=256,
                           device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    kw = {}
    if cfg.vision is not None:
        kw["image_embeds"] = rng.normal(
            size=(args.batch, cfg.vision.n_image_tokens, cfg.d_model)
        ).astype(np.float32) * 0.02
    if cfg.encoder is not None:
        kw["audio_frames"] = rng.normal(
            size=(args.batch, cfg.encoder.n_frames, cfg.d_model)
        ).astype(np.float32) * 0.02

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens, **kw)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens}")
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    print("first row:", out[0].tolist())
    return {"tokens": out, "tok_per_s": args.batch * args.new_tokens / dt}


if __name__ == "__main__":
    main()
