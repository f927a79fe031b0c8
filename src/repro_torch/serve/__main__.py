"""Batched serving from the command line: prefill a batch of prompts, then
greedy-decode, through ``ServingEngine`` (port of
``examples/serve_batched.py``, with its stub flows: seeded image
embeddings for llava, seeded audio frames for whisper).

    PYTHONPATH=src python -m repro_torch.serve [--arch ARCH] [--device cpu]

The model is the arch's reduced variant in fp32 with random weights from
seed 0; ``--device`` defaults to cuda and raises without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm_init, reduced
from repro_torch.serve import ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    base = get_config(args.arch)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(reduced(base), param_dtype="float32",
                              compute_dtype="float32")
    params = lm_init(cfg, seed=0, device=dev)
    engine = ServingEngine(cfg, params, max_seq=256, device=dev)

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
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens, **kw)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new_tokens}")
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s incl. first call)")
    print("first row:", out[0].tolist())


if __name__ == "__main__":
    main()
