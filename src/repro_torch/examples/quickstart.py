"""Quickstart: GossipGraD in a few lines.

Port of the reference's ``examples/quickstart.py``. Trains 8 simulated
data-parallel replicas of a small qwen3-family LM with the paper's
protocol (dissemination gossip + partner rotation) and shows the two
quantities the paper is about:

  * loss, which matches the all-reduce baseline (``--protocol agd``);
  * replica variance: gossip keeps the independently updated replicas
    converging to ONE model (Corollary 6.3), at O(1) communication a step.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--protocol gossip] [--steps 120] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import build_schedule, make_sim_train_step, replicate
from repro_torch.data import BigramTaskDataset
from repro_torch.device import resolve_device
from repro_torch.examples.gossip_vs_agd import tiny_lm_cfg
from repro_torch.models import lm_init
from repro_torch.optim import sgd
from repro_torch.train import make_loss_fn

__all__ = ["main"]


def main(argv=None) -> dict:
    """Run the example; returns ``final_loss``, ``replica_variance`` and the
    printed ``history``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", default="gossip",
                    choices=["gossip", "agd", "every_logp", "none"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tiny_lm_cfg()
    p = args.replicas

    # the paper's schedule: dissemination partners, rotated every log2(p)
    schedule = build_schedule(p, topology="dissemination", num_rotations=2)
    print(f"gossip schedule: p={p}, {schedule.substeps} sub-steps/round, "
          f"period {schedule.period}")

    loss_fn = make_loss_fn(cfg)
    opt = sgd(0.3, momentum=0.9)
    step = make_sim_train_step(lambda q, b: loss_fn(q, b)[0], opt, schedule,
                               protocol=args.protocol)

    params = replicate(lm_init(cfg, seed=0, device=dev), p)
    opt_state = opt.init(params)
    task = BigramTaskDataset(cfg.vocab, seed=7)

    history = []
    for t in range(args.steps):
        rng = np.random.default_rng(t)
        toks = np.stack([task.sample(rng, 4, 33) for _ in range(p)])
        opt_state, params, m = step(opt_state, params,
                                    {"tokens": torch.from_numpy(toks).to(dev)},
                                    t)
        if t % 10 == 0:
            history.append((t, float(m["loss"]),
                            float(m["replica_variance"])))
            print(f"step {t:4d}  loss {history[-1][1]:.4f}  "
                  f"replica_var {history[-1][2]:.3e}")
    final = {"final_loss": float(m["loss"]),
             "replica_variance": float(m["replica_variance"]),
             "history": history}
    print(f"final: loss {final['final_loss']:.4f}  "
          f"replica_var {final['replica_variance']:.3e} "
          f"({args.protocol})")
    return final


if __name__ == "__main__":
    main()
