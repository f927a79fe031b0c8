"""GossipGraD against AGD and every-log(p) on the same model and data: the
paper's Figs 12-14/17 experiment as a runnable script.

Port of the reference's ``examples/gossip_vs_agd.py``, with its own copy of
the replica-LM runner the reference takes from ``benchmarks/common.py``
(``tiny_lm_cfg``, ``parse_async_protocol``, ``make_replica_lm``,
``run_replica_lm``): p replicas stacked on one device through the port's
simulator (``core/simulate.py``), trained on p bigram shards with ring
rotation. On a cluster, ``python -m repro_torch.launch.train`` runs the
same protocols through the engines instead.

    PYTHONPATH=src python -m repro_torch.examples.gossip_vs_agd \\
        --steps 150 --protocols gossip,agd [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (build_schedule, make_async_sim_train_step,
                              make_sim_train_step, replicate)
from repro_torch.core.async_gossip import init_inbox_ring
from repro_torch.data import BigramTaskDataset
from repro_torch.device import resolve_device
from repro_torch.models import lm_init, reduced
from repro_torch.optim import sgd
from repro_torch.train import make_loss_fn

__all__ = ["main"]

_WIRE_SUFFIXES = {"8": "int8", "f8": "fp8", "b16": "bf16"}


def tiny_lm_cfg(d_model=64, vocab=128):
    """The examples' model: qwen3-0.6b reduced to ``d_model`` and ``vocab``,
    in fp32."""
    cfg = reduced(get_config("qwen3-0.6b"), d_model=d_model, vocab=vocab)
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def parse_async_protocol(protocol: str):
    """``gossip_async[_k<K>][_drop<PCT>][_q<WIRE>][_sub<PCT>]`` ->
    (staleness, drop_rate, wire_dtype, gossip_subset), or None for a
    protocol that is not async. ``_q8`` int8, ``_qf8`` fp8, ``_qb16`` bf16
    (no suffix: fp32); ``_sub<PCT>`` sends a rotating PCT% bucket subset."""
    m = re.fullmatch(r"gossip_async(?:_k(\d+))?(?:_drop(\d+))?"
                     r"(?:_q(8|f8|b16))?(?:_sub(\d+))?", protocol)
    if not m:
        return None
    return (int(m.group(1) or 1), int(m.group(2) or 0) / 100.0,
            _WIRE_SUFFIXES.get(m.group(3), "fp32"),
            int(m.group(4) or 100) / 100.0)


def make_replica_lm(p: int, protocol: str, *, lr=0.3, seed=0,
                    num_rotations=2, device="cuda"):
    """``(cfg, step, params, opt_state)``: ``gossip_async*`` protocols take
    the bounded-delay step ``step(opt_state, params, ring, batch, t)``,
    every other the synchronous ``step(opt_state, params, batch, t)``."""
    dev = resolve_device(device)
    cfg = tiny_lm_cfg()
    one = lm_init(cfg, seed=seed, device=dev)
    loss_fn_full = make_loss_fn(cfg)

    def loss_fn(prms, batch):
        return loss_fn_full(prms, batch)[0]

    sched = build_schedule(max(p, 2), num_rotations=num_rotations, seed=seed)
    opt = sgd(lr, momentum=0.9)
    async_kd = parse_async_protocol(protocol)
    if async_kd is not None:
        k, drop, wire_dtype, subset = async_kd
        step = make_async_sim_train_step(loss_fn, opt, sched, staleness=k,
                                         drop_rate=drop, drop_seed=seed,
                                         wire_dtype=wire_dtype,
                                         gossip_subset=subset,
                                         wire_seed=seed)
    else:
        step = make_sim_train_step(loss_fn, opt, sched, protocol=protocol)
    stacked = replicate(one, p)
    return cfg, step, stacked, opt.init(stacked)


def run_replica_lm(p: int, protocol: str, steps: int, *, seq_len=32,
                   batch_per_replica=4, lr=0.3, seed=0, device="cuda"
                   ) -> Tuple[List[Dict], float]:
    """``(history, wall_seconds)``: batches from p distinct bigram shards
    with ring rotation (the paper's sample shuffle); the first step runs
    outside the timed region and the history."""
    dev = resolve_device(device)
    cfg, step, stacked, opt_state = make_replica_lm(
        p, protocol, lr=lr, seed=seed, device=dev)
    task = BigramTaskDataset(cfg.vocab, seed=seed + 991)
    async_kd = parse_async_protocol(protocol)
    inbox = (init_inbox_ring(stacked, async_kd[0], p)
             if async_kd is not None else None)

    def batch_for(t):
        toks = np.stack([
            task.sample(np.random.default_rng(
                ((seed * 7 + ((r - t) % p)) * 1_000_003 + t)),
                batch_per_replica, seq_len + 1)
            for r in range(p)])
        return {"tokens": torch.from_numpy(toks).to(dev)}

    def one(t, opt_state, stacked, inbox):
        if inbox is not None:
            opt_state, stacked, inbox, m = step(opt_state, stacked, inbox,
                                                batch_for(t), t)
        else:
            opt_state, stacked, m = step(opt_state, stacked, batch_for(t), t)
        return opt_state, stacked, inbox, m

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    opt_state, stacked, inbox, m = one(0, opt_state, stacked, inbox)
    sync()
    hist = []
    t0 = time.perf_counter()
    for t in range(1, steps):
        opt_state, stacked, inbox, m = one(t, opt_state, stacked, inbox)
        hist.append({k: float(v) for k, v in m.items()} | {"step": t})
    sync()
    return hist, time.perf_counter() - t0


def main(argv=None) -> dict:
    """Run the example; returns the per-protocol results the reference
    prints as JSON."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--protocols",
                    default="gossip,gossip_async,gossip_async_k4,"
                    "gossip_async_k2_drop20,gossip_async_k2_q8,"
                    "gossip_async_k2_sub50,agd,every_logp",
                    help="comma list; gossip_async[_k<K>][_drop<PCT>]"
                    "[_q<WIRE>][_sub<PCT>] is the bounded-delay inbox-ring "
                    "protocol: a staleness-K ring (default 1) with PCT%% "
                    "injected skip-on-timeout drops; _q8/_qf8/_qb16 ship "
                    "int8/fp8/bf16 payloads, _sub<PCT> a rotating PCT%% "
                    "bucket subset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results = {}
    for proto in args.protocols.split(","):
        t0 = time.perf_counter()
        hist, wall = run_replica_lm(args.replicas, proto, args.steps,
                                    seq_len=32, batch_per_replica=4,
                                    lr=0.3, seed=1, device=dev)
        tail = float(np.mean([h["loss"] for h in hist[-10:]]))
        results[proto] = {
            "final_loss": tail,
            "replica_variance": hist[-1]["replica_variance"],
            "steps_per_s": len(hist) / wall,
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(f"{proto:12s} loss={tail:.4f} "
              f"var={hist[-1]['replica_variance']:.2e} "
              f"steps/s={results[proto]['steps_per_s']:.2f}")

    if "gossip" in results and "agd" in results:
        gap = abs(results["gossip"]["final_loss"]
                  - results["agd"]["final_loss"])
        speed = (results["gossip"]["steps_per_s"]
                 / results["agd"]["steps_per_s"])
        print(f"\ngossip-vs-agd: loss gap {gap:.4f} (paper: matches within "
              f"noise), relative step rate {speed:.2f}x")
    if "gossip" in results and "gossip_async" in results:
        gap = abs(results["gossip"]["final_loss"]
                  - results["gossip_async"]["final_loss"])
        drift = (results["gossip_async"]["replica_variance"]
                 / max(results["gossip"]["replica_variance"], 1e-12))
        print(f"async-vs-sync gossip: loss gap {gap:.4f}, drift ratio "
              f"{drift:.2f}x (staleness-1 stays bounded, §5)")
    wired = [(p, r) for p, r in results.items()
             if p.startswith("gossip_async") and ("_q" in p or "_sub" in p)]
    stale = [(p, r) for p, r in results.items()
             if p.startswith("gossip_async") and p != "gossip_async"
             and (p, r) not in wired]
    if "gossip" in results and stale:
        for proto, r in stale:
            gap = abs(results["gossip"]["final_loss"] - r["final_loss"])
            drift = (r["replica_variance"]
                     / max(results["gossip"]["replica_variance"], 1e-12))
            print(f"bounded-delay {proto}: loss gap {gap:.4f} vs sync, "
                  f"drift ratio {drift:.2f}x (accuracy holds under k>1 "
                  f"delay and skipped exchanges, §4.2)")
    if "gossip" in results and wired:
        for proto, r in wired:
            gap = abs(results["gossip"]["final_loss"] - r["final_loss"])
            drift = (r["replica_variance"]
                     / max(results["gossip"]["replica_variance"], 1e-12))
            print(f"compressed wire {proto}: loss gap {gap:.4f} vs sync, "
                  f"drift ratio {drift:.2f}x (convergence holds under "
                  f"quantized / partition-sampled exchanges)")
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
