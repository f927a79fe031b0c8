#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Imports nothing of JAX or of the reference
package ``repro``. Phases, each of which fails the run on any error:

1. builds the hand-written kernels (one nvcc per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card at the
   main path's bucket shapes (the smallest and the largest bucket of
   full-width qwen3-0.6b at dp=4, fp32 and bf16, alpha 0.5 and 0 static and
   0.25 as a tensor): bit equality expected. Times kernel, plain version,
   the PyTorch yardstick and the bound, and the fused sweep over all buckets;
3. main path: full-width qwen3-0.6b in bf16, 4 gossip replicas stacked on
   the card, packed + fused sync gossip, seq 256, 2 sequences per replica,
   8 steps (two periods of the dp=4 schedule), through
   make_train_step_bundle / init_train_state / Trainer, with the kernels'
   launch counts reset before and read after; then one more step under
   torch.profiler for the device's busy time;
4. the same engine at a small fp32 size on the card and on the CPU (plain
   versions) from one init: the trajectories agree (rtol = atol = 2e-4);
5. ``fused_update=False`` at full width and 2 layers, 4 steps, so the mix
   kernel runs on the path.

Prints the kernels' JSON line, the card's name and power limit, and last
the line ``{"ok": true, "device": {...}}``. Exits non-zero on any failure.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: device memory
FP32_FLOPS_PER_S = 67e12       # and fp32 outside the tensor cores
DP, SEQ, PER_REPLICA = 4, 256, 2
MAIN_STEPS, UNFUSED_STEPS, UNFUSED_LAYERS = 8, 4, 2
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4   # kernel checks


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for name in _build.SOURCES:
        lib = _build.lib_path(name)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(n, dtype, gen, dev):
    mk = lambda s: (torch.randn((DP, n), generator=gen, device=dev) * s).to(dtype)
    return mk(1.0), mk(0.1), mk(1.0), mk(0.1)  # p, g, partner, mom


def phase_kernels(layout, dev):
    """Bit equality with the plain versions at the main path's shapes, and
    timings at the largest bucket in the main path's dtype."""
    from repro_torch.kernels import (fused_sgd_bucket, fused_sgd_plain,
                                     gossip_mix_bucket, gossip_mix_plain)
    sizes = (min(layout.bucket_sizes), max(layout.bucket_sizes))
    alphas = (("0.5", 0.5), ("0", 0.0), ("tensor 0.25", torch.tensor(0.25)))
    err = {"gossip_mix": 0.0, "fused_sgd": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for n in sizes:
            p, g, b, m = _inputs(n, dtype, gen, dev)
            for an, alpha in alphas:
                want = gossip_mix_plain(p, b, alpha)
                got = gossip_mix_bucket(p.clone(), b, alpha)
                torch.cuda.synchronize()
                e_mix = (got.float() - want.float()).abs().max().item()
                eq_mix = torch.equal(got, want)
                del got, want
                wp, wm = fused_sgd_plain(p, g, b, m, lr=LR, alpha=alpha,
                                         momentum=MOMENTUM, weight_decay=WD)
                gp, gm = p.clone(), m.clone()
                fused_sgd_bucket(gp, g, b, gm, lr=LR, alpha=alpha,
                                 momentum=MOMENTUM, weight_decay=WD)
                torch.cuda.synchronize()
                e_sgd = max((gp.float() - wp.float()).abs().max().item(),
                            (gm.float() - wm.float()).abs().max().item())
                eq_sgd = torch.equal(gp, wp) and torch.equal(gm, wm)
                del gp, gm, wp, wm
                err["gossip_mix"] = max(err["gossip_mix"], e_mix)
                err["fused_sgd"] = max(err["fused_sgd"], e_sgd)
                log(f"[check] {str(dtype)[6:]} shape ({DP}, {n}) alpha {an}: "
                    f"gossip_mix equal={eq_mix} max_abs_err={e_mix} | "
                    f"fused_sgd equal={eq_sgd} max_abs_err={e_sgd}")
                assert eq_mix and eq_sgd, "kernel disagrees with its plain version"
            del p, g, b, m
            torch.cuda.empty_cache()

    # timings: the largest bucket in bf16 (the main path's), alpha 0.5
    # per element: the mix reads a and b and writes a (2 mul + 1 add); the
    # fused sweep reads p, g, partner and m and writes p and m (the mix, then
    # m = mu*m + g and p - lr*m: 7 operations with no weight decay)
    n = max(layout.bucket_sizes)
    p, g, b, m = _inputs(n, torch.bfloat16, gen, dev)
    elems = DP * n
    nbytes = elems * p.element_size()
    t = {
        "gossip_mix": dict(
            ms=time_ms(lambda: gossip_mix_bucket(p, b, 0.5)),
            plain_ms=time_ms(lambda: gossip_mix_plain(p, b, 0.5)),
            library_ms=time_ms(lambda: p.lerp_(b, 0.5)),
            **bound(3 * nbytes, 3 * elems)),
        "fused_sgd": dict(
            ms=time_ms(lambda: fused_sgd_bucket(p, g, b, m, lr=LR, alpha=0.5)),
            plain_ms=time_ms(lambda: fused_sgd_plain(p, g, b, m, lr=LR,
                                                     alpha=0.5)),
            library_ms=None,
            **bound(6 * nbytes, 7 * elems)),
    }
    for k, v in t.items():
        log(f"[time] {k} bf16 ({DP}, {n}): " + json.dumps(v))
    del p, g, b, m
    torch.cuda.empty_cache()

    # the fused sweep of one full step: every bucket of the layout, bf16
    bufs = [_inputs(s, torch.bfloat16, gen, dev) for s in layout.bucket_sizes]

    def sweep():
        for p_, g_, b_, m_ in bufs:
            fused_sgd_bucket(p_, g_, b_, m_, lr=LR, alpha=0.5)

    total = sum(DP * s for s in layout.bucket_sizes)
    sweep_ms = time_ms(sweep, reps=5, warmup=1)
    log(f"[time] fused_sgd sweep over all {layout.num_buckets} buckets bf16 "
        f"dp={DP}: " + json.dumps({"ms": sweep_ms,
                                   **bound(6 * 2 * total, 7 * total)}))
    del bufs, sweep
    torch.cuda.empty_cache()
    return err, t


def _train(cfg, *, fused, steps, dev, params=None, dp=DP, seq=SEQ,
           per_replica=PER_REPLICA):
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    opt = sgd(step_decay(0.1, 0.1, max(steps // 3, 1)), momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=dp, protocol="gossip",
                                    gossip_packed=True, fused_update=fused,
                                    device=dev)
    state = init_train_state(cfg, opt, dp=dp, packed=True,
                             layout=bundle.layout, seed=0, params=params,
                             device=dev)
    ds = ShardedTokenDataset(cfg.vocab, seq, n_shards=dp,
                             batch_per_shard=per_replica)
    return bundle, Trainer(bundle, state, ds, log_every=0)


def _reset_counts():
    from repro_torch.kernels import fused_update, gossip_mix
    gossip_mix.launches.reset()
    fused_update.launches.reset()


def _counts():
    from repro_torch.kernels import fused_update, gossip_mix
    return {"gossip_mix": gossip_mix.launches.count,
            "fused_sgd": fused_update.launches.count}


def _finite_buckets(trainer) -> bool:
    return all(bool(torch.isfinite(b).all()) for b in
               trainer.state["params"].buckets)


def phase_main(cfg, dev):
    bundle, tr = _train(cfg, fused=True, steps=MAIN_STEPS, dev=dev)
    assert bundle.fused and bundle.protocol.period == 4
    nb = bundle.layout.num_buckets
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tr.run(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = tr.run(MAIN_STEPS - 1, start_step=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    losses = [h["loss"] for h in hist]
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "dp": DP, "seq": SEQ, "per_replica": PER_REPLICA,
           "num_buckets": nb, "losses": losses,
           "first_step_ms": (t1 - t0) * 1e3,
           "ms_per_step": (t2 - t1) * 1e3 / (MAIN_STEPS - 1),
           "tokens_per_s": DP * PER_REPLICA * SEQ * (MAIN_STEPS - 1) / (t2 - t1),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    log("[main] " + json.dumps(res))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    assert counts["fused_sgd"] == MAIN_STEPS * nb, counts
    assert counts["gossip_mix"] == 0, counts
    assert _finite_buckets(tr), "non-finite parameters"
    profile_step(tr, res["ms_per_step"])
    del tr, bundle
    torch.cuda.empty_cache()
    return counts


def profile_step(tr, ms_per_step: float) -> None:
    """One more main-path step under torch.profiler, after the counted
    window. Device busy time is the sum of the kernels (device-side events
    only: an operator's row repeats its kernels' time); the idle share is
    taken against the step time measured without the profiler, which slows
    the host. Also times the host's synthetic batch for one step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import make_replica_batches
    step = len(tr.history)
    t0 = time.perf_counter()
    make_replica_batches(tr.dataset, step, tr.bundle.dp)
    batch_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(1, start_step=step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log("[profile] " + json.dumps({
        "device_busy_ms": busy_ms, "step_ms_unprofiled": ms_per_step,
        "idle_share": 1.0 - busy_ms / ms_per_step,
        "profiled_wall_ms": wall_ms,
        "device_ops_per_step": sum(r[2] for r in rows),
        "host_batch_ms": batch_ms}))
    for name, ms, count in rows[:12]:
        log(f"[profile] {ms:9.3f} ms  x{count:<5d} {name[:90]}")


def phase_agree(dev):
    """Small fp32 run on the card (kernels) and on the CPU (plain versions)
    from one init: both trajectories of the fused engine agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init, reduced
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype="float32", compute_dtype="float32")
    init = lm_init(cfg, seed=0, device="cpu")
    out = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t, d=d: t.to(d), init)
        _, tr = _train(cfg, fused=True, steps=4, dev=d, params=params,
                       seq=16, per_replica=2)
        losses = [h["loss"] for h in tr.run(4)]
        out[str(d)] = (losses, [b.detach().cpu() for b in
                                tr.state["params"].buckets])
    (lc, bc), (lg, bg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(lg, lc, rtol=2e-4, atol=2e-4)
    for a, b in zip(bg, bc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    log("[agree] card vs cpu losses " + json.dumps({"cuda": lg, "cpu": lc}))


def phase_unfused(cfg, dev):
    cfg2 = dataclasses.replace(cfg, blocks=cfg.blocks[:UNFUSED_LAYERS])
    bundle, tr = _train(cfg2, fused=False, steps=UNFUSED_STEPS, dev=dev)
    assert not bundle.fused
    nb = bundle.layout.num_buckets
    _reset_counts()
    t0 = time.perf_counter()
    hist = tr.run(UNFUSED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    losses = [h["loss"] for h in hist]
    log("[unfused] " + json.dumps({"layers": UNFUSED_LAYERS, "num_buckets": nb,
                                   "losses": losses,
                                   "ms_per_step": dt * 1e3 / UNFUSED_STEPS,
                                   "launches": counts}))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert counts["gossip_mix"] == UNFUSED_STEPS * nb, counts
    assert counts["fused_sgd"] == 0, counts
    assert _finite_buckets(tr), "non-finite parameters"
    del tr, bundle
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import build_layout
    from repro_torch.models import lm_specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    cfg = get_config("qwen3-0.6b")
    layout = build_layout(lm_specs(cfg))
    err, timing = phase_kernels(layout, dev)
    main_counts = phase_main(cfg, dev)
    phase_agree(dev)
    unfused_counts = phase_unfused(cfg, dev)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(name="fused_sgd", route="cuda", source=src + "fused_sgd.cu",
             replaces="src/repro/kernels/fused_update.py:233",
             path="fused (main)", launches=main_counts["fused_sgd"],
             max_abs_err=err["fused_sgd"], **timing["fused_sgd"]),
        dict(name="gossip_mix", route="cuda", source=src + "gossip_mix.cu",
             replaces="src/repro/kernels/gossip_mix.py:83",
             path="unfused (--no-fused-update)",
             launches=unfused_counts["gossip_mix"],
             max_abs_err=err["gossip_mix"], **timing["gossip_mix"]),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
