#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card and nvcc. Imports nothing of JAX or of the reference
package ``repro``. Phases, each of which fails the run on any error:

1. ``[build]`` builds the hand-written kernels (one nvcc per source, in
   parallel), and proves that ``flash_attention``'s products run on the
   tensor cores: for each kernel of its library the registers and spill
   bytes ptxas reports and the count of HGMMA (``wgmma``) instructions in
   ``cuobjdump -sass``; a spill anywhere, or a ``flash_kernel``
   instantiation with no HGMMA, fails the run, and so does a missing
   ``cuobjdump``.
2. ``[check]`` holds each kernel against its plain PyTorch version on the
   card at the smallest and the largest bucket of full-width qwen3-0.6b at
   dp=4, fp32 and bf16: the raw mix and fused SGD sweep (alpha 0.5 and 0
   static, 0.25 as a () tensor, one alpha per replica row), a bf16 partner
   on an fp32 bucket, and ``gossip_mix_q`` and the scaled fused sweep on
   int8 and fp8 wire codes. Bit equality expected. Also the wire encode on
   the card against the CPU, bit for bit. ``[check_opt]`` does the same
   for ``fused_adamw`` (raw, int8, fp8 and no partner) and ``fused_lars``
   (bf16, fp32 and no partner) on the largest bucket, static, () and
   per-row alpha.
3. ``[time]`` and ``[time_opt]`` time each kernel, its plain version, the
   PyTorch yardstick and the bound at the largest bucket in bf16 (the mix
   kernels, static and per-row alpha, and ``torch.lerp_`` in 7 interleaved
   rounds: median, min and max, and the share of the bound), the fused
   SGD sweep over all buckets, the int8 wire encode (per bucket and per
   step), ``torch._fused_adamw_`` for orientation, and the LARS norm
   prepass (largest bucket and per step).
4. ``[main]`` the first slice's path: full-width qwen3-0.6b in bf16, 4
   gossip replicas stacked on the card, packed + fused sync gossip with
   sgd, seq 256, 2 sequences per replica, 8 steps, with the kernels'
   launch counts reset before and read after, then one protocol period
   timed and one profiled (``[profile main]``).
5. ``[async_wire]`` the second slice's path on the same model:
   ``gossip_async`` (staleness 2, drop 0.2) on the int8 wire with subset
   0.5, fused, 8 steps, launch counts checked, then profiled likewise.
6. ``[adamw_wire]`` and ``[lars_main]`` the third slice's paths on the
   same model, each 8 steps with launch counts checked and profiled
   likewise: adamw on the ``async_wire`` protocol, and lars on the
   ``main`` one (with the prepass's share of the step). ``[agd_main]`` and
   ``[every_logp_main]`` the paper's baselines on the same model, fused
   (``fused_sgd`` at alpha 0, 104 launches each): the replicas
   bit-identical after every step of agd and exactly after every_logp's
   averaging steps (phase + 1 a multiple of the substeps), the replica
   mean timed alone; both then timed and profiled like ``[main]``, and
   ``[baselines]`` prints the three paths' ms/step from this call.
7. At 2 layers, 4 steps each: ``[async_unfused]`` (the async ring unfused
   on the int8 wire; ``gossip_mix_q`` launches equal the count computed
   from ``selected(phase - k)``), ``[sync_fp8]`` (the sync fused engine on
   the fp8 wire), ``[adamw_sync]`` (sync fused), ``[lars_async]``
   (gossip_async int8 subset 0.5 fused, the partner decoded before the
   prepass), ``[adamw_unfused]`` (sync, tree-level update + ``gossip_mix``)
   and ``[lars_unfused]`` (gossip_async int8 subset 0.5, tree-level update
   + ``gossip_mix_q``). ``[ckpt]`` (sync fused) and ``[ckpt_async]``
   (``async_wire``'s protocol): two straight 8-step runs, then 4 steps,
   ``save_state`` into a ``tempfile.mkdtemp()``, ``restore_state`` into a
   fresh state drawn with another seed (bit-equal to what was saved), 4
   more steps held bit for bit against the straight run when the two
   straight runs are bit-equal, else within their difference; save and
   restore seconds, bytes on disk and GB/s; ``[ckpt_async]`` also restores
   the file into a staleness-4 ring (saved slots bit-equal, new ones
   invalid). The depth is cut for the disk: 2 layers write about 6 GB.
8. ``[agree]`` small fp32 models (5 buckets) on the card and on the CPU
   (plain versions) from one init: sgd sync fused, async int8 subset 0.5
   fused and unfused, sync bf16 wire unfused; adamw and lars sync fused,
   async int8 subset 0.5 fused and sync unfused. Trajectories agree within
   rtol = atol = 2e-4, except bucket elements one wire code step apart or,
   under AdamW, at most 2 * lr * steps apart (a gradient sign flipped at
   rounding level), at most 0.1% of them.
9. ``[unfused]`` sync ``fused_update=False`` with sgd at full width and 2
   layers, so the raw mix kernel runs on its path.
10. The forward-only kernels. ``[check_ssm]`` holds ``ssm_scan`` against its
    plain loop bit for bit at (2, 4096, 8192, 16) (falcon-mamba's scan at 2 x
    4096 tokens), a ragged (3, 1000, 100, 5) and S = 1. ``[check_attn]``
    holds ``flash_attention`` against its plain version
    ``flash_attention_plain`` (dense ``attention_ref``, and the reference's
    block rule for rows with no admissible key) at qwen3-0.6b's
    attention (16 heads after repeating the 8 KV heads, d 128): S = T =
    4096 causal, the same with window 1024, a non-causal S 1024 x T 4096,
    d 64 at S 512, and S 256 x T 128 with window 8 (rows 135-255 keyless),
    causal and not, at blocks (128, 128), (32, 32), (64, 128) and (128, 32),
    each in fp32 (rtol = atol = 2e-5, the reference's) and
    bf16 (one bf16 ulp of the plain output plus 2e-5), with
    ``torch.backends.cuda.matmul.allow_tf32`` logged and required False (the
    plain version's fp32 einsum would round to TF32); a block that does not
    divide S raises. ``[time_ssm]`` and ``[time_attn]`` time both against
    their plain versions, their bounds and, for attention, PyTorch's
    ``scaled_dot_product_attention`` (a yardstick the port never calls), at
    S = 4096 and 32768, and the keyless-rows case (S 256, T 128, window 8,
    blocks 32) against its plain version. Attention's bound prices each product at the
    split-pass rate of its operands on the tensor cores (``_attn_bound``);
    the kernels line's flash entry adds ``share_of_bound`` = bound / time.
11. ``[flash_path]`` one ``flash_mha`` call on q, k, v projected by a
    full-width bf16 qwen3-0.6b attention layer (RoPE, qk-norm, GQA
    repeated), S 4096: one launch, which the kernels line's flash entry
    times (the bf16 ``[time_attn]`` times ride beside as ``*_bf16`` keys). ``[mamba_eval]`` scores falcon-mamba-7b at
    full width and depth (64 layers, random bf16 weights from seed 0) on 2 x
    4096 tokens through ``make_loss_fn(cfg, ssm_scan_impl=ssm_scan)`` under
    ``no_grad``: 64 scan launches per forward, loss within 1 of ln(vocab),
    then profiled (``[profile mamba_eval]``). ``[mamba_agree]``: the same
    model at 2 layers gives bit-identical logits with the kernel and with
    the plain loop; a reduced fp32 falcon-mamba's logits on the card agree
    with the CPU's within rtol = atol = 2e-4.

12. The per-leaf engines, the launcher's default path: ``[leaf_main]``
    main's model (28 layers, 4 replicas, bf16, seq 256, 2 sequences a
    replica, sgd on step_decay) on the per-leaf sync ``gossip`` engine as
    the launcher runs it (the mix op by op in bf16, no hand kernel: 0
    launches), 8 steps, timed and profiled like ``[main]``;
    ``[leaf_kernel]`` the same run with ``mix_impl=gossip_mix_1d`` (8 x 13
    leaves launches), then its params against ``[leaf_main]``'s, bit for
    bit (the kernel mixes in fp32 and rounds once; in bf16 the two differ
    only where a product of the mix rounds, which at alpha 0.5 none does);
    ``[leaf_mix_check]`` ``gossip_mix_1d`` on each of the 13 full-width
    leaves against its plain version and the default per-leaf mix on the
    same inputs, bit for bit; ``[leaf_async]`` per-leaf ``gossip_async``
    (staleness 2, drop 0.2), profiled. ``[leaf_agree]``: at ``[agree]``'s
    size, per-leaf with the mix kernel against packed
    ``fused_update=False`` on the card, bit for bit. ``[sim_agree]``: the port's own
    oracle ``core.simulate`` on the card, ``make_sim_train_step`` against
    the per-leaf and packed unfused gossip, agd, every_logp and none
    engines and ``make_async_sim_train_step`` (k 2, drop 0.2) against the
    per-leaf and packed unfused async engines, bit for bit; the int8 wire
    at subset 0.5, the packed async engine against
    ``gossip_mix_sim_quantized_k`` step by step, bit for bit.

13. The shard-local (hierarchical) bucket layouts. ``[hier_main]``:
    ``[main]``'s model, optimizer, batches and 8 steps under the
    distribution plan of mesh (1, 4, 2) in ``replica`` mode (dp 4, each
    replica's leaves sharded over ``model`` in 2 shard-local pieces),
    counted and profiled like ``[main]``, with the layout (``num_shards``,
    buckets, strides) and ``unpack`` alone (device ms, GB assembled, its
    byte bound); its params after the 8 steps must equal ``[main]``'s bit
    for bit, and its losses too. ``[hier_fsdp]``: ``fsdp`` on (2, 2, 2)
    (dp 2 over the pods, 4 shards), qwen3-0.6b at full width with 2
    layers, ``async_wire``'s protocol fused, 4 steps, raw and scaled
    ``fused_sgd`` launches counted. ``[hier_agree]``: [agree]'s model on the
    (2, 2, 2) fsdp layout, sync fused and unfused, async int8 subset 0.5
    fused and unfused, adamw sync fused, card against CPU under [agree]'s
    rule and, on the fp32 wire, against the flat layout on the card bit
    for bit; the port's simulator against the shard-local packed unfused
    engines (sync, async k 2 drop 0.2) and the int8 ring against
    ``gossip_mix_sim_quantized_k`` on the shard-local buckets, bit for
    bit.

Prints each phase's wall seconds on the ``[done]`` line, the kernels' JSON
line, the card's name and power limit, and last the line ``{"ok": true,
"device": {...}}``. Exits non-zero on any failure.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet: device memory,
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # and bf16 on the tensor cores (dense)
DP, SEQ, PER_REPLICA = 4, 256, 2
MAIN_STEPS, SHORT_STEPS, SHORT_LAYERS = 8, 4, 2
LR, MOMENTUM, WD = 0.01, 0.9, 1e-4   # kernel checks
ASYNC_WIRE = dict(protocol="gossip_async", staleness=2, drop_rate=0.2,
                  wire_dtype="int8", gossip_subset=0.5)
AGREE_BUCKET_BYTES = 96 << 10        # 5 buckets for the small model
OPT_KERNELS = ("fused_adamw", "fused_adamw_q", "fused_lars")
KERNELS = ("gossip_mix", "gossip_mix_q", "fused_sgd", "fused_sgd_q") \
    + OPT_KERNELS + ("ssm_scan", "flash_attention")
SSM_SHAPE = (2, 4096, 8192, 16)   # falcon-mamba's scan at 2 x 4096 tokens
EVAL_B, EVAL_S, EVAL_FORWARDS = 2, 4096, 3   # train_4k's length
ATTN_S, ATTN_S_LONG = 4096, 32768            # and prefill_32k's
# learning rates on step_decay: the full-width paths, and the small agree
# runs (AdamW's as the CPU tests: tests/test_torch_optim.py)
FULL_LR = {"sgd": 0.1, "adamw": 0.01, "lars": 0.1}
AGREE_LR = {"sgd": 0.1, "adamw": 1e-3, "lars": 0.1}
ADAMW_WD, LARS_WD = 0.02, 1e-4


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


def rounds_ms(fns: dict, rounds: int = 7, reps: int = 10) -> dict:
    """Each of ``fns`` timed in ``rounds`` interleaved rounds (every one in
    turn, each time the mean of ``reps`` calls by ``time_ms``): the median,
    min and max over the rounds."""
    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ts[k].append(time_ms(fn, reps=reps, warmup=1))
    return {k: {"median": statistics.median(v), "min": min(v), "max": max(v)}
            for k, v in ts.items()}


def bound(nbytes: float, flops: float, ops_ms: float = None) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate, which is the fp32
    rate unless ``ops_ms`` gives their time at the rates of their types."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3 if ops_ms is None else ops_ms
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_build():
    """Builds every kernel; then proves that flash_attention's products run
    on the tensor cores: per instantiation, ptxas's registers and spill
    bytes and the count of HGMMA (wgmma) instructions in its SASS. Raises
    on a spill or an instantiation without HGMMA."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    for src in secs:
        for line in _build.lib_path(src).with_suffix(".log").read_text(
                ).splitlines():
            if "Used" in line and "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    src = "flash_attention.cu"
    report = _build.ptxas_report(src)
    hgmma = _build.sass_count(src, "HGMMA")
    bad, products = [], 0
    for fn, rep in report.items():
        m = re.search(r"flash_kernelILi(\d+)ELb([01])E", fn)
        name = (f"flash_kernel<{m.group(1)}, "
                f"{'fp32' if m.group(2) == '1' else '16-bit'} output>"
                if m else fn)
        row = dict(registers=rep["registers"],
                   spill_bytes=rep["spill_bytes"], hgmma=hgmma.get(fn, 0))
        log(f"[build] {src} {name}: {json.dumps(row)}")
        # the products run in flash_kernel; masked_rows_kernel (rows with no
        # admissible key) only sums v
        products += bool(m)
        if row["spill_bytes"] or (m and not row["hgmma"]):
            bad.append(name)
    if not products or bad:
        raise AssertionError(f"{src}: spills or no HGMMA in {bad or 'any'}")


def _inputs(n, dtype, gen, dev):
    mk = lambda s: (torch.randn((DP, n), generator=gen, device=dev) * s).to(dtype)
    return mk(1.0), mk(0.1), mk(1.0), mk(0.1)  # p, g, partner, mom


def _encode(x, code):
    from repro_torch.kernels.quantize import encode_wire, wire_key
    return encode_wire(x, code, keys=wire_key(0, np.arange(x.shape[0]), 0))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor on the CPU, one-byte codes as their raw bytes."""
    t = t.cpu()
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _diff(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def phase_kernels(layout, dev):
    """Bit equality with the plain versions at the main path's shapes."""
    from repro_torch.kernels import (fused_sgd_bucket, fused_sgd_plain,
                                     gossip_mix_bucket, gossip_mix_plain,
                                     gossip_mix_q_plain)
    row = torch.tensor([0.5, 0.0, 0.25, 0.5], device=dev)
    alphas = (("0.5", 0.5), ("0", 0.0), ("tensor 0.25",
                                         torch.tensor(0.25, device=dev)),
              ("per-row", row))
    err = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(kind, tag, an, got_want_pairs):
        e = max(_diff(g, w) for g, w in got_want_pairs)
        eq = all(torch.equal(g, w) for g, w in got_want_pairs)
        err[kind] = max(err[kind], e)
        log(f"[check] {kind} {tag} alpha {an}: equal={eq} max_abs_err={e}")
        assert eq, f"{kind} disagrees with its plain version"

    def mix_and_sweep(tag, p, g, b, m, wire_kinds, mix_plain):
        mix_kind, sgd_kind = wire_kinds
        scales = b["s"] if isinstance(b, dict) else None
        partner = b["q"] if isinstance(b, dict) else b
        for an, alpha in alphas:
            want = mix_plain(p, alpha)
            got = gossip_mix_bucket(p.clone(), b, alpha)
            torch.cuda.synchronize()
            check(mix_kind, tag, an, [(got, want)])
            del got, want
            wp, wm = fused_sgd_plain(p, g, partner, m, lr=LR, alpha=alpha,
                                     momentum=MOMENTUM, weight_decay=WD,
                                     partner_scales=scales)
            gp, gm = p.clone(), m.clone()
            fused_sgd_bucket(gp, g, b, gm, lr=LR, alpha=alpha,
                             momentum=MOMENTUM, weight_decay=WD)
            torch.cuda.synchronize()
            check(sgd_kind, tag, an, [(gp, wp), (gm, wm)])
            del gp, gm, wp, wm

    for dtype in (torch.float32, torch.bfloat16):
        for n in (min(layout.bucket_sizes), max(layout.bucket_sizes)):
            p, g, b, m = _inputs(n, dtype, gen, dev)
            tag = f"{str(dtype)[6:]} ({DP}, {n})"
            mix_and_sweep(tag, p, g, b, m, ("gossip_mix", "fused_sgd"),
                          lambda a_, al: gossip_mix_plain(a_, b, al))
            if dtype == torch.float32:  # a bf16 wire on an fp32 bucket
                b16 = b.to(torch.bfloat16)
                mix_and_sweep(tag + " bf16 partner", p, g, b16, m,
                              ("gossip_mix", "fused_sgd"),
                              lambda a_, al: gossip_mix_plain(a_, b16, al))
                del b16
            for code in ("int8", "fp8"):
                enc = _encode(b, code)
                mix_and_sweep(
                    f"{tag} {code} codes", p, g, enc, m,
                    ("gossip_mix_q", "fused_sgd_q"),
                    lambda a_, al: gossip_mix_q_plain(a_, enc["q"], enc["s"],
                                                      al))
                del enc
            # the wire encode itself: card against CPU on a row slice
            x = p[:, :min(n, 1 << 20)].contiguous()
            for code in ("int8", "fp8"):
                card, cpu = _encode(x, code), _encode(x.cpu(), code)
                eq = all(torch.equal(_bits(card[k]), _bits(cpu[k]))
                         for k in ("q", "s"))
                log(f"[check] encode {code} {tag} slice {tuple(x.shape)}: "
                    f"card equals cpu={eq}")
                assert eq, "the wire encode differs between card and CPU"
            del p, g, b, m, x
            torch.cuda.empty_cache()
    return err


def phase_time(layout, dev):
    """Kernel, plain and yardstick times at the largest bucket in bf16
    (the main path's dtype), the fused sweep over all buckets, and the
    int8 encode."""
    from repro_torch.core.gossip import wire_subset_of
    from repro_torch.kernels import (fused_sgd_bucket, fused_sgd_plain,
                                     gossip_mix_bucket, gossip_mix_plain,
                                     gossip_mix_q_plain)
    from repro_torch.kernels.quantize import WireFormat
    gen = torch.Generator(device=dev).manual_seed(1)
    n = max(layout.bucket_sizes)
    p, g, b, m = _inputs(n, torch.bfloat16, gen, dev)
    enc = _encode(b, "int8")
    q, s = enc["q"], enc["s"]
    row = torch.tensor([0.5, 0.5, 0.0, 0.5], device=dev)
    elems = DP * n
    tiles = elems / 128
    # per element: the raw mix reads a, b and writes a (2 mul + 1 add); the
    # q-mix reads a (2 B), a code (1 B) and a 128th of a scale, writes a
    # (decode mul + the mix); the fused sweep reads p, g, partner, m and
    # writes p, m (the mix, m = mu*m + g, p - lr*m: 7 operations, 8 with
    # the decode)
    rounds = 7
    mix = rounds_ms({
        "gossip_mix": lambda: gossip_mix_bucket(p, b, 0.5),
        "gossip_mix_row_alpha": lambda: gossip_mix_bucket(p, b, row),
        "torch.lerp_": lambda: p.lerp_(b, 0.5),
        "gossip_mix_q": lambda: gossip_mix_bucket(p, enc, 0.5),
        "gossip_mix_q_row_alpha": lambda: gossip_mix_bucket(p, enc, row)},
        rounds=rounds)
    mix_bound = bound(3 * 2 * elems, 3 * elems)
    q_bound = bound(5 * elems + 4 * tiles, 4 * elems)
    for k, v in mix.items():
        bd = (q_bound if k.startswith("gossip_mix_q") else mix_bound)
        log(f"[time] {k} bf16 ({DP}, {n}), {rounds} interleaved rounds: "
            + json.dumps(dict(v, bound_ms=bd["bound_ms"],
                              share_of_bound=bd["bound_ms"] / v["median"])))

    def spread(key, name=None):
        name = name or key
        return {f"ms{key[len(name):]}": mix[key]["median"],
                f"ms{key[len(name):]}_min": mix[key]["min"],
                f"ms{key[len(name):]}_max": mix[key]["max"]}

    t = {
        "gossip_mix": dict(
            **spread("gossip_mix"),
            **spread("gossip_mix_row_alpha", "gossip_mix"),
            plain_ms=time_ms(lambda: gossip_mix_plain(p, b, 0.5)),
            library_ms=mix["torch.lerp_"]["median"],
            library_ms_min=mix["torch.lerp_"]["min"],
            library_ms_max=mix["torch.lerp_"]["max"], rounds=rounds,
            share_of_bound=mix_bound["bound_ms"] / mix["gossip_mix"]["median"],
            **mix_bound),
        "gossip_mix_q": dict(
            **spread("gossip_mix_q"),
            **spread("gossip_mix_q_row_alpha", "gossip_mix_q"),
            plain_ms=time_ms(lambda: gossip_mix_q_plain(p, q, s, 0.5)),
            library_ms=None, rounds=rounds,
            share_of_bound=q_bound["bound_ms"] / mix["gossip_mix_q"]["median"],
            **q_bound),
        "fused_sgd": dict(
            ms=time_ms(lambda: fused_sgd_bucket(p, g, b, m, lr=LR, alpha=0.5)),
            plain_ms=time_ms(lambda: fused_sgd_plain(p, g, b, m, lr=LR,
                                                     alpha=0.5)),
            library_ms=None,
            **bound(6 * 2 * elems, 7 * elems)),
        "fused_sgd_q": dict(
            ms=time_ms(lambda: fused_sgd_bucket(p, g, enc, m, lr=LR,
                                                alpha=0.5)),
            ms_row_alpha=time_ms(lambda: fused_sgd_bucket(p, g, enc, m, lr=LR,
                                                          alpha=row)),
            plain_ms=time_ms(lambda: fused_sgd_plain(
                p, g, q, m, lr=LR, alpha=0.5, partner_scales=s)),
            library_ms=None,
            **bound(11 * elems + 4 * tiles, 8 * elems)),
    }
    for k, v in t.items():
        log(f"[time] {k} bf16 ({DP}, {n}): " + json.dumps(v))
    del enc, q, s
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    enc_ms = time_ms(lambda: _encode(p, "int8"), reps=3, warmup=1)
    enc_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[time] encode int8 bf16 ({DP}, {n}): " + json.dumps(
        {"ms": enc_ms, "peak_extra_gb": enc_peak,
         **bound(2 * elems + elems + 4 * tiles, 0)}))
    del p, g, b, m
    torch.cuda.empty_cache()

    # every bucket of the layout, bf16: the fused sweep of one step and the
    # encode of each bucket, summed over the buckets a step sends
    bufs = [_inputs(sz, torch.bfloat16, gen, dev) for sz in layout.bucket_sizes]

    def sweep():
        for p_, g_, b_, m_ in bufs:
            fused_sgd_bucket(p_, g_, b_, m_, lr=LR, alpha=0.5)

    total = sum(DP * sz for sz in layout.bucket_sizes)
    sweep_ms = time_ms(sweep, reps=5, warmup=1)
    log(f"[time] fused_sgd sweep over all {layout.num_buckets} buckets bf16 "
        f"dp={DP}: " + json.dumps({"ms": sweep_ms,
                                   **bound(6 * 2 * total, 7 * total)}))
    per_bucket = [time_ms(lambda p_=p_: _encode(p_, "int8"), reps=2,
                          warmup=1) for p_, _, _, _ in bufs]
    sub = wire_subset_of(WireFormat("int8", ASYNC_WIRE["gossip_subset"]),
                         layout.num_buckets)
    steps = [sum(ms for ms, sel in zip(per_bucket, sub.selected(ph)) if sel)
             for ph in range(sub.period)]
    log("[time] encode int8 per step (subset "
        f"{ASYNC_WIRE['gossip_subset']}): " + json.dumps(
            {"ms_per_step": sum(steps) / len(steps), "ms_by_phase": steps,
             "ms_all_buckets": sum(per_bucket)}))
    del bufs, sweep
    torch.cuda.empty_cache()
    return t


def _adamw_coef(step: int) -> dict:
    from repro_torch.optim.optimizers import bias_correction
    return dict(lr=LR, c1=bias_correction(0.9, step + 1),
                c2=bias_correction(0.95, step + 1), weight_decay=ADAMW_WD)


def _opt_inputs(n, dtype, gen, dev):
    """p, g, partner of the bucket dtype, and fp32 m, v (v >= 0) and a
    LARS row scale, one per 128 elements."""
    p, g, b, m = _inputs(n, dtype, gen, dev)
    m = m.float()
    v = (torch.randn((DP, n), generator=gen, device=dev) * 1e-3).abs_()
    scale = torch.rand(DP * n // 128, generator=gen, device=dev) * 1e-2
    return p, g, b, m, v, scale


def phase_kernels_opt(layout, dev):
    """fused_adamw (raw, int8, fp8 and no partner) and fused_lars (bf16,
    fp32 and no partner) against their plain versions on the largest
    bucket, fp32 and bf16, static, () and per-row alpha: bit equality.
    Every case runs on copies, freed before the next (the plain AdamW chain
    holds several bucket-sized fp32 temporaries)."""
    from repro_torch.kernels import (fused_adamw_bucket, fused_adamw_plain,
                                     fused_lars_bucket, fused_lars_plain)
    row = torch.tensor([0.5, 0.0, 0.25, 0.5], device=dev)
    alphas = (("0.5", 0.5), ("tensor 0.25", torch.tensor(0.25, device=dev)),
              ("per-row", row))
    err = dict.fromkeys(OPT_KERNELS, 0.0)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = max(layout.bucket_sizes)
    coef = _adamw_coef(2)

    def check(kind, tag, an, pairs):
        e = max(_diff(g_, w_) for g_, w_ in pairs)
        eq = all(torch.equal(g_, w_) for g_, w_ in pairs)
        err[kind] = max(err[kind], e)
        log(f"[check_opt] {kind} {tag} alpha {an}: equal={eq} "
            f"max_abs_err={e}")
        assert eq, f"{kind} disagrees with its plain version"

    for dtype in (torch.float32, torch.bfloat16):
        p, g, b, m, v, scale = _opt_inputs(n, dtype, gen, dev)
        tag = f"{str(dtype)[6:]} ({DP}, {n})"
        for pname in ("raw", "int8", "fp8", "none"):
            payload = (b if pname == "raw" else None if pname == "none"
                       else _encode(b, pname))
            coded = isinstance(payload, dict)
            partner = payload["q"] if coded else payload
            scales = payload["s"] if coded else None
            for an, alpha in (alphas if payload is not None
                              else (("-", 0.0),)):
                want = fused_adamw_plain(p, g, partner, m, v, alpha=alpha,
                                         partner_scales=scales, **coef)
                got = (p.clone(), m.clone(), v.clone())
                fused_adamw_bucket(got[0], g, payload, got[1], got[2],
                                   alpha=alpha, **coef)
                torch.cuda.synchronize()
                check("fused_adamw_q" if coded else "fused_adamw",
                      f"{tag} {pname}", an, list(zip(got, want)))
                del got, want
                torch.cuda.empty_cache()
            del payload, partner, scales
        for pname in ("bf16", "fp32", "none"):
            partner = (None if pname == "none" else
                       b.to(torch.bfloat16 if pname == "bf16"
                            else torch.float32))
            for an, alpha in (alphas if partner is not None
                              else (("-", 0.0),)):
                want = fused_lars_plain(p, g, partner, m, scale, lr=LR,
                                        alpha=alpha, momentum=MOMENTUM,
                                        weight_decay=LARS_WD)
                got = (p.clone(), m.clone())
                fused_lars_bucket(got[0], g, partner, got[1], scale, lr=LR,
                                  alpha=alpha, momentum=MOMENTUM,
                                  weight_decay=LARS_WD)
                torch.cuda.synchronize()
                check("fused_lars", f"{tag} {pname} partner", an,
                      list(zip(got, want)))
                del got, want
                torch.cuda.empty_cache()
            del partner
        del p, g, b, m, v, scale
        torch.cuda.empty_cache()
    return err


def phase_time_opt(layout, dev):
    """fused_adamw and fused_lars per launch on the largest bucket in bf16
    (the full-width paths' dtype) beside their bounds and plain versions;
    torch._fused_adamw_ for orientation only (not the same function: no
    mix, decay as p * (1 - lr * wd), bf16 moments as torch.optim.AdamW
    keeps them); the LARS norm prepass per bucket and per step."""
    from repro_torch.kernels import (fused_adamw_bucket, fused_adamw_plain,
                                     fused_lars_bucket, fused_lars_plain)
    from repro_torch.optim.optimizers import _lars_row_scale
    gen = torch.Generator(device=dev).manual_seed(4)
    big = max(range(layout.num_buckets), key=lambda i: layout.bucket_sizes[i])
    n = layout.bucket_sizes[big]
    p, g, b, m, v, scale = _opt_inputs(n, torch.bfloat16, gen, dev)
    enc = _encode(b, "int8")
    b32 = b.float()
    row = torch.tensor([0.5, 0.5, 0.0, 0.5], device=dev)
    coef = _adamw_coef(2)
    lars_kw = dict(lr=LR, momentum=MOMENTUM, weight_decay=LARS_WD)
    elems = DP * n
    tiles = elems / 128
    # bytes per element (each input read once, each output written once):
    # adamw reads p, g, partner (2 B each in bf16; 1 B + 4/128 for codes)
    # and m, v (4 B each) and writes p, m, v: 24, 23.03 with int8 codes,
    # 22 with no partner. fp32 operations: the mix 3 (4 with the decode),
    # m 3, v 4, u 4 (two divisions, a root, an add), decay 2, step 2.
    # lars reads p, g, partner, m and a 128th of a scale, writes p, m:
    # 16.03 with a bf16 partner, 18.03 with fp32; operations: the mix 3,
    # decay 2, m 3, step 2.
    t = {
        "fused_adamw": dict(
            ms=time_ms(lambda: fused_adamw_bucket(p, g, b, m, v, alpha=0.5,
                                                  **coef)),
            ms_row_alpha=time_ms(lambda: fused_adamw_bucket(
                p, g, b, m, v, alpha=row, **coef)),
            ms_no_partner=time_ms(lambda: fused_adamw_bucket(
                p, g, None, m, v, alpha=0.0, **coef)),
            plain_ms=time_ms(lambda: fused_adamw_plain(p, g, b, m, v,
                                                       alpha=0.5, **coef),
                             reps=3, warmup=1),
            library_ms=None,
            bound_ms_no_partner=bound(22 * elems, 15 * elems)["bound_ms"],
            **bound(24 * elems, 18 * elems)),
        "fused_adamw_q": dict(
            ms=time_ms(lambda: fused_adamw_bucket(p, g, enc, m, v, alpha=0.5,
                                                  **coef)),
            ms_row_alpha=time_ms(lambda: fused_adamw_bucket(
                p, g, enc, m, v, alpha=row, **coef)),
            plain_ms=time_ms(lambda: fused_adamw_plain(
                p, g, enc["q"], m, v, alpha=0.5, partner_scales=enc["s"],
                **coef), reps=3, warmup=1),
            library_ms=None,
            **bound(23 * elems + 4 * tiles, 19 * elems)),
        "fused_lars": dict(
            ms=time_ms(lambda: fused_lars_bucket(p, g, b, m, scale, alpha=0.5,
                                                 **lars_kw)),
            ms_row_alpha=time_ms(lambda: fused_lars_bucket(
                p, g, b, m, scale, alpha=row, **lars_kw)),
            ms_f32_partner=time_ms(lambda: fused_lars_bucket(
                p, g, b32, m, scale, alpha=0.5, **lars_kw)),
            plain_ms=time_ms(lambda: fused_lars_plain(
                p, g, b, m, scale, alpha=0.5, **lars_kw), reps=3, warmup=1),
            library_ms=None,
            bound_ms_f32_partner=bound(18 * elems + 4 * tiles,
                                       10 * elems)["bound_ms"],
            **bound(16 * elems + 4 * tiles, 10 * elems)),
    }
    try:  # orientation only: a different function and moment dtype
        pb, gb = p.clone(), g.clone()
        mb, vb = m.to(torch.bfloat16), v.to(torch.bfloat16)
        steps = [torch.tensor(3.0, device=dev)]
        t["fused_adamw"]["torch_fused_adamw_bf16_ms"] = time_ms(
            lambda: torch._fused_adamw_(
                [pb], [gb], [mb], [vb], [], steps, lr=LR, beta1=0.9,
                beta2=0.95, weight_decay=ADAMW_WD, eps=1e-8, amsgrad=False,
                maximize=False))
        del pb, gb, mb, vb
    except Exception as exc:  # noqa: BLE001 - a yardstick, not the port
        t["fused_adamw"]["torch_fused_adamw_bf16_ms"] = f"failed: {exc}"
    for k, val in t.items():
        log(f"[time_opt] {k} bf16 ({DP}, {n}): " + json.dumps(val))

    # the LARS prepass on the largest bucket: its time and extra memory,
    # with a bf16 partner and with the fp32 partner a decoded wire gives
    pre = dict(weight_decay=LARS_WD, trust_coef=1e-3, eps=1e-9)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _lars_row_scale(layout, big, p, g, b32, alpha=row, **pre)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[time_opt] lars prepass bucket {big} ({DP}, {n}): " + json.dumps({
        "ms_bf16_partner": time_ms(lambda: _lars_row_scale(
            layout, big, p, g, b, alpha=0.5, **pre), reps=3, warmup=1),
        "ms_fp32_partner_row_alpha": time_ms(lambda: _lars_row_scale(
            layout, big, p, g, b32, alpha=row, **pre), reps=3, warmup=1),
        "peak_extra_gb_fp32_partner": peak}))
    del p, g, b, m, v, scale, enc, b32
    torch.cuda.empty_cache()

    bufs = [_inputs(sz, torch.bfloat16, gen, dev)[:3]
            for sz in layout.bucket_sizes]

    def prepass():
        for i, (p_, g_, b_) in enumerate(bufs):
            _lars_row_scale(layout, i, p_, g_, b_, alpha=0.5, **pre)

    step_ms = time_ms(prepass, reps=3, warmup=1)
    log(f"[time_opt] lars prepass per step, all {layout.num_buckets} "
        f"buckets bf16 dp={DP}: " + json.dumps({"ms": step_ms}))
    t["fused_lars"]["prepass_ms_per_step"] = step_ms
    del bufs
    torch.cuda.empty_cache()
    return t


def phase_check_ssm(dev, shapes=(SSM_SHAPE, (3, 1000, 100, 5),
                                  (2, 1, 8192, 16))):
    """ssm_scan against its plain loop, bit for bit."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    err = 0.0
    for shape in shapes:
        dA = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
        dBx = torch.randn(shape, generator=gen, device=dev)
        got = ssm_scan(dA, dBx)
        want = ssm_scan_ref(dA, dBx)
        torch.cuda.synchronize()
        eq, e = torch.equal(got, want), _diff(got, want)
        err = max(err, e)
        log(f"[check_ssm] {shape}: equal={eq} max_abs_err={e}")
        assert eq, "ssm_scan disagrees with its plain version"
        del dA, dBx, got, want
        torch.cuda.empty_cache()
    return {"ssm_scan": err}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.zeros_like(x),
                       torch.ldexp(torch.ones_like(x), e - 8))


def _attn_qkv(gen, dev, B, S, T, d, dtype, heads, kv_heads):
    """q (B, heads, S, d); k and v drawn for kv_heads and repeated to
    heads, as GQA attention repeats them."""
    rep = heads // kv_heads
    mk = lambda h, n, sc: (torch.randn((B, h, n, d), generator=gen,
                                       device=dev) * sc).to(dtype)
    return (mk(heads, S, 0.3), mk(kv_heads, T, 0.3).repeat_interleave(rep, 1),
            mk(kv_heads, T, 1.0).repeat_interleave(rep, 1))


def _attn_agree(got, want) -> tuple:
    """(max |got - want|, within tolerance): fp32 rtol = atol = 2e-5;
    bf16 one bf16 ulp of the plain output plus 2e-5."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    lim = (2e-5 + 2e-5 * w.abs() if got.dtype == torch.float32
           else _bf16_ulp(w) + 2e-5)
    return err.max().item(), bool((err <= lim).all())


def phase_check_attn(dev, S=ATTN_S, heads=16, kv_heads=8, d=128):
    """flash_attention against its plain version (dense attention_ref, and
    the reference's block rule for rows with no admissible key) at
    qwen3-0.6b's attention shapes, and at S 256, T 128, window 8, where
    rows 135-255 have no admissible key, for four (block_q, block_k)."""
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.flash_attention import flash_attention_plain
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"[check_attn] torch.backends.cuda.matmul.allow_tf32={tf32} (the "
        f"plain version's fp32 einsum must not round to TF32)")
    assert not tf32
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [(S, S, True, None, d, 128), (S, S, True, S // 4, d, 128),
             (S // 4, S, False, None, d, 128),
             (S // 8, S // 8, True, None, d // 2, 128)]
    cases += [(256, 128, causal, 8, d, blocks) for causal in (True, False)
              for blocks in ((128, 128), (32, 32), (64, 128), (128, 32))]
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for s_, t_, causal, window, dd, blocks in cases:
            bq, bk = blocks if isinstance(blocks, tuple) else (blocks,) * 2
            q, k, v = _attn_qkv(gen, dev, 1, s_, t_, dd, dtype, heads,
                                kv_heads)
            kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
            got = flash_mha(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            e, ok = _attn_agree(got, want)
            err[dtype] = max(err[dtype], e)
            log(f"[check_attn] {str(dtype)[6:]} H {heads} S {s_} T {t_} d {dd} "
                f"causal={causal} window={window} blocks ({bq}, {bk}): "
                f"within_tolerance={ok} max_abs_err={e}")
            assert ok, "flash_attention disagrees with its plain version"
            del q, k, v, got, want
            torch.cuda.empty_cache()
    q = torch.zeros((1, heads, S - 1, d), device=dev)
    try:
        flash_mha(q, q, q, block_q=64)
    except ValueError as exc:
        log(f"[check_attn] S % block_q != 0 raises: {exc}")
    else:
        raise AssertionError("S % block_q != 0 did not raise")
    return {"flash_attention": err[torch.float32],
            "flash_attention_bf16": err[torch.bfloat16]}


def phase_time_ssm(dev, shape=SSM_SHAPE):
    """ssm_scan and its plain loop at falcon-mamba's scan shape. Bound:
    bytes, dA and dBx read and h written once (12 per element); no single
    PyTorch call computes a linear recurrence."""
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    gen = torch.Generator(device=dev).manual_seed(7)
    dA = torch.rand(shape, generator=gen, device=dev) * 0.8 + 0.2
    dBx = torch.randn(shape, generator=gen, device=dev)
    n = dA.numel()
    t = dict(ms=time_ms(lambda: ssm_scan(dA, dBx), reps=10, warmup=2),
             plain_ms=time_ms(lambda: ssm_scan_ref(dA, dBx), reps=1,
                              warmup=1),
             library_ms=None, bytes=12 * n, **bound(12 * n, 2 * n))
    log(f"[time_ssm] {shape} fp32: " + json.dumps(t))
    del dA, dBx
    torch.cuda.empty_cache()
    return {"ssm_scan": t}


def _attn_flops(B, H, S, T, d, causal) -> float:
    """Multiply-adds of q.k and p.v over the live (query, key) pairs, 2
    flops each."""
    pairs = S * (S + 1) // 2 if causal and S == T else S * T
    return 4.0 * B * H * pairs * d


def _attn_bound(q, k, v, causal) -> dict:
    """Bound of one attention call on these tensors. Bytes: q, k, v read
    once and o (q's dtype) written once. Operations: each product at the
    split-pass rate of its operands on the tensor cores: 989 TFLOP/s for two
    16-bit operands (their products are exact in fp32), 989/3 with one fp32
    operand (split into three bf16 pieces) and 989/6 with two; q.k at the
    rate of q and k, p.v at the rate of v with v (the fp32 p splits exactly
    into bf16 passes too, so this floor is low, never flattering). Also
    every product at the fp32 CUDA-core 67 TFLOP/s, the ceiling of fp32
    FMAs outside the tensor cores, as ``bound_ms_fp32_cuda_cores``."""
    B, H, S, d = q.shape
    flops = _attn_flops(B, H, S, k.shape[2], d, causal)
    rate = lambda a, b: BF16_TC_FLOPS_PER_S / (1, 3, 6)[
        (a.dtype == torch.float32) + (b.dtype == torch.float32)]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    ops_ms = (flops / 2 / rate(q, k) + flops / 2 / rate(v, v)) * 1e3
    return dict(bytes=nbytes, flops=flops, **bound(nbytes, flops, ops_ms),
                bound_ms_fp32_cuda_cores=flops / FP32_FLOPS_PER_S * 1e3)


def phase_time_attn(dev, lengths=(ATTN_S, ATTN_S_LONG), heads=16, d=128):
    """flash_mha, causal bf16, B 1 at qwen3-0.6b's heads: the kernel, the
    plain dense version (at the first length only: at 32k its fp32 score
    matrix is 4 GB per head) and scaled_dot_product_attention on the same
    tensors. The bound is bf16's, on the tensor cores; the fp32 CUDA-core
    figure rides beside it. The kernels line's flash entry takes its times
    from ``[flash_path]``'s own call; these enter it as ``*_bf16`` keys."""
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ref import attention_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for i, S in enumerate(lengths):
        q, k, v = _attn_qkv(gen, dev, 1, S, S, d, torch.bfloat16, heads,
                            heads // 2)
        reps = 10 if i == 0 else 2
        t = dict(S=S, ms=time_ms(lambda: flash_mha(q, k, v), reps=reps,
                                 warmup=1),
                 plain_ms=(time_ms(lambda: attention_ref(q, k, v), reps=3,
                                   warmup=1) if i == 0 else None),
                 library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True),
                                    reps=reps, warmup=1),
                 **_attn_bound(q, k, v, True))
        log(f"[time_attn] causal bf16 B 1 H {heads} S {S} d {d}: "
            + json.dumps(t))
        out[S] = t
        del q, k, v
        torch.cuda.empty_cache()
    # rows with no admissible key: S 256, T 128, window 8, blocks 32 (rows
    # 135-255 keyless, 224-255 with no live tile); no PyTorch call gives
    # such rows the reference's value (SDPA's bool mask makes them NaN)
    q, k, v = _attn_qkv(gen, dev, 1, 256, 128, d, torch.bfloat16, heads,
                        heads // 2)
    kw = dict(causal=True, window=8, block_q=32, block_k=32)
    got = flash_mha(q, k, v, **kw)
    e, ok = _attn_agree(got, flash_attention_plain(q, k, v, **kw))
    t = dict(S=256, T=128, window=8, blocks=[32, 32], max_abs_err=e,
             within_tolerance=ok,
             ms=time_ms(lambda: flash_mha(q, k, v, **kw), reps=20),
             plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, **kw),
                              reps=5),
             library_ms=None)
    log(f"[time_attn] keyless rows bf16 B 1 H {heads} S 256 T 128 d {d} "
        f"causal window 8: " + json.dumps(t))
    assert ok, "flash_attention disagrees with its plain version"
    keys = ("ms", "plain_ms", "library_ms", "bound_ms",
            "bound_ms_fp32_cuda_cores")
    return {"flash_attention_bf16": {
        f"{k}_bf16" + ("" if S == lengths[0] else f"_{S}"): t[k]
        for S, t in out.items() for k in keys if t[k] is not None}}


def phase_flash_path(dev, S=ATTN_S, cfg=None):
    """One flash_mha call on q, k, v that a full-width qwen3-0.6b attention
    layer projects in bf16 (qk-norm, RoPE, which leaves q and k in fp32 as
    in the reference; the 8 KV heads repeated to 16), with the launch counts
    reset just before and read just after; then that call timed against its
    plain version and scaled_dot_product_attention (which takes one dtype:
    it gets v in fp32, made before the timing, the same values)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_mha
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models.attention import _project_qkv, attn_init
    from repro_torch.models.layers import draw
    from repro_torch.tree import tree_map
    cfg = cfg or get_config("qwen3-0.6b")
    spec = cfg.blocks[0].attn
    gen = torch.Generator(device=dev).manual_seed(9)
    p = tree_map(lambda s: draw(s, gen, dev)[None],
                 attn_init(cfg.d_model, spec, torch.bfloat16))
    x = torch.randn((1, 1, S, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    q, k, v = _project_qkv(p, spec, x, torch.arange(S, device=dev)[None])
    rep = spec.n_heads // spec.n_kv_heads
    q = q[0].transpose(1, 2).contiguous()                  # (1, H, S, hd)
    k, v = (t[0].repeat_interleave(rep, 2).transpose(1, 2).contiguous()
            for t in (k, v))
    torch.cuda.synchronize()
    _reset_counts()
    out = flash_mha(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = _counts()
    want = dict.fromkeys(KERNELS, 0)
    want["flash_attention"] = 1
    plain = attention_ref(q, k, v)
    e, ok = _attn_agree(out, plain)
    # both against causal attention in float64, to tell the kernel's error
    # from the plain version's own fp32 rounding
    s64 = torch.einsum("bhsd,bhtd->bhst", q.double(), k.double()) \
        / math.sqrt(q.shape[-1])
    s64.masked_fill_(torch.ones(S, S, dtype=torch.bool, device=dev).triu(1),
                     float("-inf"))
    o64 = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s64, -1), v.double())
    del s64
    res = {"shape": list(q.shape), "dtypes": [str(t.dtype)[6:] for t in
                                               (q, k, v)], "launches": counts,
           "max_abs_err_vs_plain": e, "within_tolerance": ok,
           "max_abs_err_vs_float64": (out.double() - o64).abs().max().item(),
           "plain_max_abs_err_vs_float64":
               (plain.double() - o64).abs().max().item()}
    del o64, plain
    log("[flash_path] " + json.dumps(res))
    assert counts == want, (counts, want)
    assert ok and bool(torch.isfinite(out.float()).all())
    v32 = v.float()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["timing"] = dict(
        ms=time_ms(lambda: flash_mha(q, k, v, causal=True), reps=10,
                   warmup=1),
        plain_ms=time_ms(lambda: attention_ref(q, k, v), reps=3, warmup=1),
        library_ms=time_ms(lambda: sdpa(q, k, v32, is_causal=True), reps=10,
                           warmup=1),
        **_attn_bound(q, k, v, True))
    # the same values in one dtype, to tell the inputs' dtypes from their
    # values
    for dt in (torch.float32, torch.bfloat16):
        qq, kk, vv = (t.to(dt) for t in (q, k, v))
        res["timing"][f"ms_same_values_{str(dt)[6:]}"] = time_ms(
            lambda: flash_mha(qq, kk, vv, causal=True), reps=10, warmup=1)
    log("[flash_path] the path's call timed: " + json.dumps(res["timing"]))
    return res


def _eval_batch(cfg, dev, b=EVAL_B, seq=EVAL_S):
    from repro_torch.data import ShardedTokenDataset, make_replica_batches
    ds = ShardedTokenDataset(cfg.vocab, seq, n_shards=1, batch_per_shard=b)
    return {"tokens": torch.from_numpy(
        make_replica_batches(ds, 0, 1)["tokens"]).to(dev)}


def _replica_params(cfg, dev):
    """One replica's random params from seed 0, with the replica axis."""
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_map
    return tree_map(lambda w: w[None], lm_init(cfg, seed=0, device=dev))


def phase_mamba_eval(dev, cfg=None, forwards=EVAL_FORWARDS, profile=True):
    """Score falcon-mamba-7b at full width and depth through make_loss_fn
    with the ssm_scan kernel as its scan, under no_grad: the first forward
    and the steady ones, peak memory, launches (64 per forward), loss."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import tree_flatten
    cfg = cfg or get_config("falcon-mamba-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _replica_params(cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves, _ = tree_flatten(params)
    n_params = sum(w.numel() for w in leaves)
    batch = _eval_batch(cfg, dev)
    loss_fn = make_loss_fn(cfg, ssm_scan_impl=ssm_scan)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        _reset_counts()
        for _ in range(forwards):
            t0 = time.perf_counter()
            loss, _ = loss_fn(params, batch)
            losses.append(float(loss[0]))   # reads the loss back: a sync
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _counts()
    tokens = batch["tokens"].shape[1] * (batch["tokens"].shape[2] - 1)
    steady = sum(times[1:]) / len(times[1:])
    want = dict.fromkeys(KERNELS, 0)
    want["ssm_scan"] = forwards * cfg.n_layers
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "params": n_params,
           "param_gb": sum(w.numel() * w.element_size() for w in leaves) / 1e9,
           "tokens_per_forward": tokens, "forwards": forwards,
           "init_s": init_s, "first_forward_ms": times[0],
           "ms_per_forward": steady, "tokens_per_s": tokens / steady * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_extra_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
           "losses": losses, "launches": counts,
           "ssm_scan_launches_per_forward": counts["ssm_scan"] / forwards}
    log("[mamba_eval] " + json.dumps(res))
    assert counts == want, (counts, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    if profile:
        profile_forward("mamba_eval", lambda: loss_fn(params, batch), steady)
    del params, batch
    torch.cuda.empty_cache()
    return res


def profile_forward(name, fn, step_ms) -> None:
    """One forward under torch.profiler (no_grad), device-side events only:
    busy time, the idle share against the unprofiled forward, the scan's
    share, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy = sum(r[1] for r in rows)
    groups = {g: sum(ms for k, ms, _ in rows if g in k.lower())
              for g in ("ssm_scan_kernel", "gemm", "nvjet", "elementwise",
                        "reduce", "cat")}
    log(f"[profile {name}] " + json.dumps({
        "device_busy_ms": busy, "forward_ms_unprofiled": step_ms,
        "idle_share": 1.0 - busy / step_ms, "profiled_wall_ms": wall_ms,
        "scan_share_of_busy": groups["ssm_scan_kernel"] / busy,
        "device_ops": sum(r[2] for r in rows),
        "device_ms_by_kernel_name": groups}))
    _log_top(name, rows)


def phase_mamba_agree(dev, cfg=None, b=EVAL_B, seq=EVAL_S):
    """falcon-mamba at full width and 2 layers: logits with the kernel equal
    those with the plain loop bit for bit (the ops around the scan are the
    same); a reduced fp32 falcon-mamba's logits on the card against the
    CPU's (plain loop) within rtol = atol = 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.ref import ssm_scan_ref
    from repro_torch.models import lm_apply, reduced
    from repro_torch.tree import tree_map
    cfg = cfg or get_config("falcon-mamba-7b")
    short = dataclasses.replace(cfg, blocks=cfg.blocks[:SHORT_LAYERS])
    params = _replica_params(short, dev)
    tok = _eval_batch(short, dev, b, seq)["tokens"][..., :-1]
    with torch.no_grad():
        got = lm_apply(params, short, tok, ssm_scan_impl=ssm_scan)
        want = lm_apply(params, short, tok, ssm_scan_impl=ssm_scan_ref)
    torch.cuda.synchronize()
    eq = torch.equal(got, want)
    log(f"[mamba_agree] {SHORT_LAYERS} layers full width, logits "
        f"{tuple(got.shape)} {str(got.dtype)[6:]}: kernel equals plain={eq} "
        f"max_abs_err={_diff(got, want)}")
    assert eq, "logits through the kernel differ from the plain loop's"
    del params, got, want
    torch.cuda.empty_cache()

    small = dataclasses.replace(reduced(cfg), param_dtype="float32",
                                compute_dtype="float32")
    cpu_params = _replica_params(small, "cpu")
    tok = _eval_batch(small, "cpu", 2, 64)["tokens"][..., :-1]
    with torch.no_grad():
        want = lm_apply(cpu_params, small, tok, ssm_scan_impl=ssm_scan)
        got = lm_apply(tree_map(lambda w: w.to(dev), cpu_params), small,
                       tok.to(dev), ssm_scan_impl=ssm_scan).cpu()
    ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-4))
    log(f"[mamba_agree] reduced fp32 ({small.n_layers} layers, d "
        f"{small.d_model}): card vs cpu within 2e-4={ok} "
        f"max_abs_err={_diff(got, want)}")
    assert ok, "card and CPU logits disagree"


def make_optimizer(name: str, steps: int, lr: float):
    """sgd, adamw or lars on a step_decay over ``steps``, as a user builds
    them through the library API (the launcher builds only sgd)."""
    from repro_torch.optim import adamw, lars, sgd, step_decay
    sched = step_decay(lr, 0.1, max(steps // 3, 1))
    if name == "adamw":
        return adamw(sched, weight_decay=ADAMW_WD)
    if name == "lars":
        return lars(sched, momentum=MOMENTUM, weight_decay=LARS_WD)
    return sgd(sched, momentum=MOMENTUM)


def _train(cfg, *, fused, steps, dev, params=None, dp=DP, seq=SEQ,
           per_replica=PER_REPLICA, protocol="gossip", optimizer="sgd",
           lr=None, packed=True, dist=None, **wire):
    """A bundle and its Trainer; ``packed=False`` runs the per-leaf engines
    (``wire`` may then carry ``mix_impl``); ``dist`` (a distribution plan)
    replaces ``dp`` and picks the shard-local layout when it shards inside
    a replica."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    opt = make_optimizer(optimizer, steps,
                         FULL_LR[optimizer] if lr is None else lr)
    size = dict(dist=dist) if dist is not None else dict(dp=dp)
    bundle = make_train_step_bundle(cfg, opt, protocol=protocol,
                                    gossip_packed=packed, fused_update=fused,
                                    device=dev, **size, **wire)
    state = init_train_state(cfg, opt, packed=packed,
                             layout=bundle.layout, seed=0, params=params,
                             device=dev, inbox=bundle.protocol.staleness,
                             wire=bundle.wire, **size)
    ds = ShardedTokenDataset(cfg.vocab, seq, n_shards=bundle.dp,
                             batch_per_shard=per_replica)
    return bundle, Trainer(bundle, state, ds, log_every=0)


def _counters():
    from repro_torch.kernels import (flash_attention, fused_update, gossip_mix,
                                     ssm_scan_kernel)
    return {"gossip_mix": gossip_mix.launches,
            "gossip_mix_q": gossip_mix.q_launches,
            "fused_sgd": fused_update.launches,
            "fused_sgd_q": fused_update.scaled_launches,
            "fused_adamw": fused_update.adamw_launches,
            "fused_adamw_q": fused_update.adamw_scaled_launches,
            "fused_lars": fused_update.lars_launches,
            "ssm_scan": ssm_scan_kernel.launches,
            "flash_attention": flash_attention.launches}


def _reset_counts():
    for c in _counters().values():
        c.reset()


def _counts():
    return {k: c.count for k, c in _counters().items()}


def _leaf_view(params):
    """Every param as a leaf tensor: a tree's leaves, or packed buckets
    through their ``unpack()`` views."""
    from repro_torch.core import PackedParams
    from repro_torch.tree import tree_flatten
    if isinstance(params, PackedParams):
        params = params.unpack()
    return [x.detach() for x in tree_flatten(params)[0]]


def _finite_buckets(trainer) -> bool:
    return all(bool(torch.isfinite(b).all()) for b in
               _leaf_view(trainer.state["params"]))


def _num_leaves(cfg) -> int:
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    return len(tree_flatten(lm_specs(cfg))[0])


def consumed(bundle, steps: int, start: int = 0) -> int:
    """Buckets that meet a partner over ``steps`` steps: the consumed
    subset ``selected(phase - k)`` (k = 0 for sync), every bucket without
    a subset."""
    from repro_torch.core.gossip import wire_subset_of
    proto, nb = bundle.protocol, bundle.layout.num_buckets
    sub = wire_subset_of(proto.wire, nb)
    if sub is None:
        return steps * nb
    return sum(int(sub.selected(s % proto.period - proto.staleness).sum())
               for s in range(start, start + steps))


def run_path(name, cfg, dev, *, fused, steps, expect, profile=False,
             keep_params=False, **proto):
    """Drive one path through Trainer with the launch counts reset just
    before and read just after; ``expect(bundle)`` gives the counts it
    must show. Returns the path's record (its counts under
    ``"launches"``; with ``keep_params`` a copy of the params after the
    counted steps under ``"params"``, on the card, or on the host with
    ``keep_params="cpu"`` so that later paths' peaks do not count it)."""
    bundle, tr = _train(cfg, fused=fused, steps=steps, dev=dev, **proto)
    impl = proto.pop("mix_impl", None)
    if impl is not None:
        proto["mix_impl"] = impl.__name__
    dist = proto.pop("dist", None)
    if dist is not None:
        proto["mesh"] = dict(dist.mesh.shape)
        proto["dist_mode"] = dist.mode
    assert bundle.fused == fused
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    tr.run(1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hist = tr.run(steps - 1, start_step=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _counts()
    losses = [h["loss"] for h in hist]
    want = expect(bundle)
    lay = bundle.layout
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "dp": bundle.dp,
           "seq": SEQ, "per_replica": PER_REPLICA, "fused": fused,
           "optimizer": "sgd", **proto,
           "period": bundle.protocol.period,
           "num_buckets": lay.num_buckets if lay is not None else None,
           "num_shards": lay.num_shards if lay is not None else None,
           "num_leaves": _num_leaves(cfg), "losses": losses,
           "first_step_ms": (t1 - t0) * 1e3,
           "ms_per_step": (t2 - t1) * 1e3 / (steps - 1),
           "tokens_per_s": bundle.dp * PER_REPLICA * SEQ * (steps - 1)
           / (t2 - t1),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "expected_launches": want}
    log(f"[{name}] " + json.dumps(res))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    assert counts == want, (counts, want)
    assert _finite_buckets(tr), "non-finite parameters"
    kept = ([x.cpu() if keep_params == "cpu" else x.clone()
             for x in _leaf_view(tr.state["params"])]
            if keep_params else None)
    if profile:
        res["profile"] = profile_step(name, tr)
    if lay is not None and lay.hierarchical:   # after the timed windows
        res.update(_unpack_cost(tr.state["params"]))
        log(f"[{name}] unpack alone: " + json.dumps(
            {k: res[k] for k in ("strides", "unpack_ms", "unpack_gb",
                                 "unpack_bound_ms")}))
    del tr, bundle
    torch.cuda.empty_cache()
    if kept is not None:
        res["params"] = kept
    return res


def _unpack_cost(params) -> dict:
    """A shard-local layout's ``unpack`` alone (forward, no autograd): the
    per-shard strides, the device ms of one assembly of every leaf and the
    bytes it writes (the extra peak a forward holds until backward)."""
    lay = params.layout
    with torch.no_grad():
        ms = time_ms(lambda: lay.unpack(params.buckets), reps=5, warmup=1)
        nbytes = sum(x.numel() * x.element_size() for x in
                     _leaf_view(params))
    return {"strides": list(lay.strides), "unpack_ms": ms,
            "unpack_gb": nbytes / 1e9,
            "unpack_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3}


def profile_step(name, tr) -> None:
    """Whole protocol periods, at least 4 steps, timed without the
    profiler, then the same phases again under torch.profiler, after the
    counted window: the async paths' steps differ by phase (the subset
    sends the embedding bucket every other step), so both windows cover
    each phase alike.
    Device busy time is the sum of the kernels (device-side events only:
    an operator's row repeats its kernels' time), per step; the idle share
    is taken against the unprofiled window's step time, since the profiler
    slows the host. Also times the host's synthetic batch for one step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import make_replica_batches
    period = tr.bundle.protocol.period
    n = period * -(-4 // period)   # at least 4 steps, whole periods
    step = len(tr.history)
    t0 = time.perf_counter()
    make_replica_batches(tr.dataset, step, tr.bundle.dp)
    batch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(n, start_step=step)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(n, start_step=step + n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = _device_rows(prof, n)
    busy_ms = sum(r[1] for r in rows)
    # index: the exchange's index_select and, under lars, the prepass's
    # index_add_ (indexFunc*) and gather; reduce: the prepass's row sums
    groups = {g: sum(ms for k, ms, _ in rows if g in k)
              for g in ("fused_sgd_kernel", "fused_adamw_kernel",
                        "fused_lars_kernel", "gossip_mix_kernel", "index",
                        "indexFunc", "reduce_kernel", "CatArrayBatchedCopy")}
    rec = {"steps": n, "device_busy_ms": busy_ms,
           "step_ms_unprofiled": step_ms,
           "tokens_per_s_unprofiled": tr.bundle.dp * PER_REPLICA * SEQ
           / step_ms * 1e3,
           "idle_share": 1.0 - busy_ms / step_ms,
           "profiled_wall_ms": wall_ms,
           "device_ops_per_step": sum(r[2] for r in rows),
           "host_batch_ms": batch_ms, "device_ms_by_kernel_name": groups}
    log(f"[profile {name}] " + json.dumps(rec))
    _log_top(name, rows)
    return rec


def _device_rows(prof, per: int = 1):
    """(kernel, device ms, launches) per ``per`` runs, largest first, from
    device-side events only (an operator's row repeats its kernels' time)."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_device_time_total / 1e3 / per,
                    e.count / per) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])


def _log_top(name, rows, k: int = 16) -> None:
    for key, ms, count in rows[:k]:
        log(f"[profile {name}] {ms:9.3f} ms  x{count:<7g} {key[:90]}")


@contextlib.contextmanager
def _bucket_bytes(nbytes: int):
    """Small buckets for the small model, so a subset has buckets to pick
    from (the tests force the same layout in both packages)."""
    import repro_torch.train.step as step_mod
    orig = step_mod.build_layout
    step_mod.build_layout = functools.partial(orig, target_bucket_bytes=nbytes)
    try:
        yield
    finally:
        step_mod.build_layout = orig


def _code_step(ref: np.ndarray, wire: str | None) -> np.ndarray:
    """0.5 (alpha) times one wire code step of each element's tile."""
    if wire is None or wire in ("fp32", "bf16"):
        return np.zeros_like(ref)
    tiles = ref.reshape(ref.shape[:-1] + (-1, 128))
    amax = np.abs(tiles).max(-1, keepdims=True)
    if wire == "int8":
        step = amax / 127.0 + 0 * tiles
    else:
        scale = amax / 448.0
        y = np.abs(tiles) / np.where(scale > 0, scale, 1.0)
        step = scale * 2.0 ** (np.floor(np.log2(np.maximum(y, 2.0 ** -6)))
                               - 3)
    return (0.5 * step).reshape(ref.shape)


def _state_items(state):
    """(name, value) of every tensor and host value of a train state in a
    fixed order, a ``PackedParams`` by its buckets."""
    from repro_torch.core import PackedParams

    def walk(node, path):
        if isinstance(node, PackedParams):
            for i, b in enumerate(node.buckets):
                yield f"{path}[{i}]", b
        elif isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{path}[{i}]")
        elif node is not None:
            yield path, node
    return list(walk(state, ""))


_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(_INT_OF_SIZE[a.element_size()]),
            b.view(_INT_OF_SIZE[b.element_size()])))
    return bool(np.array_equal(a, b))


def _states_equal(got, want) -> bool:
    g, w = _state_items(got), _state_items(want)
    assert [k for k, _ in g] == [k for k, _ in w], "state structures differ"
    return all(_same_bits(x, y) for (_, x), (_, y) in zip(g, w))


def _states_diff(got, want) -> float:
    """Largest elementwise difference over the state's tensors."""
    return max((_diff(x, y) for (_, x), (_, y) in
                zip(_state_items(got), _state_items(want))
                if isinstance(x, torch.Tensor)), default=0.0)


def phase_averaging(name, cfg, dev, protocol):
    """The paper's baselines at full width, fused: ``agd`` averages the
    gradients before every sweep (alpha 0), ``every_logp`` averages the
    params after every ``substeps``-th sweep. Counted like [main], with the
    replicas' bit identity checked after every step of the counted window
    (agd: always; every_logp: exactly after the averaging steps), then
    timed and profiled like [main]; the replica mean is timed alone on a
    copy of the params."""
    from repro_torch.core import PackedParams
    from repro_torch.core.protocols import _replica_mean
    bundle, tr = _train(cfg, fused=True, steps=MAIN_STEPS, dev=dev,
                        protocol=protocol)
    sub = bundle.protocol.schedule.substeps if protocol == "every_logp" else 1
    buckets = lambda: tr.state["params"].buckets  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    same = []
    t0 = time.perf_counter()
    for s in range(MAIN_STEPS):
        tr.run(1, start_step=s)
        same.append(all(torch.equal(b, b[:1].expand_as(b))
                        for b in buckets()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = _counts()
    want = dict(dict.fromkeys(KERNELS, 0),
                fused_sgd=MAIN_STEPS * bundle.layout.num_buckets)
    expect = [(s + 1) % sub == 0 for s in range(MAIN_STEPS)]
    copy = PackedParams([b.detach().clone() for b in buckets()],
                        bundle.layout)
    mean_ms = time_ms(lambda: _replica_mean(copy), reps=5)
    nbytes = sum(b.numel() * b.element_size() * 2 for b in copy.buckets)
    del copy
    losses = [h["loss"] for h in tr.history]
    res = {"layers": cfg.n_layers, "d_model": cfg.d_model, "dp": DP,
           "seq": SEQ, "per_replica": PER_REPLICA, "protocol": protocol,
           "period": bundle.protocol.period, "substeps": sub,
           "num_buckets": bundle.layout.num_buckets, "losses": losses,
           "ms_per_step_checked": (t1 - t0) * 1e3 / MAIN_STEPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "expected_launches": want,
           "replicas_identical_after_step": same,
           "replica_mean_ms": mean_ms,
           "replica_mean_ms_per_step": mean_ms / sub,
           "replica_mean_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log(f"[{name}] " + json.dumps(res))
    assert all(math.isfinite(v) for v in losses), "non-finite loss"
    assert abs(losses[0] - math.log(cfg.vocab)) <= 1.0, losses[0]
    assert counts == want, (counts, want)
    assert same == expect, (same, expect)
    assert _finite_buckets(tr), "non-finite parameters"
    res["profile"] = profile_step(name, tr)
    del tr, bundle
    torch.cuda.empty_cache()
    return res


def phase_ckpt(name, cfg, dev, pad_to=None, **proto):
    """Save after 4 steps, restore into a fresh state drawn with another
    seed (every tensor, ``step`` and ``t`` bit-equal to what was saved),
    run 4 more and hold the result against a straight 8-step run: bit for
    bit when two straight runs are bit-equal on the card, else within
    their own difference. ``pad_to`` also restores the file into a ring
    of that depth: the saved slots bit-equal, the new ones invalid."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.train import Trainer, init_train_state
    half, steps = SHORT_STEPS, 2 * SHORT_STEPS

    def run(n):
        bundle, tr = _train(cfg, fused=True, steps=steps, dev=dev, **proto)
        tr.run(n)
        return bundle, tr

    def fresh(bundle, seed, inbox=None):
        return init_train_state(
            cfg, bundle.optimizer, dp=DP, packed=True, layout=bundle.layout,
            seed=seed, device=dev, wire=bundle.wire,
            inbox=bundle.protocol.staleness if inbox is None else inbox)

    _, a = run(steps)
    _, b = run(steps)
    deterministic = _states_equal(b.state, a.state)
    spread = _states_diff(b.state, a.state)
    del b
    bundle, tr = run(half)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_state(d, tr.state, step=half, metadata={
            "protocol": proto.get("protocol", "gossip")})
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "arrays.npz"))
        template = fresh(bundle, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rest, man = restore_state(d, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del template
        assert man["step"] == half
        assert _states_equal(rest, tr.state), "restored state differs"
        assert all(b.requires_grad and b.is_leaf
                   and b.device.type == dev.type
                   for b in rest["params"].buckets)
        padded = None
        if pad_to:
            deep, _ = restore_state(d, fresh(bundle, seed=2, inbox=pad_to))
            old, new = tr.state["inbox"], deep["inbox"]
            k = len(old["slots"])
            assert len(new["slots"]) == pad_to and new["t"] == old["t"]
            assert _states_equal(new["slots"][:k], old["slots"])
            assert (new["valid"][:, :k] == old["valid"]).all()
            assert not new["valid"][:, k:].any()
            padded = {"from": k, "to": pad_to, "t": new["t"]}
            del deep
    finally:
        shutil.rmtree(d, ignore_errors=True)
    resumed = Trainer(bundle, rest, tr.dataset, log_every=0)
    resumed.run(half, start_step=half)
    losses = [h["loss"] for h in tr.history + resumed.history]
    straight = [h["loss"] for h in a.history]
    if deterministic:
        held = "bit-equal"
        assert losses == straight, (losses, straight)
        assert _states_equal(resumed.state, a.state), "resume differs"
        resume_diff = 0.0
    else:
        held = "within the straight runs' own difference"
        resume_diff = _states_diff(resumed.state, a.state)
        assert resume_diff <= spread, (resume_diff, spread)
    res = {"layers": cfg.n_layers, "dp": DP, "steps": f"{half}+{half}",
           **proto, "straight_runs_bit_equal": deterministic,
           "straight_runs_max_diff": spread, "resume_held": held,
           "resume_max_diff": resume_diff, "losses": losses,
           "bytes_on_disk": nbytes, "save_s": save_s,
           "restore_s": restore_s, "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "mask_pad": padded}
    log(f"[{name}] " + json.dumps(res))
    del a, tr, rest, resumed, bundle
    torch.cuda.empty_cache()
    return res


def phase_agree(dev):
    """Small fp32 runs on the card (kernels) and on the CPU (plain
    versions) from one init agree: sgd, adamw and lars."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init, reduced
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype="float32", compute_dtype="float32")
    init = lm_init(cfg, seed=0, device="cpu")
    steps = 4
    cases = [("sync fused", True, {}),
             ("async int8 sub0.5 fused", True, ASYNC_WIRE),
             ("async int8 sub0.5 unfused", False, ASYNC_WIRE),
             ("sync bf16-wire unfused", False, dict(wire_dtype="bf16"))]
    cases += [(f"{o} {name}", fused, dict(proto, optimizer=o))
              for o in ("adamw", "lars")
              for name, fused, proto in (("sync fused", True, {}),
                                         ("async int8 sub0.5 fused", True,
                                          ASYNC_WIRE),
                                         ("sync unfused", False, {}))]
    for name, fused, proto in cases:
        opt = proto.get("optimizer", "sgd")
        out = {}
        with _bucket_bytes(AGREE_BUCKET_BYTES):
            for d in ("cpu", dev):
                params = tree_map(lambda t, d=d: t.to(d), init)
                bundle, tr = _train(cfg, fused=fused, steps=steps, dev=d,
                                    params=params, seq=16, per_replica=2,
                                    lr=AGREE_LR[opt], **proto)
                assert bundle.layout.num_buckets == 5
                losses = [h["loss"] for h in tr.run(steps)]
                out[str(d)] = (losses, [b.detach().cpu().numpy() for b in
                                        tr.state["params"].buckets])
        (lc, bc), (lg, bg) = out["cpu"], out[str(dev)]
        rec = _assert_agree(name, opt, proto, steps, (lc, bc), (lg, bg))
        log(f"[agree] {name}: card vs cpu losses " + json.dumps(rec))


def _assert_agree(name, opt, proto, steps, cpu, card) -> dict:
    """[agree]'s rule between a CPU and a card run (losses, buckets as
    numpy): within rtol = atol = 2e-4, but for at most 0.1% of elements one
    wire code step (AdamW: 2 * lr * steps) apart."""
    (lc, bc), (lg, bg) = cpu, card
    np.testing.assert_allclose(lg, lc, rtol=2e-4, atol=2e-4)
    # AdamW's first steps move an element by about lr times the sign
    # of its gradient, which a rounding-level gradient may flip
    sign_flip = 2 * AGREE_LR[opt] * steps if opt == "adamw" else 0.0
    flips = total = 0
    for a, b in zip(bg, bc):
        bad = ~np.isclose(a, b, rtol=2e-4, atol=2e-4)
        step = _code_step(b, proto.get("wire_dtype"))
        assert (np.abs(a - b)[bad] <= step[bad] * 1.001 + sign_flip
                + 2e-4).all(), name
        flips += int(bad.sum())
        total += a.size
    assert flips <= 1e-3 * total, (name, flips, total)
    return {"cuda": lg, "cpu": lc, "code_step_or_sign_elements": flips,
            "elements": total}


def _small_cfg():
    """[agree]'s reduced fp32 qwen3-0.6b (2 layers, d 64)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                               param_dtype="float32", compute_dtype="float32")


def phase_leaf_kernel_gap(main_res, kernel_res):
    """[leaf_kernel] against [leaf_main] after the same 8 steps: the
    kernel mixes in fp32 and rounds once, the default mix rounds each bf16
    op, so the two part where a product rounds; at alpha 0.5 both products
    are exact and the runs are deterministic (``[ckpt]``'s straight runs),
    so every element must be equal."""
    diff, differ, total = 0.0, 0, 0
    for a, b in zip(kernel_res.pop("params"), main_res.pop("params")):
        d = (a.float() - b.float()).abs()
        diff = max(diff, float(d.max()))
        differ += int((d > 0).sum())
        total += d.numel()
    rec = {"max_abs_diff_params": diff, "elements_differing": differ,
           "elements": total, "losses_kernel": kernel_res["losses"],
           "losses_default": main_res["losses"]}
    log("[leaf_kernel] against [leaf_main]: " + json.dumps(rec))
    assert differ == 0 and kernel_res["losses"] == main_res["losses"], rec
    torch.cuda.empty_cache()
    return rec


def phase_leaf_mix_check(cfg, dev, dp=DP):
    """``gossip_mix_1d`` on every leaf of the per-leaf path at full width
    (the leaves of ``lm_specs(cfg)``, layers stacked, in the params' dtype,
    ``dp`` replicas, schedule row 1) against its plain version and against
    the default per-leaf mix on the same inputs, one leaf at a time: bit
    for bit (alpha 0.5: both products exact, one rounding of the sum).
    These launches are made outside the counted runs."""
    from repro_torch.core import build_schedule, make_gossip_mix
    from repro_torch.kernels import gossip_mix_1d, gossip_mix_plain
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    sched = build_schedule(dp)
    default = make_gossip_mix(sched)
    kernel = make_gossip_mix(sched, mix_impl=gossip_mix_1d)
    rf = torch.as_tensor(np.asarray(sched.recv_from(1), np.int64),
                         device=dev)
    dtype = getattr(torch, cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    err, shapes = 0.0, []
    for spec in tree_flatten(lm_specs(cfg))[0]:
        x = torch.randn((dp,) + tuple(spec.shape), generator=gen,
                        device=dev).to(dtype)
        flat = x.view(dp, -1)
        want = gossip_mix_plain(flat, flat.index_select(0, rf), 0.5)
        got = kernel({"w": x.clone()}, 1)["w"].view(dp, -1)
        ref = default({"w": x.clone()}, 1)["w"].view(dp, -1)
        err = max(err, float((got.float() - want.float()).abs().max()))
        assert _same_bits(got, want), (spec.shape, "vs plain")
        assert _same_bits(got, ref), (spec.shape, "vs default mix")
        shapes.append(list(spec.shape))
        del x, flat, want, got, ref
    torch.cuda.empty_cache()
    rec = {"leaves": len(shapes), "dp": dp, "dtype": cfg.param_dtype,
           "max_abs_err": err, "bit_equal": True, "shapes": shapes}
    log("[leaf_mix_check] gossip_mix_1d vs plain and default mix: "
        + json.dumps(rec))
    return rec


def phase_leaf_agree(dev, steps=SHORT_STEPS):
    """Per-leaf with the mix kernel under every leaf against packed
    ``fused_update=False`` on the card, from one init at [agree]'s size:
    the same arithmetic (fp32 mixes, the tree-level sgd), so predicted bit
    for bit; the gap and the share of differing elements are reported."""
    from repro_torch.kernels import gossip_mix_1d
    from repro_torch.models import lm_init
    cfg = _small_cfg()
    init = lm_init(cfg, seed=0, device=dev)
    runs = {}
    for name, kw in (("leaf_kernel", dict(packed=False,
                                          mix_impl=gossip_mix_1d)),
                     ("packed_unfused", dict(packed=True))):
        _, tr = _train(cfg, fused=False, steps=steps, dev=dev, params=init,
                       seq=16, per_replica=2, lr=AGREE_LR["sgd"], **kw)
        losses = [h["loss"] for h in tr.run(steps)]
        runs[name] = (losses, _leaf_view(tr.state["params"]))
    (la, pa), (lb, pb) = runs["leaf_kernel"], runs["packed_unfused"]
    same = la == lb and all(_same_bits(a, b) for a, b in zip(pa, pb))
    gap = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    rec = {"steps": steps, "bit_equal": same, "max_abs_diff_params": gap,
           "losses_leaf": la, "losses_packed": lb}
    log("[leaf_agree] per-leaf (gossip_mix_1d) vs packed unfused: "
        + json.dumps(rec))
    assert same, rec
    return rec


def _sim_run(cfg, dev, steps, protocol, init, dp=DP, **async_kw):
    """The port's simulator (core.simulate) on the card from ``init``, fed
    the Trainer's batches: losses per step and the final params."""
    from repro_torch.core import build_schedule
    from repro_torch.core import simulate as S
    from repro_torch.core.async_gossip import init_inbox_ring
    from repro_torch.data import ShardedTokenDataset, make_replica_batches
    from repro_torch.train import make_loss_fn
    opt = make_optimizer("sgd", steps, AGREE_LR["sgd"])
    sched = build_schedule(dp)
    params = S.replicate(init, dp)
    st = opt.init(params)
    ds = ShardedTokenDataset(cfg.vocab, 16, n_shards=dp, batch_per_shard=2)
    if async_kw:
        step = S.make_async_sim_train_step(make_loss_fn(cfg), opt, sched,
                                           **async_kw)
        ring = init_inbox_ring(params, async_kw["staleness"], dp)
    else:
        step = S.make_sim_train_step(make_loss_fn(cfg), opt, sched,
                                     protocol=protocol)
    losses = []
    for t in range(steps):
        toks = make_replica_batches(ds, t, dp)["tokens"]
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if async_kw:
            st, params, ring, m = step(st, params, ring, batch, t)
        else:
            st, params, m = step(st, params, batch, t)
        losses.append(float(m["loss"]))
    return losses, _leaf_view(params)


def _engine_run(cfg, dev, steps, init, **kw):
    _, tr = _train(cfg, fused=False, steps=steps, dev=dev, params=init,
                   seq=16, per_replica=2, lr=AGREE_LR["sgd"], **kw)
    losses = [h["loss"] for h in tr.run(steps)]
    return losses, _leaf_view(tr.state["params"])


def _wire_oracle_case(dev, k=2, drop=0.2, phases=6, layout=None, dp=DP):
    """The packed unfused async engine on the int8 wire at subset 0.5
    against ``gossip_mix_sim_quantized_k`` on the card, step for step from
    one state: params, the newest slot's codes and scales, ``valid``
    (``layout``: [agree]'s flat one by default)."""
    from repro_torch.core import (PackedParams, build_layout, build_schedule,
                                  make_packed_async_gossip_mix)
    from repro_torch.core import simulate as S
    from repro_torch.core.async_gossip import (exchange_ok,
                                               init_wire_inbox_ring)
    from repro_torch.kernels.quantize import WireFormat
    from repro_torch.models import lm_init
    if layout is None:
        init = lm_init(_small_cfg(), seed=0, device=dev)
        layout = build_layout(init, target_bucket_bytes=AGREE_BUCKET_BYTES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    buckets = [torch.randn((dp, n), generator=gen, device=dev)
               for n in layout.bucket_sizes]
    wire = WireFormat("int8", 0.5, seed=3)
    sched = build_schedule(dp)
    mix = make_packed_async_gossip_mix(sched, layout, staleness=k,
                                       drop_rate=drop, drop_seed=1,
                                       wire=wire)
    params = PackedParams([b.clone() for b in buckets], layout)
    ring = init_wire_inbox_ring(params, k, dp, wire)
    want, wring = [b.clone() for b in buckets], dict(ring)
    same = True
    for t in range(phases):
        ok = exchange_ok(wring["t"], np.arange(dp), 1, drop)
        want, wring = S.gossip_mix_sim_quantized_k(
            want, wring, sched.recv_from(t), wire=wire, ok=ok)
        params, ring = mix(params, ring, t)
        same &= all(_same_bits(a, b) for a, b in zip(params.buckets, want))
        for g, w in zip(ring["slots"][-1], wring["slots"][-1]):
            g = [g["q"], g["s"]] if isinstance(g, dict) else [g]
            w = [w["q"], w["s"]] if isinstance(w, dict) else [w]
            same &= all(torch.equal(a, b) for a, b in zip(g, w))
        same &= bool(np.array_equal(ring["valid"], wring["valid"]))
    return same


def phase_sim_agree(dev, steps=SHORT_STEPS):
    """The port's own oracle on the card: ``make_sim_train_step`` against
    the engines' Trainer runs (per-leaf and packed unfused gossip, agd,
    every_logp, none) and ``make_async_sim_train_step`` (k 2, drop 0.2,
    fp32 wire) against the per-leaf and packed unfused async engines, from
    one init at [agree]'s size; bit for bit, as the CPU tests find them.
    The int8 wire at subset 0.5: the packed async engine against
    ``gossip_mix_sim_quantized_k`` step by step, bit for bit; the async
    simulator's leaf-as-bucket wire (the reference's science twin, which
    no engine computes) on the card against the CPU within rtol = atol =
    2e-4."""
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_map
    cfg = _small_cfg()
    init = lm_init(cfg, seed=0, device=dev)
    async_kw = dict(staleness=2, drop_rate=0.2)
    cases = [("gossip per-leaf", "gossip", dict(packed=False), {}),
             ("gossip packed unfused", "gossip", dict(packed=True), {}),
             ("agd per-leaf", "agd", dict(packed=False, protocol="agd"), {}),
             ("every_logp per-leaf", "every_logp",
              dict(packed=False, protocol="every_logp"), {}),
             ("none per-leaf", "none", dict(packed=False, protocol="none"),
              {}),
             ("gossip_async per-leaf", None,
              dict(packed=False, protocol="gossip_async", **async_kw),
              async_kw),
             ("gossip_async packed unfused", None,
              dict(packed=True, protocol="gossip_async", **async_kw),
              async_kw)]
    out = {}
    for name, proto, kw, akw in cases:
        ls, ps = _sim_run(cfg, dev, steps, proto, init, **akw)
        le, pe = _engine_run(cfg, dev, steps, init, **kw)
        same = ls == le and all(_same_bits(a, b) for a, b in zip(pe, ps))
        gap = max(float((a - b).abs().max()) for a, b in zip(pe, ps))
        out[name] = {"bit_equal": same, "max_abs_diff_params": gap}
    out["int8 sub0.5 packed async vs gossip_mix_sim_quantized_k"] = {
        "bit_equal": _wire_oracle_case(dev)}
    wire_kw = dict(async_kw, wire_dtype="int8", gossip_subset=0.5)
    cpu_init = tree_map(lambda x: x.cpu(), init)
    lg, pg = _sim_run(cfg, dev, steps, None, init, **wire_kw)
    lc, pc = _sim_run(cfg, torch.device("cpu"), steps, None, cpu_init,
                      **wire_kw)
    close = bool(np.allclose(lg, lc, rtol=2e-4, atol=2e-4)) and all(
        np.allclose(a.cpu().numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
        for a, b in zip(pg, pc))
    out["async sim int8 sub0.5: card vs cpu"] = {"within_2e-4": close}
    log("[sim_agree] " + json.dumps(out))
    bad = [k for k, v in out.items() if not (v.get("bit_equal")
                                              or v.get("within_2e-4"))]
    assert not bad, bad
    return out


def _plan(pod: int, data: int, model: int, mode: str):
    """The distribution plan of the smoke mesh (pod, data, model)."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import make_distribution
    return make_distribution(make_smoke_mesh(data, model, pod=pod), mode)


def phase_hier_gap(main_res, hier_res):
    """[hier_main] against [main] after the same 8 steps: the shard-local
    layout moves bytes, not arithmetic, so every param element and loss
    must be equal."""
    differ = total = 0
    for a, b in zip(hier_res.pop("params"), main_res.pop("params")):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        ints = _INT_OF_SIZE[a.element_size()]
        differ += int((a.view(ints) != b.view(ints)).sum())
        total += a.numel()
    rec = {"elements_differing": differ, "elements": total,
           "losses_equal": hier_res["losses"] == main_res["losses"],
           "num_shards": hier_res["num_shards"],
           "num_buckets": hier_res["num_buckets"],
           "main_num_buckets": main_res["num_buckets"]}
    log("[hier_main] against [main]: " + json.dumps(rec))
    assert differ == 0 and rec["losses_equal"], rec
    torch.cuda.empty_cache()
    return rec


def phase_hier_agree(dev, steps=SHORT_STEPS):
    """[agree]'s reduced fp32 model on the fsdp (2, 2, 2) shard-local layout
    (dp 2 over the pods, 4 shards): each case on the card against the same
    on the CPU under [agree]'s rule, and, on the fp32 wire, against the
    flat layout over dp 2 on the card bit for bit; the port's simulator
    against the shard-local packed unfused engines (sync and async k 2,
    drop 0.2) on the card, and the int8 ring at subset 0.5 against
    ``gossip_mix_sim_quantized_k`` on the shard-local buckets, bit for
    bit."""
    from repro_torch.models import lm_init
    from repro_torch.train.step import _build_packed_layout
    from repro_torch.tree import tree_map
    cfg = _small_cfg()
    fsdp = _plan(2, 2, 2, "fsdp")
    init = lm_init(cfg, seed=0, device="cpu")
    cases = [("sync fused", True, {}), ("sync unfused", False, {}),
             ("async int8 sub0.5 fused", True, ASYNC_WIRE),
             ("async int8 sub0.5 unfused", False, ASYNC_WIRE),
             ("adamw sync fused", True, dict(optimizer="adamw"))]
    out = {}
    with _bucket_bytes(AGREE_BUCKET_BYTES):
        for name, fused, proto in cases:
            opt = proto.get("optimizer", "sgd")
            runs = {}
            for tag, d, dist in (("card", dev, fsdp), ("cpu", "cpu", fsdp),
                                 ("card_flat", dev, None)):
                if tag == "card_flat" and "wire_dtype" in proto:
                    continue   # the wire's tiles follow the layout
                params = tree_map(lambda t, d=d: t.to(d), init)
                bundle, tr = _train(cfg, fused=fused, steps=steps, dev=d,
                                    params=params, seq=16, per_replica=2,
                                    lr=AGREE_LR[opt], dist=dist, dp=fsdp.dp,
                                    **proto)
                assert bundle.fused == fused and bundle.dp == fsdp.dp
                assert bundle.layout.num_shards == (4 if dist else 1)
                losses = [h["loss"] for h in tr.run(steps)]
                params = tr.state["params"]
                runs[tag] = (losses, _leaf_view(params),
                             [b.detach().cpu().numpy()
                              for b in params.buckets])
            rec = _assert_agree(name, opt, proto, steps,
                                (runs["cpu"][0], runs["cpu"][2]),
                                (runs["card"][0], runs["card"][2]))
            rec["num_buckets"] = len(runs["card"][2])
            if "card_flat" in runs:
                (lh, ph, _), (lf, pf, _) = runs["card"], runs["card_flat"]
                rec["bit_equal_to_flat"] = lh == lf and all(
                    _same_bits(a, b) for a, b in zip(ph, pf))
            out[name] = rec
        layout = _build_packed_layout(fsdp, cfg)
    init = tree_map(lambda t: t.to(dev), init)
    async_kw = dict(staleness=2, drop_rate=0.2)
    for name, proto, kw, akw in (
            ("sim gossip vs packed unfused", "gossip", {}, {}),
            ("async sim vs packed unfused", None,
             dict(protocol="gossip_async", **async_kw), async_kw)):
        ls, ps = _sim_run(cfg, dev, steps, proto, init, dp=fsdp.dp, **akw)
        le, pe = _engine_run(cfg, dev, steps, init, dist=fsdp, **kw)
        out[name] = {"bit_equal": ls == le and all(
            _same_bits(a, b) for a, b in zip(pe, ps))}
    out["int8 sub0.5 ring vs gossip_mix_sim_quantized_k"] = {
        "bit_equal": _wire_oracle_case(dev, layout=layout, dp=fsdp.dp),
        "num_buckets": layout.num_buckets}
    log("[hier_agree] " + json.dumps(out))
    bad = [k for k, v in out.items()
           if v.get("bit_equal") is False or v.get("bit_equal_to_flat")
           is False]
    assert not bad, bad
    return out


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
    failures = []
    seconds = {}   # wall seconds of each guarded phase, for the time limit

    def guard(name, fn, *args, **kw):
        """Run one phase; a failure is recorded and the next phase runs."""
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        except Exception:  # noqa: BLE001 - every phase failure is reported
            traceback.print_exc()
            log(f"[FAIL] {name}")
            failures.append(name)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            return None
        finally:
            seconds[name] = round(time.perf_counter() - t0, 1)

    phase_build()
    cfg = get_config("qwen3-0.6b")
    short = dataclasses.replace(cfg, blocks=cfg.blocks[:SHORT_LAYERS])
    layout = build_layout(lm_specs(cfg))
    err = guard("check", phase_kernels, layout, dev) or {}
    err.update(guard("check_opt", phase_kernels_opt, layout, dev) or {})
    timing = guard("time", phase_time, layout, dev) or {}
    timing.update(guard("time_opt", phase_time_opt, layout, dev) or {})
    err.update(guard("check_ssm", phase_check_ssm, dev) or {})
    err.update(guard("check_attn", phase_check_attn, dev) or {})
    timing.update(guard("time_ssm", phase_time_ssm, dev) or {})
    timing.update(guard("time_attn", phase_time_attn, dev) or {})

    def none(**kw):
        return dict(dict.fromkeys(KERNELS, 0), **kw)

    main_res = guard(
        "main", run_path, "main", cfg, dev, fused=True, steps=MAIN_STEPS,
        profile=True, keep_params="cpu",
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets))
    # the shard-local layout: main's run on mesh (1, 4, 2), replica mode
    # (dp 4, each replica's leaves sharded over model in 2)
    hier_res = guard(
        "hier_main", run_path, "hier_main", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, keep_params="cpu",
        dist=_plan(1, DP, 2, "replica"),
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets))
    if main_res is not None and hier_res is not None:
        guard("hier_main_gap", phase_hier_gap, main_res, hier_res)
    for res in (main_res, hier_res):
        if res is not None:
            res.pop("params", None)
    torch.cuda.empty_cache()
    if main_res is not None and hier_res is not None:
        log("[hier_main] against [main], one call: " + json.dumps(
            {k: {"ms_per_step": r["ms_per_step"],
                 "step_ms_unprofiled": r["profile"]["step_ms_unprofiled"],
                 "device_busy_ms": r["profile"]["device_busy_ms"],
                 "peak_mem_gb": r["peak_mem_gb"],
                 "cat_ms": r["profile"]["device_ms_by_kernel_name"][
                     "CatArrayBatchedCopy"]}
             for k, r in (("main", main_res), ("hier_main", hier_res))}))
    hier_fsdp_res = guard(
        "hier_fsdp", run_path, "hier_fsdp", short, dev, fused=True,
        steps=SHORT_STEPS, dist=_plan(2, 2, 2, "fsdp"),
        expect=lambda b: none(fused_sgd=SHORT_STEPS * b.layout.num_buckets,
                              fused_sgd_q=consumed(b, SHORT_STEPS)),
        **ASYNC_WIRE)
    async_res = guard(
        "async_wire", run_path, "async_wire", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True,
        expect=lambda b: none(fused_sgd=MAIN_STEPS * b.layout.num_buckets,
                              fused_sgd_q=consumed(b, MAIN_STEPS)),
        **ASYNC_WIRE)
    if async_res is not None and async_res["launches"]["fused_sgd"] != 104:
        failures.append(f"async_wire launches {async_res['launches']}")
    adamw_res = guard(
        "adamw_wire", run_path, "adamw_wire", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, optimizer="adamw",
        expect=lambda b: none(fused_adamw=MAIN_STEPS * b.layout.num_buckets,
                              fused_adamw_q=consumed(b, MAIN_STEPS)),
        **ASYNC_WIRE)
    lars_res = guard(
        "lars_main", run_path, "lars_main", cfg, dev, fused=True,
        steps=MAIN_STEPS, profile=True, optimizer="lars",
        expect=lambda b: none(fused_lars=MAIN_STEPS * b.layout.num_buckets))
    for name, res, key in (("adamw_wire", adamw_res, "fused_adamw"),
                           ("lars_main", lars_res, "fused_lars")):
        if res is not None and res["launches"][key] != 104:
            failures.append(f"{name} {key} launches {res['launches']}")
    if lars_res is not None and "fused_lars" in timing:
        pre = timing["fused_lars"]["prepass_ms_per_step"]
        log("[lars_main] prepass share of the step: " + json.dumps(
            {"prepass_ms_per_step": pre,
             "ms_per_step": lars_res["ms_per_step"],
             "share": pre / lars_res["ms_per_step"]}))
    agd_res = guard("agd_main", phase_averaging, "agd_main", cfg, dev,
                    "agd")
    logp_res = guard("every_logp_main", phase_averaging, "every_logp_main",
                     cfg, dev, "every_logp")
    if main_res is not None and agd_res is not None and logp_res is not None:
        log("[baselines] ms/step unprofiled, one call: " + json.dumps(
            {k: r["profile"]["step_ms_unprofiled"] for k, r in
             (("main", main_res), ("agd_main", agd_res),
              ("every_logp_main", logp_res))}))
    # the other adamw and lars paths, at 2 layers to keep the call short
    guard("adamw_sync", run_path, "adamw_sync", short, dev, fused=True,
          steps=SHORT_STEPS, optimizer="adamw",
          expect=lambda b: none(
              fused_adamw=SHORT_STEPS * b.layout.num_buckets))
    guard("lars_async", run_path, "lars_async", short, dev, fused=True,
          steps=SHORT_STEPS, optimizer="lars",
          expect=lambda b: none(
              fused_lars=SHORT_STEPS * b.layout.num_buckets),
          **ASYNC_WIRE)
    guard("adamw_unfused", run_path, "adamw_unfused", short, dev,
          fused=False, steps=SHORT_STEPS, optimizer="adamw",
          expect=lambda b: none(
              gossip_mix=SHORT_STEPS * b.layout.num_buckets))
    guard("lars_unfused", run_path, "lars_unfused", short, dev, fused=False,
          steps=SHORT_STEPS, optimizer="lars",
          expect=lambda b: none(gossip_mix_q=consumed(b, SHORT_STEPS)),
          **ASYNC_WIRE)
    q_res = guard(
        "async_unfused", run_path, "async_unfused", short, dev, fused=False,
        steps=SHORT_STEPS,
        expect=lambda b: none(gossip_mix_q=consumed(b, SHORT_STEPS)),
        **ASYNC_WIRE)
    guard("sync_fp8", run_path, "sync_fp8", short, dev, fused=True,
          steps=SHORT_STEPS,
          expect=lambda b: none(fused_sgd=SHORT_STEPS * b.layout.num_buckets,
                                fused_sgd_q=consumed(b, SHORT_STEPS)),
          wire_dtype="fp8")
    guard("ckpt", phase_ckpt, "ckpt", short, dev)
    guard("ckpt_async", phase_ckpt, "ckpt_async", short, dev, pad_to=4,
          **ASYNC_WIRE)
    guard("agree", phase_agree, dev)
    # the per-leaf engines (the launcher's default path), full width
    from repro_torch.kernels import gossip_mix_1d
    leaves = _num_leaves(cfg)
    leaf_res = guard(
        "leaf_main", run_path, "leaf_main", cfg, dev, fused=False,
        steps=MAIN_STEPS, profile=True, keep_params=True, packed=False,
        expect=lambda b: none())
    leaf_kernel_res = guard(
        "leaf_kernel", run_path, "leaf_kernel", cfg, dev, fused=False,
        steps=MAIN_STEPS, keep_params=True, packed=False,
        mix_impl=gossip_mix_1d,
        expect=lambda b: none(gossip_mix=MAIN_STEPS * leaves))
    if leaf_res is not None and leaf_kernel_res is not None:
        guard("leaf_kernel_gap", phase_leaf_kernel_gap, leaf_res,
              leaf_kernel_res)
    for res in (leaf_res, leaf_kernel_res):
        if res is not None:
            res.pop("params", None)
    torch.cuda.empty_cache()
    leaf_mix = guard("leaf_mix_check", phase_leaf_mix_check, cfg, dev) or {}
    guard("leaf_async", run_path, "leaf_async", cfg, dev, fused=False,
          steps=MAIN_STEPS, profile=True, packed=False,
          protocol="gossip_async", staleness=2, drop_rate=0.2,
          expect=lambda b: none())
    guard("leaf_agree", phase_leaf_agree, dev)
    guard("sim_agree", phase_sim_agree, dev)
    guard("hier_agree", phase_hier_agree, dev)
    unfused_res = guard(
        "unfused", run_path, "unfused", short, dev, fused=False,
        steps=SHORT_STEPS,
        expect=lambda b: none(gossip_mix=SHORT_STEPS * b.layout.num_buckets))
    flash_res = guard("flash_path", phase_flash_path, dev)
    mamba_res = guard("mamba_eval", phase_mamba_eval, dev)
    guard("mamba_agree", phase_mamba_agree, dev)
    if failures:
        log(f"[done] {time.perf_counter() - t_start:.1f}s; failed phases: "
            f"{failures}; phase seconds {json.dumps(seconds)}")
        return 1

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        ("fused_sgd", "fused_sgd.cu", "src/repro/kernels/fused_update.py:233",
         "main (sync fused)", main_res),
        ("fused_sgd_q", "fused_sgd.cu",
         "src/repro/kernels/fused_update.py:233",
         "async_wire (gossip_async int8 sub 0.5, fused; partner_scales)",
         async_res),
        ("gossip_mix", "gossip_mix.cu", "src/repro/kernels/gossip_mix.py:83",
         "unfused (sync --no-fused-update)", unfused_res),
        ("gossip_mix_q", "gossip_mix.cu",
         "src/repro/kernels/gossip_mix.py:142",
         "async_unfused (gossip_async int8 sub 0.5, unfused)", q_res),
        ("fused_adamw", "fused_adamw.cu",
         "src/repro/kernels/fused_update.py:316",
         "adamw_wire (adamw, gossip_async int8 sub 0.5, fused)", adamw_res),
        ("fused_lars", "fused_lars.cu",
         "src/repro/kernels/fused_update.py:366",
         "lars_main (lars, sync gossip, fused)", lars_res),
        ("ssm_scan", "ssm_scan.cu", "src/repro/kernels/ssm_scan.py:58",
         f"mamba_eval (falcon-mamba-7b scoring, 64 layers, {EVAL_B} x "
         f"{EVAL_S} tokens, {EVAL_FORWARDS} forwards)", mamba_res),
        ("flash_attention", "flash_attention.cu",
         "src/repro/kernels/flash_attention.py:97",
         f"flash_path (flash_mha on a bf16 qwen3-0.6b attention layer, "
         f"S {ATTN_S}, causal, fp32 q and k, bf16 v)", flash_res),
    ]
    timing["flash_attention"] = flash_res["timing"]
    kernels = [dict(name=name, route="cuda", source=src + f,
                    replaces=rep, path=path, launches=res["launches"][name],
                    max_abs_err=err[name], **timing[name])
               for name, f, rep, path, res in rows]
    # the scaled AdamW launches (wire codes decoded in the sweep) ride in
    # fused_adamw's entry: their count, error and times
    by_name = {k["name"]: k for k in kernels}
    q = timing["fused_adamw_q"]
    by_name["fused_adamw"].update(
        launches_q=adamw_res["launches"]["fused_adamw_q"],
        max_abs_err=max(err["fused_adamw"], err["fused_adamw_q"]),
        max_abs_err_q=err["fused_adamw_q"], ms_q=q["ms"],
        ms_q_row_alpha=q["ms_row_alpha"], plain_ms_q=q["plain_ms"],
        bound_ms_q=q["bound_ms"])
    by_name["gossip_mix"]["launches_by_path"] = {
        "unfused": unfused_res["launches"]["gossip_mix"],
        "leaf_kernel": leaf_kernel_res["launches"]["gossip_mix"]}
    by_name["gossip_mix"]["launches"] = sum(
        by_name["gossip_mix"]["launches_by_path"].values())
    by_name["gossip_mix"]["max_abs_err_leaves"] = leaf_mix["max_abs_err"]
    by_name["gossip_mix"]["path"] += (
        f"; leaf_kernel (per-leaf sync gossip, mix_impl=gossip_mix_1d, "
        f"{MAIN_STEPS} steps x {leaves} leaves)")
    by_name["fused_sgd"]["launches_by_path"] = {
        "main": main_res["launches"]["fused_sgd"],
        "agd_main": agd_res["launches"]["fused_sgd"],
        "every_logp_main": logp_res["launches"]["fused_sgd"],
        "hier_main": hier_res["launches"]["fused_sgd"],
        "hier_fsdp": hier_fsdp_res["launches"]["fused_sgd"]}
    by_name["fused_sgd_q"]["launches_by_path"] = {
        "async_wire": async_res["launches"]["fused_sgd_q"],
        "hier_fsdp": hier_fsdp_res["launches"]["fused_sgd_q"]}
    by_name["ssm_scan"]["launches_per_forward"] = \
        mamba_res["ssm_scan_launches_per_forward"]
    flash = by_name["flash_attention"]
    flash.update(max_abs_err_bf16=err["flash_attention_bf16"],
                 **timing["flash_attention_bf16"])
    flash["share_of_bound"] = flash["bound_ms"] / flash["ms"]
    for suffix in ("_bf16", f"_bf16_{ATTN_S_LONG}"):
        flash["share_of_bound" + suffix] = (flash["bound_ms" + suffix]
                                            / flash["ms" + suffix])
    log(f"[done] {time.perf_counter() - t_start:.1f}s; phase seconds "
        f"{json.dumps(seconds)}")
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
