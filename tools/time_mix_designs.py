#!/usr/bin/env python3
"""Time the design variants of the gossip arrival mix on one CUDA card.

    python3 tools/time_mix_designs.py [--rounds 7] [--out build/mix_designs.json]

Builds ``tools/gossip_mix_designs.cu`` (the port's nvcc flags), then on the
largest bucket of full-width qwen3-0.6b at dp=4, (4, 155,582,464) bf16:

1. holds every variant against the port's plain versions
   (``gossip_mix_plain``, ``gossip_mix_q_plain``) bit for bit, for a bf16
   partner and int8 codes, alpha 0.5 static and one alpha per replica row;
2. times, in ``--rounds`` interleaved rounds (each round every variant in
   turn, CUDA events over 10 launches), every variant, the port's own
   kernel (``gossip_mix_bucket``) and ``torch.lerp_`` (the yardstick of row
   1, another rounding, never called by the port); prints the median, min
   and max of each with the byte bound (3.35 TB/s; each input read once,
   the output written once) and the share of it.

Imports nothing of JAX or of the reference package. Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
DP = 4
# name -> (design, unroll, hint, persistent, stages, chunk_kb); hint bits:
# 1 partner ld.global.cs, 2 partner ld.global.nc.L1::no_allocate, 4 a
# ld.global.cs, 8 a st.global.cs (tools/gossip_mix_designs.cu)
VARIANTS = {
    "grid-stride": (0, 0, 0, 0, 0, 0),
    "batched U1 wave": (1, 1, 0, 0, 0, 0),
    "batched U2 wave": (1, 2, 0, 0, 0, 0),
    "batched U2 wave ldcs-b": (1, 2, 1, 0, 0, 0),
    "batched U2 wave stcs-a": (1, 2, 8, 0, 0, 0),
    "batched U2 wave ldcs-b stcs-a": (1, 2, 9, 0, 0, 0),
    "batched U2 wave ldcs-ab stcs-a": (1, 2, 13, 0, 0, 0),
    "batched U4 wave": (1, 4, 0, 0, 0, 0),
    "batched U4 wave ldcs-b": (1, 4, 1, 0, 0, 0),
    "batched U4 wave ldcs-ab": (1, 4, 5, 0, 0, 0),
    "batched U4 wave ldcs-b stcs-a": (1, 4, 9, 0, 0, 0),
    "batched U4 wave ldnc-b stcs-a": (1, 4, 10, 0, 0, 0),
    "batched U4 wave ldcs-ab stcs-a": (1, 4, 13, 0, 0, 0),
    "batched U4 persistent ldcs-b stcs-a": (1, 4, 9, 1, 0, 0),
    "batched U8 wave ldcs-b stcs-a": (1, 8, 9, 0, 0, 0),
    "bulk 4x8KB": (2, 4, 9, 0, 4, 8),
    "bulk 4x16KB": (2, 4, 9, 0, 4, 16),
    "bulk 6x16KB": (2, 4, 9, 0, 6, 16),
}


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "designs" / "libmix_designs.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(ROOT / "tools" / "gossip_mix_designs.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(r.stdout + r.stderr)
    if r.returncode:
        raise RuntimeError(r.stdout[-4000:] + r.stderr[-4000:])
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("[build]", line.strip())
    lib = ctypes.CDLL(str(out))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.mix_design_launch.argtypes = [I] * 7 + [P, P, P, LL, F, F, P, LL, P]
    lib.mix_design_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", default=str(ROOT / "build" / "mix_designs.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import build_layout
    from repro_torch.kernels import (gossip_mix_bucket, gossip_mix_plain,
                                     gossip_mix_q_plain)
    from repro_torch.kernels.gossip_mix import kernel_alpha
    from repro_torch.kernels.quantize import encode_wire, wire_key
    from repro_torch.models import lm_specs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("[card]", smi)
    lib = build()
    dev = torch.device("cuda")
    n = max(build_layout(lm_specs(get_config("qwen3-0.6b"))).bucket_sizes)
    gen = torch.Generator(device=dev).manual_seed(1)
    mk = lambda: torch.randn((DP, n), generator=gen, device=dev).bfloat16()  # noqa: E731
    a, b = mk(), mk()
    enc = encode_wire(mk(), "int8", keys=wire_key(0, range(DP), 0))
    row = torch.tensor([0.5, 0.25, 0.0, 0.5], device=dev)
    elems = DP * n
    stream = torch.cuda.current_stream().cuda_stream

    def call(variant, buf, partner, alpha):
        design, unroll, hint, pers, stages, ckb = VARIANTS[variant]
        keep, take, al_ptr, row_len, _hold = kernel_alpha(alpha, buf)
        coded = isinstance(partner, dict)
        rc = lib.mix_design_launch(
            design, unroll, hint, pers, stages, ckb, 2 if coded else 1,
            buf.data_ptr(), (partner["q"] if coded else partner).data_ptr(),
            partner["s"].data_ptr() if coded else None, buf.numel(), keep,
            take, al_ptr, row_len, stream)
        if rc:
            raise RuntimeError(f"{variant}: launch failed ({rc})")

    checks = {}
    for pname, partner in (("bf16", b), ("int8", enc)):
        for an, alpha in (("0.5", 0.5), ("per-row", row)):
            want = (gossip_mix_q_plain(a, enc["q"], enc["s"], alpha)
                    if pname == "int8" else gossip_mix_plain(a, b, alpha))
            for v in VARIANTS:
                got = a.clone()
                call(v, got, partner, alpha)
                torch.cuda.synchronize()
                eq = torch.equal(got, want)
                checks[f"{v} | {pname} | {an}"] = eq
                print(f"[check] {v} {pname} alpha {an}: equal={eq}")
                del got
            del want
            torch.cuda.empty_cache()

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    fns = {}
    for pname, partner in (("bf16", b), ("int8", enc)):
        for an, alpha in (("0.5", 0.5), ("per-row", row)):
            for v in VARIANTS:
                fns[f"{v} | {pname} | {an}"] = (
                    lambda v=v, p=partner, al=alpha: call(v, a, p, al))
            fns[f"port kernel | {pname} | {an}"] = (
                lambda p=partner, al=alpha: gossip_mix_bucket(a, p, al))
    fns["torch.lerp_ | bf16 | 0.5"] = lambda: a.lerp_(b, 0.5)
    times = {k: [] for k in fns}
    for _ in range(args.rounds):
        for k, fn in fns.items():
            times[k].append(time_ms(fn))
    bounds = {"bf16": 3 * 2 * elems / HBM_BYTES_PER_S * 1e3,
              "int8": (5 * elems + 4 * elems / 128) / HBM_BYTES_PER_S * 1e3}
    rows = {}
    for k, ts in times.items():
        pname = k.split(" | ")[1]
        med = statistics.median(ts)
        rows[k] = dict(median_ms=med, min_ms=min(ts), max_ms=max(ts),
                       bound_ms=bounds[pname],
                       share_of_bound=bounds[pname] / med)
        print(f"[time] {k}: " + json.dumps(rows[k]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": smi, "shape": [DP, n], "rounds": args.rounds,
         "checks": checks, "times": rows}, indent=1))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        print("[FAIL] not bit-equal:", bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
