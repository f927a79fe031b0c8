"""The readings a cell's limits are set from, on the card at the cell's own
size (not run by the benchmark's runs):

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 1,2,3 [--fault-seeds 1,2,3] [--out calib_<name>.json]

Per seed: the program's first steps against the float32 reference (the
lower readings). Per control seed besides: the control (the reference with
fp8 products in the program's place); per fault seed (``--fault-seeds``,
the first three control seeds by default) the reference with each planted
fault (``half``: half of each replica's batch; ``no_exchange``: each
replica its own partner; ``wire_key``: the coded wire keyed by the wrong
dispatch, where the protocol codes one), each against the same float32
reference (the upper readings). A step that returns its state unchanged
reads 1 on ``change_gap`` by its definition.
Prints one JSON line per reading and a summary last.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def calibrate(cell, seeds, control_seeds, fault_seeds=None, device="cuda",
              log=print):
    import torch

    from portbench import compare, traffic, weights
    from portbench.kinds.train import program_readings
    from portbench.program import Program
    from portbench.reference.train import family, protocol, readings
    _, _, cfg, job, _ = cell
    fault_seeds = (control_seeds[:3] if fault_seeds is None
                   else fault_seeds)
    dev = torch.device(device)
    dtype = getattr(torch, cfg["param_dtype"])
    specs = family(cfg).leaf_specs(cfg)
    checked = int(job["checked_steps"])
    rows = []
    for seed in seeds:
        proto = int(seed) % (1 << 32)
        ring = traffic.make_ring(job, cfg["vocab"], seed, dev)
        leaves = weights.make(specs, seed, dev, dtype)
        prog = Program(cfg, job, leaves, seed=proto, device=dev)
        del leaves
        nb = len(prog.bundle.layout.bucket_sizes)
        pay = protocol(job).checked_payloads(job, nb, proto)
        got = program_readings(prog, ring, specs, cfg, job, seed, dev, dtype,
                               payloads=pay)
        del prog
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        leaves = weights.make(specs, seed, dev, dtype)
        batches = ring[:checked]
        ref = readings(cfg, job, leaves, batches, seed=proto, payloads=pay)
        sides = {"program": got}
        if seed in control_seeds:
            sides["control_fp8"] = readings(cfg, job, leaves, batches,
                                            seed=proto, precision="fp8",
                                            payloads=pay)
        if seed in fault_seeds:
            faults = ["half", "no_exchange"] + (["wire_key"] if pay else [])
            for fault in faults:
                sides[f"fault_{fault}"] = readings(cfg, job, leaves, batches,
                                                   seed=proto, fault=fault,
                                                   payloads=pay)
        for side, r in sides.items():
            r = dict(r, grad_norms=ref["grad_norms"])
            row = {"seed": seed, "side": side, **compare.gaps(r, ref),
                   "losses": r["losses"], "ref_losses": ref["losses"],
                   "held_norms": r["held_norms"],
                   "ref_held_norms": ref["held_norms"],
                   "change_norms": r["change_norms"],
                   "ref_change_norms": ref["change_norms"],
                   "grad_norms": ref["grad_norms"]}
            rows.append(row)
            log(json.dumps(row))
        del leaves, ring
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for side in dict.fromkeys(r["side"] for r in rows):
        mine = [r for r in rows if r["side"] == side]
        summary[side] = {k: {"min": min(r[k] for r in mine),
                             "max": max(r[k] for r in mine)}
                         for k in compare.NAMES if k in mine[0]}
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from portbench.run import load_cell, set_cache_dirs
    set_cache_dirs(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    faults = (None if args.fault_seeds is None else
              [int(s) for s in args.fault_seeds.split(",") if s])
    rows, summary = calibrate(load_cell(ROOT, args.workload), seeds, ctrl,
                              faults)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload,
                                              "rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
