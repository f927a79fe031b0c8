#!/usr/bin/env python3
"""Time train paths of ``chip_smoke.py`` from two checkouts in turn on one
card, to compare two versions of the port inside one call.

    python3 tools/ab_paths.py OLD_ROOT NEW_ROOT [--paths unfused,async_unfused]
        [--turns ABBAABBA] [--out build/ab_paths.json]

Each turn is a fresh process that imports that checkout's ``chip_smoke.py``
and drives each named path through its ``run_path`` (the smoke's own model,
steps, protocol and launch-count check: full-width qwen3-0.6b at 2 layers,
4 replicas, 4 steps), and reports its ms per step. Prints, per checkout and
path, every turn's value with their median, min and max. Imports nothing of
JAX or of the reference package. Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import dataclasses, json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
cfg = get_config("qwen3-0.6b")
short = dataclasses.replace(cfg, blocks=cfg.blocks[:cs.SHORT_LAYERS])
none = lambda **kw: dict(dict.fromkeys(cs.KERNELS, 0), **kw)
paths = {{
    "unfused": dict(expect=lambda b: none(
        gossip_mix=cs.SHORT_STEPS * b.layout.num_buckets)),
    "async_unfused": dict(expect=lambda b: none(
        gossip_mix_q=cs.consumed(b, cs.SHORT_STEPS)), **cs.ASYNC_WIRE),
}}
out = {{}}
for name in {names!r}:
    res = cs.run_path(name, short, torch.device("cuda"), fused=False,
                      steps=cs.SHORT_STEPS, **paths[name])
    out[name] = res["ms_per_step"]
print("AB " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--paths", default="unfused,async_unfused")
    ap.add_argument("--turns", default="ABBAABBA")
    ap.add_argument("--out", default="build/ab_paths.json")
    args = ap.parse_args()
    roots = {"A": str(Path(args.old).resolve()),
             "B": str(Path(args.new).resolve())}
    names = args.paths.split(",")
    got = {k: {n: [] for n in names} for k in roots}
    for turn in args.turns:
        r = subprocess.run([sys.executable, "-c",
                            CHILD.format(root=roots[turn], names=names)],
                           cwd=roots[turn], capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith("AB ")]
        if r.returncode or not line:
            print(r.stdout[-3000:], r.stderr[-3000:])
            return 1
        for n, ms in json.loads(line[0][3:]).items():
            got[turn][n].append(ms)
        print(f"[ab] {turn} {roots[turn]}: {line[0][3:]}", flush=True)
    summary = {}
    for k, per in got.items():
        for n, v in per.items():
            summary[f"{k} {n}"] = dict(root=roots[k], ms_per_step=v,
                                       median=statistics.median(v),
                                       min=min(v), max=max(v))
            print(f"[ab] {k} {n}: " + json.dumps(summary[f"{k} {n}"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
