"""Aggregate dry-run JSON records into roofline and collectives tables.

Port of ``repro/launch/report.py`` (``load_records``, ``roofline_table``,
``collectives_table``, ``summary``, ``analytic_compute_s``,
``effective_terms``, ``lever``), on H100 terms: the analytic compute term
divides by the H100's dense bf16 peak (``launch/roofline.py: H100``, a
datasheet figure), and ``lever`` names the port's levers. Every figure in
the tables is a model from datasheet rates, not a measurement.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.report \\
        --dir experiments/dryrun --tag baseline --mesh 16x16 --collectives
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.roofline import H100

__all__ = ["load_records", "roofline_table", "collectives_table", "summary",
           "analytic_compute_s", "effective_terms", "lever", "main"]

_ARCH_ORDER = [
    "falcon-mamba-7b", "qwen3-0.6b", "olmo-1b", "kimi-k2-1t-a32b",
    "whisper-base", "stablelm-1.6b", "jamba-v0.1-52b", "deepseek-v3-671b",
    "llava-next-mistral-7b", "internlm2-20b",
]
_SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(dirpath: str, tag: str = "baseline",
                 mesh: str | None = None) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirpath, f"{tag}__*.json"))):
        with open(path) as f:
            r = json.load(f)
        if mesh is None or r.get("mesh") == mesh:
            recs.append(r)
    recs.sort(key=lambda r: (_SHAPE_ORDER.index(r["shape"]),
                             _ARCH_ORDER.index(r["arch"])))
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 0.1:
        return f"{x:.2f}"
    return f"{x:.1e}"


def _gb(x) -> str:
    return f"{x / 1e9:.2f}"


def analytic_compute_s(rec: Dict, peak: float = H100.peak_flops) -> float:
    """Analytic compute term: 8·N_active·D for training (6ND, plus remat's
    second forward) or 2·N_active·D for inference, over the chips, at
    ``peak``. Beside the traced term it shows the work that is not the
    model's (attention scores, the vocabulary product's share)."""
    n, d = rec["active_params"], rec["tokens_per_step"]
    k = 8.0 if rec["kind"] == "train" else 2.0
    return k * n * d / rec["chips"] / peak


def effective_terms(r: Dict) -> Dict:
    """Roofline terms with the analytic compute floor applied."""
    t = dict(r["roofline"])
    t["compute_analytic_s"] = analytic_compute_s(r)
    t["compute_eff_s"] = max(t["compute_s"], t["compute_analytic_s"])
    t["dominant"] = max((("compute", t["compute_eff_s"]),
                         ("memory", t["memory_s"]),
                         ("collective", t["collective_s"])),
                        key=lambda kv: kv[1])[0]
    total = t["compute_eff_s"] + t["memory_s"] + t["collective_s"]
    t["roofline_frac"] = t["compute_eff_s"] / total if total else 0.0
    return t


def lever(r: Dict) -> str:
    """One sentence: what would move the dominant term down in the port."""
    t = effective_terms(r)
    dom = t["dominant"]
    arch, shape, mode = r["arch"], r["shape"], r["dist_mode"]
    is_moe = arch in ("kimi-k2-1t-a32b", "deepseek-v3-671b", "jamba-v0.1-52b")
    is_ssm = arch in ("falcon-mamba-7b", "jamba-v0.1-52b")
    if dom == "collective":
        if r["kind"] != "train":
            return ("serving over a process mesh gathers its weights "
                    "once; split the non-expert weights over model too "
                    "(tensor parallelism, ROADMAP B)")
        if mode == "replica":
            return ("drop the model axis where a replica fits a card "
                    "(pure_dp): gossip's O(1) exchange is already small")
        return ("in-pod FSDP's gathers per layer group, overlapped with "
                "compute (ROADMAP B)")
    if dom == "memory":
        if is_ssm and shape == "train_4k":
            return ("the hand-written `ssm_scan` on the train path (the "
                    "plain scan's autograd moves every step's state)")
        if shape in ("prefill_32k", "train_4k"):
            if is_moe:
                return ("fuse the MoE dispatch gathers and the combine; flash "
                        "attention on the path (the plain `_sdpa` "
                        "materializes the (S,T) scores)")
            return ("flash attention on the prefill and train paths (the "
                    "plain `_sdpa` materializes the (S,T) scores)")
        return ("a larger decode batch a card, or fewer decode ops a token "
                "(the cache and weights are read once a step)")
    return "compute-bound: near the roofline; only tensor-core tuning left"


def roofline_table(recs: List[Dict], with_lever: bool = False) -> str:
    lev = "| next lever " if with_lever else ""
    hdr = ("| arch | shape | mesh | peak GB/chip | compute s (traced/"
           f"analytic) | memory s | collective s | dominant | compute frac "
           f"{lev}|\n"
           "|---|---|---|---|---|---|---|---|---|"
           + ("---|" if with_lever else "") + "\n")
    rows = []
    for r in recs:
        t = effective_terms(r)
        mem = r.get("memory_analysis", {})
        row = (
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_gb(mem.get('peak_memory_in_bytes', 0))} | "
            f"{_fmt_s(t['compute_s'])} / {_fmt_s(t['compute_analytic_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {t['roofline_frac']:.2f} |")
        if with_lever:
            row += f" {lever(r)} |"
        rows.append(row)
    return hdr + "\n".join(rows)


def collectives_table(recs: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | all-gather | all-reduce | reduce-scatter "
           "| all-to-all | collective-permute | wire GB/chip |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in recs:
        c = r["collectives"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_gb(c['all-gather_bytes'])} ({c['all-gather_count']}) | "
            f"{_gb(c['all-reduce_bytes'])} ({c['all-reduce_count']}) | "
            f"{_gb(c['reduce-scatter_bytes'])} ({c['reduce-scatter_count']}) | "
            f"{_gb(c['all-to-all_bytes'])} ({c['all-to-all_count']}) | "
            f"{_gb(c['collective-permute_bytes'])} "
            f"({c['collective-permute_count']}) | {_gb(c['wire_bytes'])} |")
    return hdr + "\n".join(rows)


def summary(recs: List[Dict]) -> Dict:
    doms = {}
    for r in recs:
        doms.setdefault(effective_terms(r)["dominant"], []).append(
            f"{r['arch']}/{r['shape']}")
    return doms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--collectives", action="store_true")
    ap.add_argument("--lever", action="store_true")
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.tag, args.mesh)
    print(f"{len(recs)} records (tag={args.tag}, mesh={args.mesh or 'all'}; "
          f"a model from {H100.name} rates)\n")
    print(roofline_table(recs, with_lever=args.lever))
    if args.collectives:
        print()
        print(collectives_table(recs))
    print("\ndominant-term census:")
    for k, v in summary(recs).items():
        print(f"  {k}: {len(v)}")


if __name__ == "__main__":
    main()
