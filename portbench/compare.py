"""How ``correct`` is decided: the program's first steps against the plain
reference's from the same weights and batches.

The numbers, each compared where the cell's limits file
(``limits/<workload>.json``) gives it a limit:

* ``loss_gap``: over the checked steps, the largest ``|L_prog - L_ref| /
  L_ref`` of the replica-mean loss;
* ``grad_gap``: over every replica and leaf, the largest gap between the
  norms of the first gradient as the optimizer holds it after the first
  step, ``|n_prog - n_ref|``, over the larger of the reference's norm of
  that leaf and the median leaf's;
* ``change_gap``: the same of the weights' change over the checked
  steps, leaving out the leaves whose first float32 gradient in the
  reference is under a thousandth of the median leaf's (nought to
  rounding: they move by round-off alone);
* ``grad_gap_median``: the gaps of ``grad_gap``, their median over the
  leaves of a replica, the largest over the replicas;
* ``wire_gap``: of the wire payloads of dispatch 0 that both sides read,
  the share of codes and scales that are not bit for bit the same.

A number that is not finite, or that one side cannot read, fails.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

NAMES = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median",
         "wire_gap")
NEGLIGIBLE = 1e-3


def _leaf_gaps(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray
               ) -> np.ndarray:
    """(replicas, leaves) relative gaps of the norms, nan where left out."""
    scale = np.maximum(ref, np.median(ref[keep]) if keep.any() else 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(prog - ref) / scale
    gap = np.where(scale > 0, gap, np.where(prog == ref, 0.0, np.inf))
    gap = np.where(np.isnan(gap), np.inf, gap)
    return np.where(keep, gap, np.nan)


def _worst(gap: np.ndarray) -> float:
    vals = gap[~np.isnan(gap)]
    return float(vals.max()) if vals.size else 0.0


def _median(gap: np.ndarray) -> float:
    rows = [np.nanmedian(r) for r in gap if not np.isnan(r).all()]
    return float(max(rows)) if rows else 0.0


def wire_gap(prog: Dict, ref: Dict) -> float:
    """Share of dispatch 0's codes and scales that differ; 1 where the
    program has no payload for a bucket the reference read."""
    bad = total = 0
    for i, want in ref.items():
        got = prog.get(i)
        n = sum(w.numel() for w in want)
        total += n
        if got is None or any(g.shape != w.shape for g, w in zip(got, want)):
            bad += n
            continue
        for g, w in zip(got, want):
            bad += int((g.view(-1) != w.view(-1)).sum())
    return bad / total if total else 0.0


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    lp, lr = np.asarray(prog["losses"], float), np.asarray(ref["losses"], float)
    loss = np.abs(lp - lr) / np.abs(lr)
    grad = np.asarray(ref["grad_norms"], float)
    keep = grad >= NEGLIGIBLE * np.median(grad)
    held = _leaf_gaps(np.asarray(prog["held_norms"], float),
                      np.asarray(ref["held_norms"], float),
                      np.ones_like(keep))
    change = _leaf_gaps(np.asarray(prog["change_norms"], float),
                        np.asarray(ref["change_norms"], float), keep)
    out = {"loss_gap": float(np.max(np.where(np.isfinite(loss), loss, np.inf))),
           "grad_gap": _worst(held), "change_gap": _worst(change),
           "grad_gap_median": _median(held)}
    if "payloads" in ref:
        out["wire_gap"] = wire_gap(prog.get("payloads", {}), ref["payloads"])
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(measured: Dict[str, float], limits: Dict
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number the limits name against its limit; one that was not
    measured reads infinite."""
    checks = {k: {"value": measured.get(k, math.inf),
                  "limit": float(limits[k])}
              for k in NAMES if k in limits}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]

