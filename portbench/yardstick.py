"""The benchmark's own arithmetic: the card's peaks, a step's model FLOPs
and the fused update's bytes, from the configuration and traffic files
alone (never from the program's counters)."""
from __future__ import annotations

import importlib
import math
from typing import Dict

from .reference import gossip as G
from .reference.train import family, protocol
from .traffic import replicas as _replicas

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
_ITEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def _model(cfg: Dict):
    return importlib.import_module(f"portbench.models.{cfg['family']}")


def train_flops_per_step(cfg: Dict, job: Dict, rows: int = None) -> float:
    """Model FLOPs of one step: 6 x matmul weights x tokens (forward and
    backward, two per multiply-add), plus the mixer's products that hold no
    weight; remat's recompute and the embedding lookup are not counted.
    ``rows``: the replicas counted (every replica of the step by
    default)."""
    m = _model(cfg)
    rows = _replicas(job) if rows is None else rows
    T = rows * int(job["rows"]) * int(job["seq_len"])
    return float(6 * m.matmul_params(cfg) * T
                 + m.mixer_flops_per_token(cfg, int(job["seq_len"])) * T)


def buckets(cfg: Dict):
    """The flat layout's bucket lengths (the benchmark's copy of the
    packing)."""
    specs = family(cfg).leaf_specs(cfg)
    return G.flat_layout([math.prod(s[1]) for s in specs],
                         _ITEM[cfg["param_dtype"]])[1]


def fused_sgd_bytes(cfg: Dict, job: Dict, step: int, rows: int = None
                    ) -> int:
    """Bytes the fused mix+SGD sweeps of ``step`` must move once: per bucket
    element of every replica row held read weight, gradient and momentum
    and write weight and momentum in the parameter dtype (10 B in
    bfloat16), plus what the protocol's partner adds
    (``protocols/<name>.py: partner_bytes``). ``rows``: the replica rows
    counted (every replica by default)."""
    item = _ITEM[cfg["param_dtype"]]
    sizes = buckets(cfg)
    extra = protocol(job).partner_bytes(job, step, sizes, item)
    rows = _replicas(job) if rows is None else rows
    return int(sum(rows * n * (5 * item + e)
                   for n, e in zip(sizes, extra)))
