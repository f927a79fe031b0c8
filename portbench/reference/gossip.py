"""GossipGraD's exchange as plain numpy and PyTorch: the rotating partner
schedule, the flat bucket layout, the rotating bucket subset and the int8
wire with its splitmix32 stochastic rounding.

Frozen copies of what the paper and the system under test define (the
schedule's send-to rows, one module a topology under ``topologies/``;
largest-first bin packing of the leaves into
32 MiB LANE-aligned buckets; per-128-element tile scales; the wire hash),
written again here so that the benchmark never reads the program's own
tables. Nothing here imports the program.
"""
from __future__ import annotations

import importlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

LANE = 128
BUCKET_BYTES = 32 << 20
_MASK = 0xFFFFFFFF
INT8_MAX = 127.0


# ------------------------------------------------------------ the schedule
def perms(topology: str, p: int, rotations: int, seed: int) -> np.ndarray:
    """The send-to rows of ``topology`` (``topologies/<name>.py``)."""
    mod = importlib.import_module(f"{__package__}.topologies.{topology}")
    return mod.perms(p, rotations, seed)


def recv_from(perms: np.ndarray, step: int) -> np.ndarray:
    """Whom each rank receives from at ``step``: the inverse of its row."""
    send = perms[step % len(perms)]
    out = np.empty_like(send)
    out[send] = np.arange(len(send))
    return out


def subset_mask(num_buckets: int, fraction: float, t: int) -> np.ndarray:
    """Buckets sent at exchange ``t`` under a rotating subset of
    ``ceil(fraction * num_buckets)`` buckets (all of them at fraction 1):
    the window of that many starting at ``(t mod period) * n_send``."""
    n_send = max(1, math.ceil(fraction * num_buckets - 1e-9))
    if n_send >= num_buckets:
        return np.ones(num_buckets, bool)
    period = -(-num_buckets // n_send)
    start = (t % period) * n_send
    return (np.arange(num_buckets) - start) % num_buckets < n_send


def subset_period(num_buckets: int, fraction: float) -> int:
    n_send = max(1, math.ceil(fraction * num_buckets - 1e-9))
    return 1 if n_send >= num_buckets else -(-num_buckets // n_send)


# ---------------------------------------------------------------- layout
def _up(n: int, q: int = LANE) -> int:
    return -(-n // q) * q


def flat_layout(sizes: Sequence[int], itemsize: int = 2
                ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Largest-first bin packing of leaves of ``sizes`` elements (one dtype)
    onto the emptiest of ``min(ceil(total bytes / 32 MiB), leaves)``
    buckets, each leaf LANE-aligned: ``(slots, bucket_sizes)`` with
    ``slots[leaf] = (bucket, offset)``."""
    total = sum(_up(s) for s in sizes)
    n = min(max(1, math.ceil(total * itemsize / BUCKET_BYTES)), len(sizes))
    fills = [0] * n
    slots: List[Tuple[int, int]] = [(0, 0)] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        b = int(np.argmin(fills))
        slots[i] = (b, fills[b])
        fills[b] = _up(fills[b] + sizes[i])
    return slots, [max(f, LANE) for f in fills]


# ------------------------------------------------------------- int8 wire
def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def wire_key(t: int, rank: int, bucket: int, seed: int) -> int:
    """The uint32 key of one row's rounding noise at dispatch ``t``."""
    u = lambda v: np.atleast_1d(np.asarray(v, np.int64) & _MASK  # noqa: E731
                                ).astype(np.uint32)
    x = (u(t) * np.uint32(0x9E3779B9) ^ u(rank) * np.uint32(0x85EBCA6B)
         ^ np.uint32((int(bucket) * 0xC2B2AE35) & _MASK)
         ^ np.uint32(int(seed) & _MASK))
    return int(_mix32_np(x)[0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), by 16-bit halves of c."""
    hi = (x * (c >> 16)).bitwise_and(0xFFFF).bitwise_left_shift(16)
    return (x * (c & 0xFFFF) + hi).bitwise_and(_MASK)


def uniform(key: int, lo: int, hi: int, device) -> torch.Tensor:
    """fp32 noise in [0, 1) of element indices lo..hi-1 under ``key``: the
    splitmix32 finalizer of ``index * golden ^ key``, its top 24 bits."""
    x = _mul32(torch.arange(lo, hi, dtype=torch.int64, device=device),
               0x9E3779B9).bitwise_xor(int(key))
    x = x.bitwise_xor(x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x.bitwise_xor(x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x.bitwise_xor(x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def encode_int8(row: torch.Tensor, key: int, chunk: int = 1 << 24):
    """One bucket row (n,) to int8 codes and fp32 tile scales: per 128
    elements ``s = amax / 127``, ``q = clip(floor(x * (1 / s) + u), +-127)``
    (``1 / s`` is 0 where ``s`` is 0), in column chunks."""
    n = row.numel()
    q = torch.empty(n, dtype=torch.int8, device=row.device)
    s = torch.empty(n // LANE, dtype=torch.float32, device=row.device)
    top = torch.tensor(INT8_MAX, dtype=torch.float32, device=row.device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        x = row[lo:hi].float().view(-1, LANE)
        sc = x.abs().amax(-1) / top
        inv = torch.where(sc > 0, torch.ones_like(sc) / sc,
                          torch.zeros_like(sc))
        y = torch.floor(x * inv[:, None]
                        + uniform(key, lo, hi, row.device).view(-1, LANE))
        q[lo:hi] = y.clamp(-INT8_MAX, INT8_MAX).view(-1).to(torch.int8)
        s[lo // LANE:hi // LANE] = sc
    return q, s


def decode_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (q.view(-1, LANE).float() * s[:, None]).view(-1)
