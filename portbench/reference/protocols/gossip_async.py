"""Bounded-delay GossipGraD (``gossip_async``, staleness ``k``): each step
dispatches every replica's pre-update buckets of the rotating subset,
int8-coded with stochastic rounding keyed by (dispatch, replica, bucket,
seed), to the partner the schedule names; the partner a replica mixes at
``alpha`` is the payload that arrived ``k`` steps ago, on the buckets of
that dispatch's subset (nothing while the ring fills). No drops.

Faults: ``no_exchange`` delivers each replica its own payload;
``wire_key`` codes each dispatch with the next dispatch's keys."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import gossip as G

WIRE_SAMPLE = 2


class Protocol:
    def __init__(self, ref):
        b = ref.job["bundle"]
        if b["wire_dtype"] != "int8" or float(b["drop_rate"]) != 0.0:
            raise ValueError("the reference's gossip_async models the int8 "
                             "wire without drops only")
        self.alpha = float(b["gossip_alpha"])
        self.k = int(b["staleness"])
        self.frac = float(b["gossip_subset"])
        self.perms = G.perms(b["topology"], ref.dp, int(b["num_rotations"]),
                             ref.seed)
        self.slots = [None] * self.k
        self.valid = np.zeros((ref.dp, self.k), np.float32)
        self.first = None

    def _dispatch(self, ref, sent, src, t: int) -> List:
        """Every replica's pre-update bucket of the sent subset, coded with
        its own key, row j then received from replica ``src[j]``."""
        out = []
        kt = t + 1 if ref.fault == "wire_key" else t
        for i, bk in enumerate(ref.buckets):
            if not sent[i]:
                out.append(None)
                continue
            codes = [G.encode_int8(bk[r], G.wire_key(kt, r, i, ref.seed))
                     for r in range(ref.dp)]
            out.append([codes[int(src[j])] for j in range(ref.dp)])
        return out

    def begin(self, ref, t: int):
        nb = len(ref.buckets)
        src = (np.arange(ref.dp) if ref.fault == "no_exchange"
               else G.recv_from(self.perms, t))
        cons = G.subset_mask(nb, self.frac, t - self.k)
        self.outbox = self._dispatch(ref, G.subset_mask(nb, self.frac, t),
                                     src, t)
        if t == 0:
            self.first = self.outbox
        a = np.float32(self.alpha) * self.valid[:, 0]
        oldest = self.slots[0]
        if oldest is None:
            return None

        def mix(i, r, p32):
            if not cons[i]:
                return None
            q, s = oldest[i][r]
            ar = torch.tensor(a[r], dtype=torch.float32, device=p32.device)
            return p32 * (1.0 - ar) + G.decode_int8(q, s) * ar
        return mix

    def end(self, ref, t: int) -> None:
        self.slots = self.slots[1:] + [self.outbox]
        self.valid = np.concatenate(
            [self.valid[:, 1:], np.ones((ref.dp, 1), np.float32)], axis=1)

    def payloads(self, buckets: List[int]) -> Dict[int, tuple]:
        """Dispatch 0's codes and scales of ``buckets`` as every replica
        received them, (dp, n) and (dp, n / 128), on the host."""
        return {i: tuple(torch.stack([row[j] for row in self.first[i]]).cpu()
                         for j in (0, 1)) for i in buckets}


def partner_bytes(job: Dict, step: int, sizes: List[int],
                  item: int) -> List[float]:
    """An int8 code and its tile's share of a float32 scale, on the buckets
    the ring consumes at ``step``."""
    b = job["bundle"]
    used = G.subset_mask(len(sizes), float(b["gossip_subset"]),
                         step - int(b["staleness"]))
    return [(1 + 4 / G.LANE) if u else 0.0 for u in used]


def checked_payloads(job: Dict, num_buckets: int, seed: int) -> List[int]:
    """Up to ``WIRE_SAMPLE`` of the buckets sent at dispatch 0, drawn from
    the seed."""
    sent = np.flatnonzero(G.subset_mask(
        num_buckets, float(job["bundle"]["gossip_subset"]), 0))
    rng = np.random.default_rng(int(seed))
    pick = rng.choice(sent, size=min(WIRE_SAMPLE, len(sent)), replace=False)
    return sorted(int(i) for i in pick)
