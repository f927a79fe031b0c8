"""Synchronous GossipGraD (``gossip``): at step ``t`` every replica mixes,
bucket by bucket, with the pre-update weights of the partner that the
rotating schedule names (``recv_from(t)``) at weight ``alpha``, rounded to
the parameter dtype, before its optimizer step: the single sweep of the
fused engine. The fault ``no_exchange`` gives each replica its own
weights as its partner."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import gossip as G


class Protocol:
    def __init__(self, ref):
        b = ref.job["bundle"]
        self.alpha = float(b["gossip_alpha"])
        self.perms = (G.perms(b["topology"], ref.dp, int(b["num_rotations"]),
                              ref.seed) if ref.dp > 1 else None)

    def begin(self, ref, t: int):
        if self.perms is None:
            return None
        src = (np.arange(ref.dp) if ref.fault == "no_exchange"
               else G.recv_from(self.perms, t))
        old = [b.clone() for b in ref.buckets]
        keep = float(np.float32(1.0 - self.alpha))
        take = float(np.float32(self.alpha))

        def mix(i, r, p32):
            return p32 * keep + old[i][int(src[r])].float() * take
        return mix

    def end(self, ref, t: int) -> None:
        pass


def partner_bytes(job: Dict, step: int, sizes: List[int],
                  item: int) -> List[float]:
    """The partner's pre-update bucket in the parameter dtype; none at dp
    1."""
    dp = int(job["bundle"]["dp"])
    return [float(item) if dp > 1 else 0.0] * len(sizes)


def checked_payloads(job: Dict, num_buckets: int, seed: int) -> List[int]:
    return []
