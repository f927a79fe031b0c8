"""Communication protocols around the local update (GossipGraD Table 6).

Port of ``repro/core/protocols.py`` (``Protocol``, ``make_protocol``) for
``gossip`` and ``none``, plus ``make_ring_shuffle`` from
``repro/core/shuffle.py`` on the stacked replica axis. The other protocols
raise ``NotImplementedError`` naming their ROADMAP item.

    gossip   local update, then average params with the step's partner
             (the paper's algorithm, §4);
    none     no communication (the ensemble extreme, §4.1).

The train step calls ``comm_grads`` before the optimizer and
``comm_params`` after it, whatever the protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import tree_map

from .buckets import BucketLayout
from .gossip import make_packed_gossip_mix
from .topology import GossipSchedule, build_schedule

__all__ = ["PROTOCOLS", "Protocol", "make_protocol", "make_ring_shuffle"]

PROTOCOLS = ("gossip", "gossip_async", "agd", "every_logp", "none")
_LATER = {"gossip_async": "ROADMAP A.9 (async ring)",
          "agd": "ROADMAP A.7 (sync engines + protocols)",
          "every_logp": "ROADMAP A.7 (sync engines + protocols)"}


@dataclasses.dataclass
class Protocol:
    name: str
    dp: int
    schedule: Optional[GossipSchedule]
    _mix: Optional[Callable]

    @property
    def period(self) -> int:
        return self.schedule.period if self.schedule is not None else 1

    def comm_grads(self, grads, phase):
        return grads

    def comm_params(self, params, phase):
        if self.dp > 1 and self.name == "gossip":
            return self._mix(params, phase)
        return params


def make_protocol(name: str, dp: int, *, topology: str = "dissemination",
                  num_rotations: int = 2, alpha: float = 0.5,
                  packed_layout: BucketLayout | None = None,
                  seed: int = 0) -> Protocol:
    """Protocol over ``dp`` stacked replicas. ``gossip`` at dp > 1 builds
    the schedule and the packed bucket mix (``packed_layout`` required)."""
    if name not in PROTOCOLS:
        raise ValueError(f"unknown protocol {name!r}; options {PROTOCOLS}")
    if name in _LATER:
        raise NotImplementedError(
            f"protocol {name!r} is not ported yet: {_LATER[name]}")
    schedule, mix = None, None
    if dp > 1 and name == "gossip":
        if packed_layout is None:
            raise NotImplementedError(
                "the per-leaf gossip engine is not ported yet (ROADMAP A.7); "
                "pass packed_layout")
        schedule = build_schedule(dp, topology=topology,
                                  num_rotations=num_rotations, seed=seed)
        mix = make_packed_gossip_mix(schedule, alpha=alpha)
    return Protocol(name=name, dp=dp, schedule=schedule, _mix=mix)


def make_ring_shuffle() -> Callable:
    """``shuffle(batch) -> batch`` rotating every replica's shard one ring
    position (§4.5.2): replica j receives replica j-1's shard, the
    reference's ppermute with pairs (i, i+1)."""
    return lambda batch: tree_map(lambda x: torch.roll(x, 1, 0), batch)
