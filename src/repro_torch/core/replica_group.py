"""Where this process stands among the replica ranks.

The port's counterpart of the reference's distribution context
(``repro/dist_ctx.py`` and the data axis of ``repro/launch/mesh.py``): the
reference runs its replicas as the devices of one mesh; here a replica is
either a row of tensors stacked on one device (no group, ``None``) or a
process of a ``torch.distributed`` world (a ``ReplicaGroup``). The engines
take the group when they are built and pass it to the primitives that
reach the other replicas (``core.gossip.exchange`` and ``replica_mean``),
so a built engine keeps the layout it was built for.
``launch.mesh.init_replica_group`` joins the world and returns the group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ReplicaGroup"]


@dataclasses.dataclass(frozen=True)
class ReplicaGroup:
    """This process's place among the replica ranks: it holds one replica,
    rank ``rank`` of ``world_size``, on ``device``."""

    rank: int
    world_size: int
    backend: str
    device: torch.device

    def ranks(self) -> np.ndarray:
        """The replica ranks this process holds (one)."""
        return np.array([self.rank])
