"""One process per replica rank over ``torch.distributed``.

Port of ``repro/launch/mesh.py`` (``make_smoke_mesh``'s data axis). The
reference runs its replicas as the devices of one mesh and exchanges with
``ppermute`` inside ``shard_map``. Here a replica is a process: each holds
one replica (a leading replica axis of size 1 on every tensor), and the
three primitives that reach the other replicas run over the process group
that ``init_replica_group`` joins and returns as a ``core.replica_group.
ReplicaGroup``; the caller passes it to the engines when it builds them
(``make_train_step_bundle(group=...)``, ``init_train_state(group=...)``):

* ``core.gossip.exchange``: point-to-point, a send to every rank that
  receives from this one and a receive from ``recv_from[rank]``
  (``dist.batch_isend_irecv``);
* ``core.gossip.replica_mean``: ``all_gather``, then the fp32 sum in rank
  order from zero times the fp32 reciprocal of the world size, bit-equal
  to the stacked mean;
* the ring shuffle: a send to rank + 1.

The backend is gloo for CPU tensors and NCCL on ``cuda:{LOCAL_RANK}``;
NCCL takes one card per rank, so a world larger than the card count
raises (it is never moved onto gloo, and gloo cannot send CUDA tensors).
``init_replica_group`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
as ``torchrun`` sets them, or takes them from the caller.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.replica_group import ReplicaGroup

__all__ = ["ReplicaGroup", "init_replica_group", "destroy_replica_group",
           "world_from_env"]


def world_from_env() -> int:
    """``WORLD_SIZE`` as ``torchrun`` sets it (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_replica_group(device="cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout_s: float = 300.0) -> ReplicaGroup:
    """Join the process group and return this process's replica group.
    ``device`` "cpu" runs gloo; "cuda" runs NCCL on ``cuda:{local_rank}``.
    Without ``init_method`` the rendezvous is ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = world_from_env() if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count()
        if world_size > n:
            raise RuntimeError(
                f"NCCL needs one card per rank: world size {world_size} but "
                f"{n} CUDA device(s) visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return ReplicaGroup(rank=rank, world_size=world_size, backend=backend,
                        device=dev)


def destroy_replica_group() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
