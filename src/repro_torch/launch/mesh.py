"""The production and smoke meshes, and one process per replica rank over
``torch.distributed``.

Port of ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_smoke_mesh``).
``make_smoke_mesh(data, model, pod)`` returns the mesh's description
(``mesh_spec.MeshSpec``: the reference's axis names and order, no
devices), which ``train.sharding.make_distribution`` turns into the
distribution plan; on one device its replicas are stacked and its
in-replica axes pick the shard-local bucket layout.

The reference runs its replicas as the devices of one mesh and exchanges with
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
from repro_torch.mesh_spec import MeshSpec

__all__ = ["ReplicaGroup", "make_production_mesh", "make_smoke_mesh", "init_replica_group",
           "destroy_replica_group", "world_from_env"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production meshes, as descriptions (no devices):
    ``(16, 16)`` over ``("data", "model")``, 256 GPUs, or with
    ``multi_pod`` ``(2, 16, 16)`` over ``("pod", "data", "model")``, 512.
    The ``pod`` axis is the gossip domain of the hierarchical (fsdp-mode)
    archs and part of the replica domain for the rest.

    On H100 nodes of 8 GPUs the single mesh is 32 nodes and the
    multi-pod one 64: a 16-wide ``model`` axis spans two nodes, and every
    ``data`` (and ``pod``) neighbour lies on another node. The dry run
    (``launch/dryrun.py``) reckons on these meshes so that its records
    compare row for row with the reference's sweep."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_smoke_mesh(data: int = 1, model: int = 1, pod: int = 1) -> MeshSpec:
    """The mesh (data, model), or (pod, data, model) with ``pod > 1``: the
    pod axis is the hierarchical (fsdp-mode) gossip domain."""
    if pod > 1:
        return MeshSpec(("pod", "data", "model"),
                        (int(pod), int(data), int(model)))
    return MeshSpec(("data", "model"), (int(data), int(model)))


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
