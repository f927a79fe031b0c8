"""The production and smoke meshes, and one process per mesh position over
``torch.distributed``.

Port of ``repro/launch/mesh.py`` (``make_production_mesh``,
``make_smoke_mesh``).
``make_smoke_mesh(data, model, pod)`` returns the mesh's description
(``mesh_spec.MeshSpec``: the reference's axis names and order, no
devices), which ``train.sharding.make_distribution`` turns into the
distribution plan; on one device its replicas are stacked and its
in-replica axes pick the shard-local bucket layout.

The reference runs one device per mesh position and exchanges with
``ppermute`` inside ``shard_map``. Here a mesh position is a process:
``init_replica_group`` joins the world and returns the process's
``core.replica_group.ReplicaGroup`` (its replica, its shard and the
subgroups that reach the others); the caller passes it to the engines when
it builds them (``make_train_step_bundle(group=...)``,
``init_train_state(group=...)``). Each process holds one replica row (a
leading replica axis of size 1 on every tensor), and under a plan that
shards inside a replica only its stretch of every bucket:

* ``core.gossip.exchange``: point-to-point over the cross-replica group, a
  send to every replica that receives from this one and a receive from
  ``recv_from[replica]`` (``dist.batch_isend_irecv``);
* ``core.gossip.replica_mean``: ``all_gather`` over the cross-replica
  group, then the fp32 sum in replica order from zero times the fp32
  reciprocal of dp, bit-equal to the stacked mean;
* the ring shuffle: a send to the next replica at the same shard;
* ``PackedParams.unpack``: ``all_gather`` of the replica's stretches over
  the in-replica group, and in the backward a reduce-scatter over the
  batch group (``core.buckets``);
* expert parallelism (``models.moe``): the partial outputs of each rank's
  experts summed over the model group (an ``all_gather`` and an fp32 sum
  in model order), and under fsdp each rank's experts gathered over its
  batch group only.

The plan (``dist=``) gives the world: every mesh position (pod x data x
model), rank r the row-major position r; under a plan that shards nothing
inside a replica every process is a whole replica (the world is dp). The
backend is gloo for CPU tensors and by default NCCL on
``cuda:{LOCAL_RANK}``; NCCL takes one card per rank, so a world larger
than the card count raises under it (it is never moved onto gloo).
``backend="gloo"`` with ``device="cuda"`` is only what the caller asks
for: every rank on ``cuda:{LOCAL_RANK % device_count}``, gloo carrying
the CUDA tensors of its collectives (it has no CUDA send or
receive, so such a world runs dp 1). ``init_replica_group`` reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as ``torchrun`` sets them, or
takes them from the caller.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.core.replica_group import ReplicaGroup, mesh_tables
from repro_torch.mesh_spec import MeshSpec

__all__ = ["ReplicaGroup", "make_production_mesh", "make_smoke_mesh", "init_replica_group",
           "destroy_replica_group", "world_from_env", "mesh_tables"]


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


def init_replica_group(device="cuda", *, dist,
                       backend: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout_s: float = 300.0) -> ReplicaGroup:
    """Join the process group and return this process's place on the
    process mesh. ``dist`` (a ``train.sharding.Distribution``) gives the
    mesh: the world must be its every position, and the subgroups are made
    here (every rank makes every one, in one order); a plan that shards
    nothing inside a replica (``make_smoke_mesh(world, 1)``, replica
    mode) makes every process one whole replica. ``device`` "cpu" runs
    gloo; "cuda" runs NCCL on ``cuda:{local_rank}`` unless
    ``backend="gloo"``. Without ``init_method`` the rendezvous is
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``)."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = world_from_env() if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    tables = mesh_tables(dist)
    if tables.replica.size != world_size:
        raise ValueError(
            f"the mesh {dict(dist.mesh.shape)} has {tables.replica.size} "
            f"positions but the world has {world_size} processes")
    kind = torch.device(device).type
    if kind == "cuda":
        n = torch.cuda.device_count()
        backend = backend or "nccl"
        if backend == "nccl":
            if world_size > n:
                raise RuntimeError(
                    f"NCCL needs one card per rank: world size {world_size} "
                    f"but {n} CUDA device(s) visible")
            dev = torch.device("cuda", local_rank)
        elif backend == "gloo":
            dev = torch.device("cuda", local_rank % max(n, 1))
        else:
            raise ValueError(f"unsupported backend {backend!r}")
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"CPU tensors take gloo, not {backend!r}")
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    tdist.init_process_group(backend, init_method=init_method or "env://",
                             rank=rank, world_size=world_size,
                             timeout=datetime.timedelta(seconds=timeout_s))
    return _mesh_group(tables, rank, backend, dev)


def _subgroups(lists, rank: int):
    """Make one subgroup per rank list (every rank makes all of them, in
    one order) and return the one holding ``rank``; None when it holds
    ``rank`` alone."""
    mine = None
    for ranks in lists:
        if len(ranks) < 2:
            continue
        g = tdist.new_group(list(ranks))
        if rank in ranks:
            mine = g
    return mine


def _mesh_group(tables, rank: int, backend: str, dev) -> ReplicaGroup:
    """The subgroups of a plan's mesh and this rank's ``ReplicaGroup``.
    Every list is in rising rank order (the replica axes lead the mesh and
    the batch axes lead the shard axes), which is the order of the
    collectives' results."""
    world, shards = tables.replica.size, tables.num_shards
    cross = ([tables.cross_ranks(tables.rank_of[0, s])
              for s in range(shards)] if shards > 1 else [])
    inner = [tables.inner_ranks(tables.rank_of[q, 0])
             for q in range(tables.dp)]
    batch = sorted({tables.batch_ranks(r) for r in range(world)})
    model = sorted({tables.model_ranks(r) for r in range(world)})
    for ranks in cross + inner + batch + model:
        assert list(ranks) == sorted(ranks), ranks
    return tables.group(rank, backend, dev,
                        cross=_subgroups(cross, rank) if shards > 1 else None,
                        inner=_subgroups(inner, rank),
                        batch=_subgroups(batch, rank),
                        model=_subgroups(model, rank))


def destroy_replica_group() -> None:
    """Leave the process group."""
    if tdist.is_initialized():
        tdist.destroy_process_group()
