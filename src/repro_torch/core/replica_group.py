"""Where this process stands on the process mesh: its replica, its shard of
that replica, and the subgroups that reach the others.

The port's counterpart of the reference's mesh positions under
``shard_map`` (``repro/core/gossip.py: _axis_rank``,
``repro/core/async_gossip.py: _linear_rank``): the reference runs one
device per mesh position; here a replica is either a row of tensors
stacked on one device (no group, ``None``) or held by processes of a
``torch.distributed`` world (a ``ReplicaGroup``), one process per mesh
position. A process's coordinates are its row-major position over the
plan's ``axis_names`` (JAX's mesh order, so the global rank is the mesh
position). Its **replica index** is its row-major position over
``dist.dp_axes``; its **shard index** its position over
``dist.shard_axes``; its **batch index** its position over the shard axes
that also split the batch (fsdp's ``data``).

Four subgroups reach the other processes:

* the *cross-replica* group (``cross``): the ranks at this shard index, one
  per replica, in replica order. The gossip exchange, the replica mean and
  the ring shuffle run over it, between stretches that hold the same
  elements;
* the *in-replica* group (``inner``): the ranks of this replica, in shard
  order. ``core.buckets`` all-gathers a replica's stretches over it;
* the *batch* group (``batch``): the ranks of this replica at this
  process's coordinates on the shard axes that do not split the batch, in
  batch order. They compute the same leaves on different rows, so a
  stretch's gradient is the sum over this group (fsdp's ``data``); in
  replica mode it is the process alone;
* the *model* group (``model``): the ranks of this replica at this
  process's batch index, in shard order: the positions that differ only
  on the shard axes that do not split the batch (``model``). It is the
  complement of the batch group, and the two tile the replica: fsdp's
  ranks at one ``data`` coordinate, replica mode's in-replica group. Its
  members compute the same rows, so expert parallelism
  (``models.moe``) splits the experts over it and sums their partial
  outputs across it; ``model_index`` is this process's place in it.

Without shards (``num_shards`` 1) every process is a whole replica, the
cross-replica group is the world and the other three are the process
alone;
that is the one-shard case, not a separate path. A group of size one is
kept as ``None`` and never communicates. The engines take the group when
they are built and pass it to the primitives that reach the other
processes (``core.gossip.exchange``, ``replica_mean``, ``PackedParams.
unpack``). ``launch.mesh.init_replica_group`` joins the world and returns
the group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["ReplicaGroup", "MeshTables", "mesh_tables"]


@dataclasses.dataclass(frozen=True)
class MeshTables:
    """Per global rank (the row-major mesh position): its replica, shard
    and batch index; ``rank_of[replica, shard]`` inverts the first two."""

    replica: np.ndarray
    shard: np.ndarray
    batch: np.ndarray
    rank_of: np.ndarray
    batch_shards: int

    @property
    def dp(self) -> int:
        return int(self.rank_of.shape[0])

    @property
    def num_shards(self) -> int:
        return int(self.rank_of.shape[1])

    def cross_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks at ``rank``'s shard index, by replica."""
        return tuple(int(r) for r in self.rank_of[:, self.shard[rank]])

    def inner_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks of ``rank``'s replica, by shard."""
        return tuple(int(r) for r in self.rank_of[self.replica[rank]])

    def batch_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks of ``rank``'s replica that hold the same leaves on
        other batch rows, by batch index: the shards whose index differs
        from ``rank``'s only in the batch coordinate."""
        stride = self.num_shards // self.batch_shards
        s = int(self.shard[rank])
        rest = s % stride
        return tuple(int(self.rank_of[self.replica[rank], b * stride + rest])
                     for b in range(self.batch_shards))

    def model_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks of ``rank``'s replica at its batch index, by shard:
        the shards whose index differs from ``rank``'s only off the batch
        coordinate (the batch group's complement)."""
        stride = self.num_shards // self.batch_shards
        b = int(self.shard[rank]) // stride
        return tuple(int(self.rank_of[self.replica[rank], b * stride + j])
                     for j in range(stride))

    def group(self, rank: int, backend: str, device, *, cross=None,
              inner=None, batch=None, model=None) -> "ReplicaGroup":
        """Rank ``rank``'s ``ReplicaGroup`` over these tables, with the
        subgroups made by the caller (``launch.mesh.init_replica_group``;
        none: a group that runs no collective)."""
        return ReplicaGroup(
            rank=int(rank), world_size=int(self.replica.size),
            backend=backend, device=torch.device(device),
            mesh_ranks=tuple(tuple(int(r) for r in row)
                             for row in self.rank_of),
            replica=int(self.replica[rank]), shard=int(self.shard[rank]),
            batch_ranks=self.batch_ranks(rank),
            model_ranks=self.model_ranks(rank), cross=cross, inner=inner,
            batch=batch, model=model)


def _linear(coords: dict, axes, sizes: dict) -> int:
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def mesh_tables(dist) -> MeshTables:
    """The mesh positions of every rank of the plan ``dist`` (a
    ``train.sharding.Distribution``): the world is one process per mesh
    position, rank = row-major position over ``dist.axis_names``."""
    sizes = {a: int(dist.mesh.shape[a]) for a in dist.axis_names}
    world = int(np.prod([sizes[a] for a in dist.axis_names]))
    batch_axes = tuple(a for a in dist.shard_axes if a in dist.batch_axes)
    # the batch axes lead the shard axes, so a batch group's ranks differ
    # by a fixed stride in the shard index
    if tuple(dist.shard_axes[:len(batch_axes)]) != batch_axes:
        raise ValueError(f"shard axes {dist.shard_axes} do not lead with "
                         f"the batch axes {batch_axes}")
    replica = np.zeros(world, np.int64)
    shard = np.zeros(world, np.int64)
    batch = np.zeros(world, np.int64)
    for r in range(world):
        coords, rem = {}, r
        for a in reversed(dist.axis_names):
            coords[a] = rem % sizes[a]
            rem //= sizes[a]
        replica[r] = _linear(coords, dist.dp_axes, sizes)
        shard[r] = _linear(coords, dist.shard_axes, sizes)
        batch[r] = _linear(coords, batch_axes, sizes)
    dp = max(int(dist.dp), 1)
    num_shards = int(np.prod(dist.shard_axis_sizes)) if dist.shard_axes \
        else 1
    if dp * num_shards != world:
        raise ValueError(f"mesh {sizes}: dp {dp} x shards {num_shards} is "
                         f"not the {world} positions")
    rank_of = np.full((dp, num_shards), -1, np.int64)
    rank_of[replica, shard] = np.arange(world)
    return MeshTables(replica=replica, shard=shard, batch=batch,
                      rank_of=rank_of,
                      batch_shards=int(np.prod([sizes[a] for a in
                                                batch_axes])))


@dataclasses.dataclass(frozen=True, eq=False)
class ReplicaGroup:
    """This process's place on the process mesh: global rank ``rank`` of
    ``world_size`` on ``device``; ``mesh_ranks[q][s]`` is the global rank
    of shard ``s`` of replica ``q`` (every position of the mesh), of which
    this process is ``(replica, shard)``; ``batch_ranks`` are the ranks of
    its batch group, by batch index, and ``model_ranks`` those of its model
    group, by model index. ``cross``, ``inner``, ``batch`` and ``model``
    are the ``torch.distributed`` subgroups (None: the default group for
    ``cross`` without shards, no communication otherwise). Made by
    ``MeshTables.group``, the one place that maps ranks to positions."""

    rank: int
    world_size: int
    backend: str
    device: torch.device
    mesh_ranks: Tuple[Tuple[int, ...], ...]
    replica: int
    shard: int
    batch_ranks: Tuple[int, ...]
    model_ranks: Tuple[int, ...]
    cross: Any = None
    inner: Any = None
    batch: Any = None
    model: Any = None

    @property
    def dp(self) -> int:
        return len(self.mesh_ranks)

    @property
    def num_shards(self) -> int:
        return len(self.mesh_ranks[0])

    @property
    def batch_shards(self) -> int:
        return len(self.batch_ranks)

    @property
    def batch_index(self) -> int:
        return self.batch_ranks.index(self.rank)

    @property
    def model_shards(self) -> int:
        return len(self.model_ranks)

    @property
    def model_index(self) -> int:
        return self.model_ranks.index(self.rank)

    @property
    def cross_ranks(self) -> Tuple[int, ...]:
        """The global rank of each replica at this shard: the exchange's
        peers, in replica order."""
        return tuple(row[self.shard] for row in self.mesh_ranks)

    @property
    def inner_ranks(self) -> Tuple[int, ...]:
        """The ranks of this replica, in shard order."""
        return self.mesh_ranks[self.replica]

    def ranks(self) -> np.ndarray:
        """The replica indices this process holds (one)."""
        return np.array([self.replica])
