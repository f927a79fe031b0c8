"""The distribution context: the plan a step runs under, readable from deep
model code without threading it through every call.

Port of ``repro/dist_ctx.py`` (``use_distribution``,
``current_distribution``, ``constrain_logical``). The train step enters
``use_distribution(dist, group)`` around its forward and backward, and the
serve steps around theirs, as the reference's step factories do inside
their traced functions (``src/repro/train/step.py:368``,
``src/repro/serve/step.py:96, :118``); outside a step
``current_distribution()`` is None. The port adds the rank's
``core.replica_group.ReplicaGroup`` (``current_group()``), which the
reference reads from its mesh inside ``shard_map``: the MoE layers split
their experts over its model group (``models.moe``). A serve step whose
batch does not split over the rank's batch group also enters its
``SeqShards`` (``current_seq()``): the decode cache's ``kv_seq`` stretches
that the plan puts on ``data`` (the reference's sequence-parallel cache,
``src/repro/train/sharding.py:40-43``), which the attention layers read to
write and attend over their stretch (``models.attention``,
``models.blocks``).

``constrain_logical`` is the identity here. The reference attaches a
sharding constraint by logical axes so that GSPMD places the arithmetic;
in the port a process's tensors are its own (the stacked replicas of one
device, or one rank's rows and gathered leaves), and there is no placement
to constrain.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, FrozenSet, Tuple

__all__ = ["use_distribution", "constrain_logical", "current_distribution",
           "current_group", "current_seq", "SeqShards"]

_CURRENT: list = []   # (dist, group, seq) triples, innermost last


@dataclasses.dataclass(frozen=True)
class SeqShards:
    """A serve step's sequence-parallel decode cache: every rank serves
    every row, and a cache leaf whose physical length (``attention.
    cache_len(max_seq, window)``) is in ``split`` holds only the rank's
    stretch of it, ``L / n`` positions at its batch index ``index`` in the
    batch group ``group.batch`` of ``n`` members. The plan decides
    ``split`` (``serve.step.seq_shards``); the model code only reads it."""

    group: Any
    max_seq: int
    split: FrozenSet[int]

    @property
    def n(self) -> int:
        return self.group.batch_shards

    @property
    def index(self) -> int:
        return self.group.batch_index

    def stretch(self, length: int) -> Tuple[int, int]:
        """(first global position, positions) of the rank's stretch of a
        leaf of ``length`` positions: the whole leaf where it does not
        split."""
        if length not in self.split:
            return 0, length
        part = length // self.n
        return self.index * part, part


def current_distribution():
    """The active ``train.sharding.Distribution``, or None outside a
    step."""
    return _CURRENT[-1][0] if _CURRENT else None


def current_group():
    """The active step's ``ReplicaGroup``: None outside a step, and in a
    step without ranks (stacked replicas, one device, the dry run)."""
    return _CURRENT[-1][1] if _CURRENT else None


def current_seq():
    """The active serve step's ``SeqShards``: None outside a step and in
    every step whose batch splits over the batch group (or runs on one
    process)."""
    return _CURRENT[-1][2] if _CURRENT else None


@contextlib.contextmanager
def use_distribution(dist, group=None, seq=None):
    """Make ``dist`` the active plan, ``group`` this rank's place on its
    process mesh and ``seq`` its sequence-parallel cache, for the
    duration of the block."""
    _CURRENT.append((dist, group, seq))
    try:
        yield
    finally:
        _CURRENT.pop()


def constrain_logical(x, annotation: str):
    """``x`` itself: a process's tensors carry no sharding to constrain
    (``annotation`` is the reference's logical-axes string)."""
    del annotation
    return x
