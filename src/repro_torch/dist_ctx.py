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
their experts over its model group (``models.moe``).

``constrain_logical`` is the identity here. The reference attaches a
sharding constraint by logical axes so that GSPMD places the arithmetic;
in the port a process's tensors are its own (the stacked replicas of one
device, or one rank's rows and gathered leaves), and there is no placement
to constrain.
"""
from __future__ import annotations

import contextlib

__all__ = ["use_distribution", "constrain_logical", "current_distribution",
           "current_group"]

_CURRENT: list = []   # (dist, group) pairs, innermost last


def current_distribution():
    """The active ``train.sharding.Distribution``, or None outside a
    step."""
    return _CURRENT[-1][0] if _CURRENT else None


def current_group():
    """The active step's ``ReplicaGroup``: None outside a step, and in a
    step without ranks (stacked replicas, one device, the dry run)."""
    return _CURRENT[-1][1] if _CURRENT else None


@contextlib.contextmanager
def use_distribution(dist, group=None):
    """Make ``dist`` the active plan, and ``group`` this rank's place on
    its process mesh, for the duration of the block."""
    _CURRENT.append((dist, group))
    try:
        yield
    finally:
        _CURRENT.pop()


def constrain_logical(x, annotation: str):
    """``x`` itself: a process's tensors carry no sharding to constrain
    (``annotation`` is the reference's logical-axes string)."""
    del annotation
    return x
