"""The distribution context: the plan a step runs under, readable from deep
model code without threading it through every call.

Port of ``repro/dist_ctx.py`` (``use_distribution``,
``current_distribution``, ``constrain_logical``). The train step enters
``use_distribution(dist)`` around its forward and backward, as the
reference's step factory does inside its traced function
(``src/repro/train/step.py:368``); outside a step ``current_distribution()``
is None.

``constrain_logical`` is the identity here. The reference attaches a
sharding constraint by logical axes so that GSPMD places the arithmetic;
in the port a process's tensors are its own (the stacked replicas of one
device, or one rank's rows and gathered leaves), and there is no placement
to constrain.
"""
from __future__ import annotations

import contextlib

__all__ = ["use_distribution", "constrain_logical", "current_distribution"]

_CURRENT: list = []


def current_distribution():
    """The active ``train.sharding.Distribution``, or None outside a
    step."""
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def use_distribution(dist):
    """Make ``dist`` the active plan for the duration of the block."""
    _CURRENT.append(dist)
    try:
        yield
    finally:
        _CURRENT.pop()


def constrain_logical(x, annotation: str):
    """``x`` itself: a process's tensors carry no sharding to constrain
    (``annotation`` is the reference's logical-axes string)."""
    del annotation
    return x
