"""Named ranges and counters inside the port's train step, on the
profiler's clock.

The reference has no counterpart: its step is one jitted program, which
XLA's own profile splits. Here the step is eager PyTorch, so the port marks
its phases itself:

* ``span(name)`` is a context manager. While a ``torch.profiler`` session
  records, it is ``torch.profiler.record_function(name)``: Kineto records
  the range beside the device activity, on the same clock, and each
  kernel's correlation id links it to the host call that launched it
  inside the range. While no profiler records, it is one shared
  ``contextlib.nullcontext()``: one C call, nothing allocated, no op
  dispatched.
* ``count(name, n)`` adds ``n`` to an in-process counter, only while a
  profiler records (``recording()``); ``counters()`` returns a copy of
  them all. A reader takes the difference of two copies around the
  profiled steps.

Spans (``STEP`` ⊃ ``FORWARD`` ⊃ ``MIXER``; ``STEP`` ⊃ ``BACKWARD``, which
holds remat's recompute and so ``MIXER`` again; ``STEP`` ⊃ ``UPDATE`` ⊃
``ENCODE``, ``EXCHANGE``):

* ``repro.step``: one ``train.step`` train step, whole;
* ``repro.forward``: the loss over the batch;
* ``repro.backward``: its backward;
* ``repro.update``: the gradient exchange, the optimizer or fused sweep and
  the mix after the backward, and the unfused ring's mix before the
  forward;
* ``repro.mixer``: a block's self mixer (attention, MLA or Mamba;
  ``models/blocks.py: block_apply``);
* ``repro.exchange``: ``core/gossip.py: exchange``, the replicas' weights
  or wire payloads moving between replicas;
* ``repro.encode``: ``core/gossip.py: encode_bucket``, a bucket encoded
  for the wire.

Counter: ``exchange_bytes``, the bytes this process's replica rows
receive through ``repro.exchange``.

To see them, run any of the port's training under
``torch.profiler.profile``: the ``repro.*`` ranges appear in its
exported trace beside the kernels they launched.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

__all__ = ["span", "count", "counters", "recording", "STEP", "FORWARD",
           "BACKWARD", "UPDATE", "MIXER", "EXCHANGE", "ENCODE",
           "EXCHANGE_BYTES"]

STEP = "repro.step"
FORWARD = "repro.forward"
BACKWARD = "repro.backward"
UPDATE = "repro.update"
MIXER = "repro.mixer"
EXCHANGE = "repro.exchange"
ENCODE = "repro.encode"

EXCHANGE_BYTES = "exchange_bytes"

_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


def recording() -> bool:
    """Whether a profiler records (a caller computes a count only then)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A range named ``name`` while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)
