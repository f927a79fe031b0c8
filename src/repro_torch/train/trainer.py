"""Training loop driver.

Port of ``repro/train/trainer.py`` (``Trainer.run``). Runs the train step
over the synthetic sharded pipeline, cycling the gossip phase through the
protocol's ``period`` (the lcm of the partner schedule and the wire's
subset rotation; ``TrainStepBundle.step`` folds the step by it). PyTorch
launches work asynchronously on the card, so the loop keeps each step's
metrics on the device and reads them back only on log boundaries and at the
end of ``run`` (the only host syncs). The caching allocator and in-place
bucket updates take the place of the reference's buffer donation. Under a
replica group (``bundle.group``) each process feeds its own replica's shard
of the step's batch (row ``replica`` of the stacked batch), cut to its
batch position's share of the rows (fsdp's ``data``, as the reference's
``Distribution.batch_axes`` place them). Every step draws
its batch afresh, as the reference's loop does, so the loop asks the step
for no ring-shuffled next batch (``rotate=False``): under a replica group
that would be a point-to-point round that nothing reads.

The reference bounds JAX's asynchronous dispatch with an in-flight window
of ``2 + 2 * staleness`` steps. It has no counterpart here: the async ring
keeps its payloads in the train state, the step's host logic never waits
on the device, and PyTorch's own launch queue bounds how far the host runs
ahead.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from repro_torch.data import ShardedTokenDataset, make_replica_batches

from .step import TrainStepBundle

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, bundle: TrainStepBundle, state: Any,
                 dataset: ShardedTokenDataset, log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.bundle = bundle
        self.state = state
        self.dataset = dataset
        self.log_every = log_every
        self.log_fn = log_fn
        self.history: List[Dict[str, float]] = []

    def _batch(self, step: int):
        toks = make_replica_batches(self.dataset, step, self.bundle.dp)["tokens"]
        group = self.bundle.group
        if group is not None:
            b, n = toks.shape[1], group.batch_shards
            if b % n:
                raise ValueError(f"{b} rows a replica do not split over "
                                 f"{n} batch positions")
            lo = group.batch_index * (b // n)
            toks = toks[group.replica:group.replica + 1, lo:lo + b // n]
        return {"tokens": torch.from_numpy(toks).to(self.bundle.device)}

    def _drain(self, pending: List) -> None:
        for step, metrics in pending:
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = step
            self.history.append(rec)
        pending.clear()

    def run(self, num_steps: int, start_step: int = 0) -> List[Dict[str, float]]:
        t0 = time.perf_counter()
        pending: List = []
        for step in range(start_step, start_step + num_steps):
            self.state, _, metrics = self.bundle.step(
                self.state, self._batch(step), step, rotate=False)
            pending.append((step, metrics))
            if self.log_every and step % self.log_every == 0:
                self._drain(pending)
                rec = self.history[-1]
                self.log_fn(f"step {step:5d} loss {rec['loss']:.4f} "
                            f"ce {rec['ce']:.4f} "
                            f"({time.perf_counter() - t0:.1f}s)")
        self._drain(pending)
        return self.history
