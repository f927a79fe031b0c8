"""Deterministic synthetic data with GossipGraD's sample rotation, numpy only.

Port of ``repro/data/synthetic.py`` (``BigramTaskDataset``,
``ShardedTokenDataset``, ``make_replica_batches``) plus ``RingShardRotation``
from ``repro/core/shuffle.py``. Pure numpy with the same seeds, so both
packages draw identical batches. Rank r at step t reads shard
``(r - t // steps_per_shard) % p`` — the ring rotation of §4.5.2 that makes
every rank's long-run objective cover the whole dataset (Lemma 6.1).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["RingShardRotation", "BigramTaskDataset", "ShardedTokenDataset",
           "make_replica_batches"]


class RingShardRotation:
    """Rank r reads shard ``(r - step) % p`` at ``step``: a shard returns to
    a rank only after all other ranks consumed it once."""

    def __init__(self, p: int):
        if p < 1:
            raise ValueError("p >= 1")
        self.p = p

    def shard_for_rank(self, rank: int, step: int) -> int:
        return (rank - step) % self.p

    def assignment(self, step: int) -> np.ndarray:
        """Shard index consumed by each rank at ``step`` (a permutation)."""
        return (np.arange(self.p) - step) % self.p


class BigramTaskDataset:
    """Learnable synthetic language: tokens follow a sparse random bigram
    chain; deterministic given (seed, shard)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.next_tok = rng.integers(0, vocab, size=(vocab, branching))
        self.next_p = rng.dirichlet(np.ones(branching) * 0.5, size=vocab)

    def sample(self, rng: np.random.Generator, batch: int,
               seq_len: int) -> np.ndarray:
        toks = np.empty((batch, seq_len), np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        branch = self.next_tok.shape[1]
        for t in range(seq_len):
            toks[:, t] = cur
            u = rng.random(batch)
            cdf = np.cumsum(self.next_p[cur], axis=1)
            choice = (u[:, None] > cdf).sum(axis=1).clip(0, branch - 1)
            cur = self.next_tok[cur, choice]
        return toks


class ShardedTokenDataset:
    """p shards of one distribution; rank r at step t reads shard
    ``(r - t // steps_per_shard) % p``."""

    def __init__(self, vocab: int, seq_len: int, n_shards: int,
                 batch_per_shard: int, seed: int = 0,
                 steps_per_shard: int = 1,
                 task: Optional[BigramTaskDataset] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.n_shards = n_shards
        self.batch_per_shard = batch_per_shard
        self.seed = seed
        self.steps_per_shard = max(1, steps_per_shard)
        self.rotation = RingShardRotation(n_shards)
        self.task = task or BigramTaskDataset(vocab, seed=seed + 991)

    def shard_batch(self, shard: int, step: int) -> np.ndarray:
        """(B_shard, S+1): inputs are tokens[:-1], labels tokens[1:]."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + shard) * 1_000_003 + step)
        return self.task.sample(rng, self.batch_per_shard, self.seq_len + 1)

    def rank_batch(self, rank: int, step: int) -> np.ndarray:
        shard = self.rotation.shard_for_rank(rank, step // self.steps_per_shard)
        return self.shard_batch(shard, step)

    def global_batch(self, step: int) -> np.ndarray:
        """(n_shards * B_shard, S+1), replica-major."""
        return np.concatenate(
            [self.rank_batch(r, step) for r in range(self.n_shards)], axis=0)


def make_replica_batches(ds: ShardedTokenDataset, step: int,
                         dp: int) -> Dict[str, np.ndarray]:
    """Batch dict shaped (dp, local_b, S+1) for the replica train step."""
    g = ds.global_batch(step)
    if g.shape[0] % dp:
        raise ValueError(f"global batch {g.shape[0]} not divisible by dp={dp}")
    return {"tokens": g.reshape(dp, -1, g.shape[1])}
