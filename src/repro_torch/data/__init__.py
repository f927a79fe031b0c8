"""Synthetic data pipeline (port of ``repro/data``)."""
from .synthetic import (BigramTaskDataset, RingShardRotation,
                        ShardedTokenDataset, make_replica_batches)

__all__ = ["BigramTaskDataset", "RingShardRotation", "ShardedTokenDataset",
           "make_replica_batches"]
