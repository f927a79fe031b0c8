"""Plain mesh and partition descriptions.

No single reference counterpart: the reference describes its device mesh
with ``jax.sharding.Mesh`` and a leaf's placement with
``jax.sharding.PartitionSpec``. The port keeps every replica on one device
(or one per process), so it needs only what the distribution plan and the
shard-local bucket layouts read from them: the mesh's axis names and
sizes, in order, and one entry per array dim naming the mesh axes that
shard it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["MeshSpec", "PartitionSpec"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, row-major (``jax.sharding.Mesh``'s
    ``axis_names`` and ``shape``, without devices)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (int(n) for n in self.axis_sizes)))


class PartitionSpec(tuple):
    """One entry per array dim: None (not sharded), a mesh axis name, or a
    tuple of names (sharded over their product), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"
