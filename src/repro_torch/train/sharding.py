"""Logical-axis -> mesh-axis sharding rules: the distribution plan.

Port of ``repro/train/sharding.py`` (``_RULES``, ``Distribution``,
``make_distribution``). Model code annotates every parameter dim with a
*logical* axis name (``models.layers.ax``); this module maps those names
onto the mesh's axes per distribution mode:

* ``replica`` (the paper's data parallelism): each data-parallel rank
  holds a distinct full model replica, tensor-parallel over ``model``.
  The replicas are pod x data.
* ``fsdp`` (hierarchical, for the >= 52B archs): one logical copy per pod,
  sharded over ``model`` (TP/EP) and ``data`` (FSDP on ``embed``); the
  gossip replicas are the pods.
* ``pure_dp``: every mesh position is a full replica.

The plan runs over a plain mesh description (``mesh_spec.MeshSpec``, from
``launch.mesh.make_smoke_mesh``), not a device mesh, and its specs are
``mesh_spec.PartitionSpec`` tuples. On one device the port stacks the
``dp`` replicas and keeps every replica whole; the in-replica axes
(``shard_axes``) decide only where each element lives in a shard-local
bucket (``core.buckets.build_layout``). Any dim whose size does not divide
its mesh axis is replicated; a tensor never uses one mesh axis twice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.mesh_spec import MeshSpec, PartitionSpec as P
from repro_torch.models.layers import ax_names
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["Distribution", "make_distribution"]

_RULES = {
    "replica": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "ffn": "model", "experts": "model", "inner": "model",
        "embed": None, "head_dim": None, "latent": None,
        "expert_ffn": None, "embed_out": None,
        "batch": "__batch__", "kv_seq": "data", "group": None,
    },
    "fsdp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "ffn": "model", "experts": "model", "inner": "model",
        "embed": "data", "head_dim": None, "latent": None,
        "expert_ffn": None, "embed_out": "data",
        "batch": "__batch__", "kv_seq": "data", "group": "data",
    },
    "pure_dp": {
        "vocab": None, "heads": None, "kv_heads": None,
        "ffn": None, "experts": None, "inner": None,
        "embed": None, "head_dim": None, "latent": None,
        "expert_ffn": None, "embed_out": None,
        "batch": "__batch__", "kv_seq": None, "group": None,
    },
}


class Distribution:
    """Resolved distribution plan for (config.dist_mode, mesh)."""

    def __init__(self, mesh: MeshSpec, mode: str):
        if mode not in _RULES:
            raise ValueError(f"unknown dist mode {mode!r}")
        self.mesh = mesh
        self.mode = mode
        self.axis_names = tuple(mesh.axis_names)
        shape = {a: int(mesh.shape[a]) for a in self.axis_names}
        self.multi_pod = "pod" in self.axis_names
        # the batch shards over pod + data jointly (pure_dp: every axis)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in self.axis_names)
        if mode == "pure_dp":
            self.batch_axes = self.batch_axes + ("model",)
        # the gossip replica axes
        if mode in ("replica", "pure_dp"):
            self.dp_axes = self.batch_axes
        else:
            self.dp_axes = ("pod",) if self.multi_pod else ()
        self.dp = (int(np.prod([shape[a] for a in self.dp_axes]))
                   if self.dp_axes else 1)
        # the axes that shard inside a replica (size-1 axes shard nothing)
        self.shard_axes: Tuple[str, ...] = tuple(
            a for a in self.axis_names
            if a not in self.dp_axes and shape[a] > 1)
        self.shard_axis_sizes: Tuple[int, ...] = tuple(
            shape[a] for a in self.shard_axes)
        self._shape = shape

    # -------------------------------------------------- parameter specs
    def leaf_spec(self, shape: Tuple[int, ...], annotation: str,
                  replica_axis: bool) -> P:
        """The spec of one leaf of per-replica ``shape`` (with
        ``replica_axis``, a leading entry for the replica axis)."""
        names = ax_names(annotation)
        if len(names) != len(shape):
            raise ValueError(f"annotation {annotation!r} does not fit shape "
                             f"{tuple(shape)}")
        rules = _RULES[self.mode]
        used = set(self.dp_axes) if replica_axis else set()
        dims: list = []
        for size, name in zip(shape, names):
            mesh_axis = rules.get(name) if name else None
            if mesh_axis == "__batch__":
                axes = tuple(a for a in self.batch_axes if a not in used)
                prod = (int(np.prod([self._shape[a] for a in axes]))
                        if axes else 0)
                if axes and prod and size % prod == 0:
                    dims.append(axes if len(axes) > 1 else axes[0])
                    used.update(axes)
                else:
                    dims.append(None)
                continue
            if (mesh_axis is None or mesh_axis not in self.axis_names
                    or mesh_axis in used
                    or size % self._shape[mesh_axis] != 0):
                dims.append(None)
            else:
                dims.append(mesh_axis)
                used.add(mesh_axis)
        if replica_axis:
            front = (self.dp_axes if len(self.dp_axes) != 1
                     else self.dp_axes[0])
            return P(front, *dims) if self.dp_axes else P(None, *dims)
        return P(*dims)

    def param_specs(self, params, axes, replica_axis: bool = False):
        """Spec tree of ``params`` (leaves with a ``.shape``: tensors or
        ``ParamSpec``s) under the annotation tree ``axes``. With
        ``replica_axis`` every leaf leads with the replica axis and every
        annotation with its empty segment, as the reference's state
        carries them."""
        def one(p, a):
            shape = tuple(p.shape)
            if replica_axis:
                if not a.startswith(","):
                    raise ValueError(f"annotation {a!r} has no leading "
                                     "replica segment")
                return self.leaf_spec(shape[1:], a[1:], True)
            return self.leaf_spec(shape, a, False)

        return tree_map(one, params, axes)

    def expert_dims(self, specs) -> Tuple:
        """Per leaf of ``specs`` (a tree of ``ParamSpec``s of one replica,
        in flatten order): the dim of its ``experts`` axis where the plan
        puts that axis on ``model`` (expert parallelism: each position on
        ``model`` owns ``E / M`` experts), else None."""
        out = []
        for s in tree_flatten(specs)[0]:
            names = ax_names(s.axes)
            dim = names.index("experts") if "experts" in names else None
            spec = self.leaf_spec(tuple(s.shape), s.axes, True)
            out.append(dim if dim is not None and spec[1 + dim] == "model"
                       else None)
        return tuple(out)

    # -------------------------------------------------- data specs
    def batch_spec(self, ndim: int) -> P:
        front = (self.batch_axes if len(self.batch_axes) != 1
                 else self.batch_axes[0])
        return P(front, *([None] * (ndim - 1)))

    def replica_batch_spec(self, ndim: int) -> P:
        """Spec of a batch reshaped to (dp, local_b, ...)."""
        if not self.dp_axes:
            return P(None, *self.batch_spec(ndim - 1))
        front = self.dp_axes if len(self.dp_axes) != 1 else self.dp_axes[0]
        inner = tuple(a for a in self.batch_axes if a not in self.dp_axes)
        second = (inner if len(inner) > 1 else (inner[0] if inner else None))
        return P(front, second, *([None] * (ndim - 2)))

    def __repr__(self) -> str:
        return (f"Distribution(mode={self.mode!r}, mesh={self.mesh}, "
                f"dp={self.dp}, shard_axes={self.shard_axes})")


def make_distribution(mesh: MeshSpec, mode: str) -> Distribution:
    return Distribution(mesh, mode)
