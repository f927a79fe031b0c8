"""Weights bridge from the reference's parameter trees.

No single reference counterpart: ``torch.Generator`` cannot replay
``jax.random``, so parity runs take the reference's ``lm_init`` tree as
numpy arrays (nested dicts and lists keyed by the same paths) and load it
here. Needs no JAX: bf16 and float8_e4m3fn arrays (``ml_dtypes``) cross as
their raw bit patterns. Whole train states cross in the npz+manifest
checkpoint format (``checkpoint.io``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.buckets import BucketLayout, PackedParams
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

__all__ = ["array_to_torch", "params_from_numpy"]


def array_to_torch(a, device) -> torch.Tensor:
    """A tensor holding a copy of ``a`` (never a view of the caller's
    buffer: the port updates in place)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, *, layout: Optional[BucketLayout] = None,
                      lead: Tuple[int, ...] | None = None, device="cuda"):
    """The port's params from a numpy tree: the same tree of tensors, or,
    with ``layout``, a ``PackedParams`` packed through ``PackedParams.pack``
    (``lead=(dp,)`` broadcasts one replica's tree to dp replicas)."""
    dev = resolve_device(device)
    out = tree_map(lambda a: array_to_torch(a, dev), tree)
    if layout is None:
        return out
    return PackedParams.pack(out, layout, lead=lead, device=dev)
