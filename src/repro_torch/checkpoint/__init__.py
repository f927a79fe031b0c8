"""Checkpoints of the port (port of ``repro/checkpoint``): the npz +
manifest format of ``repro/checkpoint/io.py``, and the weights bridge."""
from .bridge import array_to_torch, params_from_numpy
from .io import checkpoint_exists, read_manifest, restore_state, save_state

__all__ = ["array_to_torch", "params_from_numpy", "checkpoint_exists",
           "read_manifest", "restore_state", "save_state"]
