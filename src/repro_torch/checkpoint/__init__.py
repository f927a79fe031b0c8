"""Checkpoint interchange of the port (port of ``repro/checkpoint``)."""
from .bridge import array_to_torch, params_from_numpy

__all__ = ["array_to_torch", "params_from_numpy"]
