"""Serving: batched prefill and greedy decode (port of ``repro/serve``)."""
from .engine import ServingEngine
from .step import ServeBundle, cache_axes, make_decode_step, make_prefill_step

__all__ = ["ServingEngine", "ServeBundle", "cache_axes", "make_decode_step",
           "make_prefill_step"]
