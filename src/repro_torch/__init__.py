"""GossipGraD on PyTorch and CUDA: the port of the ``repro`` JAX package.

The JAX package (``src/repro``) is the reference; this package mirrors its
tree and names module for module, in PyTorch idiom. It never imports ``jax``
nor anything of ``repro``. Every entry point takes an explicit ``device``,
``"cuda"`` by default: the CPU is used only when the caller asks for it, and
the hand-written CUDA kernels run for every CUDA tensor (their plain PyTorch
versions serve CPU tensors only).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
