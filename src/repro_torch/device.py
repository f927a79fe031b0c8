"""Device selection for the port's entry points.

No reference counterpart: JAX picks its backend itself. Here every entry
point takes ``device`` (default ``"cuda"``) and resolves it through
``resolve_device``, which raises when CUDA is asked for and absent — a run
never drifts onto the CPU unless the caller passed ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
