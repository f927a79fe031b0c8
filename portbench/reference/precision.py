"""The products of the plain reference, at the precision asked for.

``fp32``: float32 inputs and accumulation, TF32 off. ``fp8``: the control,
the same products with both operands rounded to float8 e4m3 (one scale per
tensor, amax / 448) before the float32 product, the rounding passed
straight through in backward, as fp8 training casts a bf16 model's
operands.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "fp8")
_E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at one scale for the tensor; the gradient
    passes straight through."""
    with torch.no_grad():
        s = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
        q = (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def matmul_fn(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: want one of {PRECISIONS}")
    if precision == "fp32":
        return torch.matmul
    return lambda a, b: torch.matmul(fp8_round(a), fp8_round(b))
