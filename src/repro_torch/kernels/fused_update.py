"""Single-sweep fused gossip mix + SGD-momentum update.

Port of ``repro/kernels/fused_update.py`` (``_mix_f32``, ``_sgd_math``,
``fused_sgd_1d``, ``fused_sgd_ref``). On a CUDA tensor ``fused_sgd_1d``
launches the hand-written kernel ``csrc/fused_sgd.cu``, which reads param,
grad, partner and momentum once and writes param and momentum once, in
place (the reference aliases both outputs onto their inputs). On a CPU
tensor it runs ``fused_sgd_plain``, built from the shared fp32 math below as
separate PyTorch ops. There is no fallback between the two.

A static ``alpha == 0`` (or no partner) drops the partner read, as the
reference does; a tensor ``alpha`` of shape () or one value per row of
``p`` always mixes (masked-alpha path) and reaches the kernel as a device
pointer (``gossip_mix.kernel_alpha``). The partner may be narrower than the
bucket (a bf16 wire on an fp32 bucket, promoted as the reference does) or
int8 / float8_e4m3fn wire codes with ``partner_scales``, one fp32 scale per
128-element tile, decoded in the sweep (the reference's ``partner_scales``
variant). Every launch counts on ``launches``; the ones with scales also on
``scaled_launches``.

The adamw and lars bodies (``fused_adamw_1d``, ``fused_lars_1d``) are not
ported yet (ROADMAP B.2, B.3).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .gossip_mix import kernel_alpha, mix_weights
from .quantize import LANE, dequant_flat

__all__ = ["_mix_f32", "_sgd_math", "fused_sgd_plain", "fused_sgd_1d",
           "drops_partner", "launches", "scaled_launches"]

launches = _build.Launches()
scaled_launches = _build.Launches()


def drops_partner(partner, alpha) -> bool:
    """True when the sweep reads no partner: none given, or a static 0."""
    return partner is None or (not isinstance(alpha, torch.Tensor)
                               and float(alpha) == 0.0)


# ---------------------------------------------------------------- shared math
# One definition of the arithmetic, mirroring the reference op for op; the
# CUDA kernel spells out the same ops with __fmul_rn/__fadd_rn.

def _mix_f32(p32: torch.Tensor, partner: Optional[torch.Tensor], alpha,
             store_dtype: torch.dtype, partner_scale=None) -> torch.Tensor:
    """Arrival mix in fp32, rounded through the bucket dtype (bit-compatible
    with the standalone mix, which stores the mixed bucket). With
    ``partner_scale`` the partner is wire codes, decoded first."""
    if drops_partner(partner, alpha):
        return p32
    keep, take = mix_weights(alpha, p32)
    b32 = (dequant_flat(partner, partner_scale) if partner_scale is not None
           else partner.float())
    mixed = p32 * keep + b32 * take
    return mixed.to(store_dtype).float()


def _sgd_math(p32, g32, m32, lr: float, *, momentum: float,
              weight_decay: float):
    """Mirrors optim.sgd.update: weight decay folds into the grad before the
    momentum."""
    if weight_decay:
        g32 = g32 + weight_decay * p32
    if m32 is None:
        return p32 - lr * g32, None
    m32 = momentum * m32 + g32
    return p32 - lr * m32, m32


def fused_sgd_plain(p, g, partner, mom, *, lr, alpha=0.5, momentum=0.9,
                    weight_decay=0.0, partner_scales=None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fused update as plain PyTorch ops, out of place:
    ``(new_p, new_mom)``."""
    pf = _mix_f32(p.float(), partner, alpha, p.dtype, partner_scales)
    mf = mom.float() if mom is not None else None
    new_p, new_m = _sgd_math(pf, g.float(), mf, float(lr), momentum=momentum,
                             weight_decay=weight_decay)
    return (new_p.to(p.dtype),
            new_m.to(mom.dtype) if mom is not None else None)


def _check_partner(p, partner, scales) -> None:
    if partner.shape != p.shape or partner.device != p.device:
        raise ValueError(f"partner: {tuple(partner.shape)} on "
                         f"{partner.device} does not match p: "
                         f"{tuple(p.shape)} on {p.device}")
    if not partner.is_contiguous():
        raise ValueError("partner must be contiguous")
    if partner.data_ptr() == p.data_ptr():
        raise ValueError("partner aliases p: exchange a copy first")
    if scales is None:
        return
    if (scales.dtype != torch.float32 or scales.device != p.device
            or not scales.is_contiguous() or p.numel() % LANE
            or scales.numel() * LANE != p.numel()):
        raise ValueError(f"partner_scales: {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}; want "
                         f"contiguous float32, one per {LANE} elements of a "
                         f"LANE-aligned p {tuple(p.shape)}")


def _launch(p, g, partner, mom, *, lr, alpha, momentum, weight_decay,
            scales) -> None:
    for name, t in (("p", p), ("g", g), ("mom", mom)):
        if t is None:
            continue
        if t.dtype != p.dtype or t.device != p.device or t.shape != p.shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                             f"does not match p: {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pcode = 0
    if partner is not None:
        _check_partner(p, partner, scales)
        pcode = _build.dtype_code(partner.dtype,
                                  _build.CODE_DTYPES if scales is not None
                                  else _build.BUCKET_DTYPES)
    if p.numel() == 0:
        return
    keep, take, al_ptr, row_len, _hold = (
        kernel_alpha(alpha, p) if partner is not None
        else (1.0, 0.0, None, 0, None))
    fn = _build.kernel("fused_sgd")
    rc = fn(_build.dtype_code(p.dtype), pcode, p.data_ptr(), g.data_ptr(),
            partner.data_ptr() if partner is not None else None,
            scales.data_ptr() if scales is not None else None,
            mom.data_ptr() if mom is not None else None, p.numel(),
            keep, take, al_ptr, row_len, float(lr), float(momentum),
            float(weight_decay),
            torch.cuda.current_stream(p.device).cuda_stream)
    launches.count += 1
    if scales is not None:
        scaled_launches.count += 1
    _build.check_launch("fused_sgd", rc)


def fused_sgd_1d(p, g, partner, mom, *, lr, alpha=0.5, momentum=0.9,
                 weight_decay=0.0, partner_scales=None):
    """Fused mix+SGD over flat buffers of any length (one launch, the ragged
    tail included), in place over ``p`` and ``mom``; returns ``(p, mom)``.
    ``lr`` is the step's fp32 learning rate as a Python float.
    ``partner_scales`` marks ``partner`` as wire codes (LANE-aligned
    buffers only)."""
    if drops_partner(partner, alpha):
        partner, partner_scales = None, None
    if p.is_cuda:
        _launch(p, g, partner, mom, lr=lr, alpha=alpha, momentum=momentum,
                weight_decay=weight_decay, scales=partner_scales)
    elif p.device.type == "cpu":
        new_p, new_m = fused_sgd_plain(p, g, partner, mom, lr=lr, alpha=alpha,
                                       momentum=momentum,
                                       weight_decay=weight_decay,
                                       partner_scales=partner_scales)
        p.copy_(new_p)
        if mom is not None:
            mom.copy_(new_m)
    else:
        raise ValueError(f"unsupported device {p.device}")
    return p, mom
