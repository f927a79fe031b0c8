"""Single-sweep fused gossip mix + optimizer update: SGD-momentum, AdamW and
LARS.

Port of ``repro/kernels/fused_update.py`` (``_mix_f32``, ``_sgd_math``,
``_adamw_math``, ``_lars_math``, ``fused_sgd_1d`` / ``fused_sgd_ref``,
``fused_adamw_1d`` / ``fused_adamw_ref``, ``fused_lars_1d`` /
``fused_lars_ref``). On a CUDA tensor each ``*_1d`` wrapper launches its
hand-written kernel (``csrc/fused_sgd.cu``, ``csrc/fused_adamw.cu``,
``csrc/fused_lars.cu``), which reads param, grad, partner and moments once
and writes param and moments once, in place (the reference aliases the
outputs onto their inputs). On a CPU tensor it runs the ``*_plain``
version, built from the shared fp32 math below as separate PyTorch ops.
There is no fallback between the two.

A static ``alpha == 0`` (or no partner) drops the partner read, as the
reference does; a tensor ``alpha`` of shape () or one value per row of
``p`` always mixes (masked-alpha path) and reaches the kernel as a device
pointer (``gossip_mix.kernel_alpha``). The partner may be narrower than the
bucket (a bf16 wire on an fp32 bucket, promoted as the reference does); for
sgd and adamw it may be int8 / float8_e4m3fn wire codes with
``partner_scales``, one fp32 scale per 128-element tile, decoded in the
sweep (the reference's ``partner_scales`` variant). LARS takes a raw
partner only, fp32 on a bf16 bucket included: its optimizer decodes a wire
payload before the norm prepass, as the reference's does.

AdamW and LARS keep fp32 moments whatever the bucket dtype. AdamW's bias
corrections ``c1``, ``c2`` come from the host as fp32 values; the plain
version divides by them as 0-d tensors on the buffer's device (CUDA divides
by a host scalar as a multiply by its reciprocal, which is not the
reference's rounding), and takes its square root in float64 (correctly
rounded once cast back, as the kernel's ``__fsqrt_rn``; torch's fp32
``sqrt`` on the CPU is not). Launches count per kernel: ``launches`` and
``scaled_launches`` (sgd), ``adamw_launches`` and ``adamw_scaled_launches``,
``lars_launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .gossip_mix import kernel_alpha, mix_weights
from .quantize import LANE, dequant_flat

__all__ = ["_mix_f32", "_sgd_math", "_adamw_math", "_lars_math",
           "fused_sgd_plain", "fused_sgd_1d", "fused_adamw_plain",
           "fused_adamw_1d", "fused_lars_plain", "fused_lars_1d",
           "drops_partner", "launches", "scaled_launches", "adamw_launches",
           "adamw_scaled_launches", "lars_launches"]

launches = _build.Launches()               # fused_sgd
scaled_launches = _build.Launches()        # fused_sgd with wire codes
adamw_launches = _build.Launches()         # fused_adamw
adamw_scaled_launches = _build.Launches()  # fused_adamw with wire codes
lars_launches = _build.Launches()          # fused_lars


def drops_partner(partner, alpha) -> bool:
    """True when the sweep reads no partner: none given, or a static 0."""
    return partner is None or (not isinstance(alpha, torch.Tensor)
                               and float(alpha) == 0.0)


# ---------------------------------------------------------------- shared math
# One definition of the arithmetic, mirroring the reference op for op; the
# CUDA kernels spell out the same ops with __fmul_rn/__fadd_rn/__fdiv_rn.

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


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 square root, correctly rounded on every device: the float64
    root rounded once to fp32 (53 bits are enough for that to be exact)."""
    return x.double().sqrt_().float()


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``like``'s device: a divisor that
    PyTorch divides by exactly on CUDA too."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _adamw_math(p32, g32, m32, v32, lr: float, c1: torch.Tensor,
                c2: torch.Tensor, *, b1: float, b2: float, eps: float,
                weight_decay: float):
    """Mirrors optim.adamw.update; ``c1``/``c2`` are the bias corrections of
    the NEW step count as 0-d tensors on the buffers' device. ``1 - b1``
    and ``1 - b2`` are Python doubles, rounded once to fp32 where they
    multiply, like the reference's weak-typed scalars."""
    m32 = b1 * m32 + (1 - b1) * g32
    v32 = b2 * v32 + (1 - b2) * (g32 * g32)
    u = (m32 / c1) / (_sqrt_rn(v32 / c2) + eps)
    if weight_decay:
        u = u + weight_decay * p32
    return p32 - lr * u, m32, v32


def _lars_math(p32, g32, m32, scale, lr: float, *, momentum: float,
               weight_decay: float):
    """Mirrors optim.lars.update's per-leaf body with the trust ratio
    precomputed (``scale`` broadcasts against the others)."""
    if weight_decay:
        g32 = g32 + weight_decay * p32
    m32 = momentum * m32 + g32 * scale
    return p32 - lr * m32, m32


# --------------------------------------------------------------- plain twins

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


def fused_adamw_plain(p, g, partner, m, v, *, lr, c1, c2, alpha=0.5, b1=0.9,
                      b2=0.95, eps=1e-8, weight_decay=0.0,
                      partner_scales=None):
    """Fused mix+AdamW as plain PyTorch ops, out of place:
    ``(new_p, new_m, new_v)`` with fp32 moments."""
    pf = _mix_f32(p.float(), partner, alpha, p.dtype, partner_scales)
    new_p, new_m, new_v = _adamw_math(
        pf, g.float(), m.float(), v.float(), float(lr), device_scalar(c1, p),
        device_scalar(c2, p), b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay)
    return new_p.to(p.dtype), new_m, new_v


def fused_lars_plain(p, g, partner, mom, row_scale, *, lr, alpha=0.5,
                     momentum=0.9, weight_decay=0.0):
    """Fused mix+LARS as plain PyTorch ops, out of place:
    ``(new_p, new_mom)`` with an fp32 momentum. ``row_scale`` holds one
    trust ratio per 128 elements of ``p``."""
    _check_rows(p, row_scale)
    pf = _mix_f32(p.float(), partner, alpha, p.dtype)
    rows = lambda x: x.reshape(-1, LANE)  # noqa: E731
    new_p, new_m = _lars_math(rows(pf), rows(g.float()), rows(mom.float()),
                              row_scale.float().reshape(-1, 1), float(lr),
                              momentum=momentum, weight_decay=weight_decay)
    return new_p.to(p.dtype).reshape(p.shape), new_m.reshape(mom.shape)


# ------------------------------------------------------------------ launches

def _check_rows(p, row_scale) -> None:
    if p.numel() % LANE or row_scale.numel() * LANE != p.numel():
        raise ValueError(f"row_scale {tuple(row_scale.shape)} for "
                         f"{tuple(p.shape)}: want a LANE-aligned p and one "
                         f"scale per {LANE} elements")


def _check_stream(p, name, t, dtype) -> None:
    if t.dtype != dtype or t.device != p.device or t.shape != p.shape:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"does not match p: {dtype} {tuple(p.shape)} "
                         f"on {p.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _partner_args(p, partner, scales, alpha):
    """``(pcode, keep, take, alpha_ptr, row_len, holder)`` of a launch."""
    if partner is None:
        return 0, 1.0, 0.0, None, 0, None
    _check_partner(p, partner, scales)
    pcode = _build.dtype_code(partner.dtype,
                              _build.CODE_DTYPES if scales is not None
                              else _build.BUCKET_DTYPES)
    return (pcode,) + tuple(kernel_alpha(alpha, p))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _stream(p) -> int:
    return torch.cuda.current_stream(p.device).cuda_stream


def _launch_sgd(p, g, partner, mom, *, lr, alpha, momentum, weight_decay,
                scales) -> None:
    _check_stream(p, "g", g, p.dtype)
    if mom is not None:
        _check_stream(p, "mom", mom, p.dtype)
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    pcode, keep, take, al_ptr, row_len, _hold = _partner_args(
        p, partner, scales, alpha)
    if p.numel() == 0:
        return
    fn = _build.kernel("fused_sgd")
    rc = fn(_build.dtype_code(p.dtype), pcode, p.data_ptr(), g.data_ptr(),
            _ptr(partner), _ptr(scales), _ptr(mom), p.numel(), keep, take,
            al_ptr, row_len, float(lr), float(momentum), float(weight_decay),
            _stream(p))
    launches.count += 1
    if scales is not None:
        scaled_launches.count += 1
    _build.check_launch("fused_sgd", rc)


def _launch_adamw(p, g, partner, m, v, *, lr, c1, c2, alpha, b1, b2, eps,
                  weight_decay, scales) -> None:
    _check_stream(p, "g", g, p.dtype)
    _check_stream(p, "m", m, torch.float32)
    _check_stream(p, "v", v, torch.float32)
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    pcode, keep, take, al_ptr, row_len, _hold = _partner_args(
        p, partner, scales, alpha)
    if p.numel() == 0:
        return
    fn = _build.kernel("fused_adamw")
    rc = fn(_build.dtype_code(p.dtype), pcode, p.data_ptr(), g.data_ptr(),
            _ptr(partner), _ptr(scales), m.data_ptr(), v.data_ptr(),
            p.numel(), keep, take, al_ptr, row_len, float(lr), float(c1),
            float(c2), float(b1), float(b2), 1 - float(b1), 1 - float(b2),
            float(eps), float(weight_decay), _stream(p))
    adamw_launches.count += 1
    if scales is not None:
        adamw_scaled_launches.count += 1
    _build.check_launch("fused_adamw", rc)


def _launch_lars(p, g, partner, mom, row_scale, *, lr, alpha, momentum,
                 weight_decay) -> None:
    _check_stream(p, "g", g, p.dtype)
    _check_stream(p, "mom", mom, torch.float32)
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")
    if (row_scale.dtype != torch.float32 or row_scale.device != p.device
            or not row_scale.is_contiguous()):
        raise ValueError(f"row_scale: {row_scale.dtype} on "
                         f"{row_scale.device}; want contiguous float32 on "
                         f"{p.device}")
    pcode, keep, take, al_ptr, row_len, _hold = _partner_args(
        p, partner, None, alpha)
    if p.numel() == 0:
        return
    fn = _build.kernel("fused_lars")
    rc = fn(_build.dtype_code(p.dtype), pcode, p.data_ptr(), g.data_ptr(),
            _ptr(partner), mom.data_ptr(), row_scale.data_ptr(), p.numel(),
            keep, take, al_ptr, row_len, float(lr), float(momentum),
            float(weight_decay), _stream(p))
    lars_launches.count += 1
    _build.check_launch("fused_lars", rc)


# ------------------------------------------------------------------ wrappers

def _unsupported(p):
    return ValueError(f"unsupported device {p.device}")


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
        _launch_sgd(p, g, partner, mom, lr=lr, alpha=alpha, momentum=momentum,
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
        raise _unsupported(p)
    return p, mom


def fused_adamw_1d(p, g, partner, m, v, *, lr, c1, c2, alpha=0.5, b1=0.9,
                   b2=0.95, eps=1e-8, weight_decay=0.0, partner_scales=None):
    """Fused mix+AdamW over flat buffers of any length (one launch, the
    ragged tail included), in place over ``p``, ``m`` and ``v`` (fp32);
    returns ``(p, m, v)``. ``lr``, ``c1`` and ``c2`` are the step's fp32
    learning rate and the bias corrections ``1 - beta^(step+1)``, as Python
    floats. ``partner_scales`` marks ``partner`` as wire codes (LANE-aligned
    buffers only)."""
    if drops_partner(partner, alpha):
        partner, partner_scales = None, None
    if p.is_cuda:
        _launch_adamw(p, g, partner, m, v, lr=lr, c1=c1, c2=c2, alpha=alpha,
                      b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                      scales=partner_scales)
    elif p.device.type == "cpu":
        new_p, new_m, new_v = fused_adamw_plain(
            p, g, partner, m, v, lr=lr, c1=c1, c2=c2, alpha=alpha, b1=b1,
            b2=b2, eps=eps, weight_decay=weight_decay,
            partner_scales=partner_scales)
        p.copy_(new_p)
        m.copy_(new_m)
        v.copy_(new_v)
    else:
        raise _unsupported(p)
    return p, m, v


def fused_lars_1d(p, g, partner, mom, row_scale, *, lr, alpha=0.5,
                  momentum=0.9, weight_decay=0.0):
    """Fused mix+LARS over LANE-aligned flat buffers, in place over ``p``
    and the fp32 ``mom``; returns ``(p, mom)``. ``row_scale`` (fp32, shape
    ``(p.numel() // 128,)`` or any shape of that size) holds the trust
    ratio of each 128-element row, from the norm prepass. The partner is a
    raw fp32 or bf16 tensor, of any width against the bucket."""
    _check_rows(p, row_scale)
    if drops_partner(partner, alpha):
        partner = None
    if p.is_cuda:
        _launch_lars(p, g, partner, mom, row_scale, lr=lr, alpha=alpha,
                     momentum=momentum, weight_decay=weight_decay)
    elif p.device.type == "cpu":
        new_p, new_m = fused_lars_plain(p, g, partner, mom, row_scale, lr=lr,
                                        alpha=alpha, momentum=momentum,
                                        weight_decay=weight_decay)
        p.copy_(new_p)
        mom.copy_(new_m)
    else:
        raise _unsupported(p)
    return p, mom
