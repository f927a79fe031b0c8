"""Compressed gossip wire: int8 / fp8-e4m3 bucket encode and decode.

Port of ``repro/kernels/quantize.py`` (``WireFormat``, ``wire_key``,
``wire_uniform``, ``encode_wire``, ``dequant_flat``, ``decode_wire``,
``zero_payload_like``, ``wire_itemsize``). The reference encodes in jnp
outside any Pallas kernel, so the encode here is plain PyTorch, not a
kernel port; the decode folds into the arrival-mix and fused-update kernels
(``gossip_mix.gossip_mix_q2d``, ``fused_update.fused_sgd_1d`` with
``partner_scales``).

Wire payloads (``WireFormat.dtype``): ``fp32`` the raw bucket; ``bf16`` a
plain downcast; ``int8`` stochastic-rounded symmetric codes ``clip(floor(y
+ u), ±127)``; ``fp8`` e4m3 codes after a ±448 clamp. Quantized payloads are
``{"q": codes (..., n), "s": fp32 scales (..., n // 128)}``, one scale
``amax / maxcode`` per (row, 128) tile.

The stochastic-rounding noise is the reference's splitmix32 hash, bit for
bit: ``wire_key`` (per dispatch step, replica rank, bucket and seed) runs in
numpy uint32 on the host, where the step and ranks live; ``wire_uniform``
(per element) runs on the bucket's device. Torch has no ``>>`` or ``>=`` for
uint32 on the CPU, so the device hash keeps 32-bit values in int64 and
multiplies in two 16-bit halves, which never overflows int64.

Memory: one int64 temporary over the largest full-width bucket row
(155,582,464 elements) would be 1.24 GB, over the whole (4, n) bucket 5 GB.
``encode_wire`` therefore encodes one replica row at a time in column
chunks of ``CHUNK`` elements (a LANE multiple, so a 128-tile never
straddles two chunks): its temporaries stay near 0.3 GB each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

__all__ = ["LANE", "WIRE_DTYPES", "WireFormat", "wire_key", "wire_uniform",
           "encode_wire", "dequant_flat", "decode_wire", "zero_payload_like",
           "wire_itemsize", "dtype_bytes", "CODE_DTYPES"]

LANE = 128
WIRE_DTYPES = ("fp32", "bf16", "int8", "fp8")
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
CHUNK = 1 << 25                 # columns per encode pass (LANE multiple)
_MASK = 0xFFFFFFFF
_INT8_MAX = 127.0
_FP8_MAX = 448.0                # float8_e4m3fn max finite (no inf)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """``dtype`` picks the payload encoding; ``subset`` is the fraction of
    buckets sent per exchange (``core.topology.build_subset_schedule``);
    ``seed`` keys the stochastic rounding, apart from the drop seed."""

    dtype: str = "fp32"
    subset: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unknown wire dtype {self.dtype!r}; options {WIRE_DTYPES}")
        if not (0.0 < float(self.subset) <= 1.0):
            raise ValueError(
                f"gossip subset fraction must be in (0, 1], got {self.subset}")

    @property
    def is_default(self) -> bool:
        """The uncompressed full-participation wire: its async ring
        bootstraps with bucket copies, as the reference's does."""
        return self.dtype == "fp32" and float(self.subset) >= 1.0


# ------------------------------------------------------- splitmix32, host

def _u32(x) -> np.ndarray:
    """``x`` (ints, possibly negative) wrapped to uint32, at least 1-d so
    numpy wraps without scalar-overflow warnings."""
    return np.atleast_1d(np.asarray(x, np.int64) & _MASK).astype(np.uint32)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def wire_key(t, rank, bucket_index: int, seed: int = 0) -> np.ndarray:
    """uint32 key of the stochastic-rounding stream per (dispatch step,
    replica rank, bucket, seed); ``t`` and ``rank`` broadcast."""
    t, r = np.broadcast_arrays(np.asarray(t), np.asarray(rank))
    shape = t.shape
    x = (_u32(t) * np.uint32(0x9E3779B9)
         ^ _u32(r) * np.uint32(0x85EBCA6B)
         ^ np.uint32((int(bucket_index) * 0xC2B2AE35) & _MASK)
         ^ np.uint32(int(seed) & _MASK))
    return _mix32_np(x).reshape(shape)


# ----------------------------------------------------- splitmix32, device

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), in place: the
    product is split into 16-bit halves of ``c`` so nothing overflows."""
    hi = x * (c >> 16)
    hi.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return x.mul_(c & 0xFFFF).add_(hi).bitwise_and_(_MASK)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer over 32-bit values held in int64, in place."""
    x.bitwise_xor_(x >> 16)
    _mul32(x, 0x7FEB352D)
    x.bitwise_xor_(x >> 15)
    _mul32(x, 0x846CA68B)
    return x.bitwise_xor_(x >> 16)


def _uniform(key: int, lo: int, hi: int, base_index: int,
             device) -> torch.Tensor:
    """Noise of element indices [lo, hi) under one key, fp32 in [0, 1)."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    if base_index:
        idx.add_(int(base_index)).bitwise_and_(_MASK)
    h = _mix32(_mul32(idx, 0x9E3779B9).bitwise_xor_(int(key)))
    return (h >> 8).to(torch.float32).mul_(1.0 / (1 << 24))


def wire_uniform(keys, n: int, base_index: int = 0,
                 device="cpu") -> torch.Tensor:
    """Uniform [0, 1) noise of shape ``keys.shape + (n,)`` (fp32, 24-bit),
    hashed from each key and the GLOBAL element index ``base_index +
    arange(n)``."""
    keys = np.asarray(keys, np.uint32)
    rows = [_uniform(int(k), 0, n, base_index, device)
            for k in keys.reshape(-1)]
    return torch.stack(rows).reshape(keys.shape + (n,))


# ----------------------------------------------------------- encode/decode

def encode_wire(x: torch.Tensor, wire_dtype: str, *, keys=None,
                base_index: int = 0
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode one LANE-multiple bucket ``(..., n)`` for the wire, in the
    reference's fp32 op order. fp32 returns ``x`` itself, bf16 a downcast;
    int8/fp8 return ``{"q", "s"}``. int8 needs ``keys`` (``wire_key``, one
    per leading row, broadcast)."""
    if wire_dtype == "fp32":
        return x
    if wire_dtype == "bf16":
        return x.to(torch.bfloat16)
    if wire_dtype not in CODE_DTYPES:
        raise ValueError(
            f"unknown wire dtype {wire_dtype!r}; options {WIRE_DTYPES}")
    lead, n = tuple(x.shape[:-1]), int(x.shape[-1])
    if n % LANE:
        raise ValueError(f"quantized wire needs a lane-multiple bucket, "
                         f"got n={n}")
    int8 = wire_dtype == "int8"
    if int8 and keys is None:
        raise ValueError("int8 wire needs the dispatch keys (wire_key) for "
                         "its stochastic rounding")
    rows = x.detach().reshape(-1, n)
    row_keys = (np.broadcast_to(np.asarray(keys, np.uint32), lead).reshape(-1)
                if int8 else None)
    # the divisor is a tensor on x's device: CUDA divides by a host scalar
    # as a multiply by its reciprocal, which is not the reference's rounding
    maxcode = torch.tensor(_INT8_MAX if int8 else _FP8_MAX,
                           dtype=torch.float32, device=x.device)
    q = torch.empty(rows.shape, dtype=CODE_DTYPES[wire_dtype], device=x.device)
    s = torch.empty((rows.shape[0], n // LANE), dtype=torch.float32,
                    device=x.device)
    for r in range(rows.shape[0]):
        for lo in range(0, n, CHUNK):
            hi = min(n, lo + CHUNK)
            xf = rows[r, lo:hi].reshape(-1, LANE).float()
            scale = xf.abs().amax(dim=-1).div_(maxcode)
            inv = torch.where(scale > 0, torch.ones_like(scale).div_(scale),
                              0.0)
            y = xf * inv[:, None]
            del xf
            if int8:
                u = _uniform(int(row_keys[r]), lo, hi, base_index, x.device)
                y.add_(u.view(-1, LANE)).floor_()
                del u
                y.clamp_(-_INT8_MAX, _INT8_MAX)
            else:
                # e4m3fn has no inf: clamp before the cast, or an
                # out-of-range value would encode as nan
                y.clamp_(-_FP8_MAX, _FP8_MAX)
            q[r, lo:hi] = y.view(-1).to(q.dtype)
            s[r, lo // LANE:hi // LANE] = scale
    return {"q": q.reshape(lead + (n,)), "s": s.reshape(lead + (n // LANE,))}


def dequant_flat(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Codes ``(..., n)`` times their tile scales ``(..., n // 128)``, in
    fp32: ``f32(code) * scale``, the decode the kernels run."""
    lead, n = tuple(q.shape[:-1]), int(q.shape[-1])
    qf = q.reshape(lead + (n // LANE, LANE)).float()
    return (qf * s[..., None]).reshape(lead + (n,))


def decode_wire(payload) -> torch.Tensor:
    """Payload to mix operand: quantized dicts decode to fp32, raw payloads
    pass through."""
    if isinstance(payload, dict):
        return dequant_flat(payload["q"], payload["s"])
    return payload


def zero_payload_like(bucket: torch.Tensor, wire_dtype: str):
    """An all-zero payload of the wire's shape: the bootstrap of a wire
    ring (consumed only at alpha = 0)."""
    if wire_dtype == "fp32":
        return torch.zeros_like(bucket, requires_grad=False)
    if wire_dtype == "bf16":
        return torch.zeros(bucket.shape, dtype=torch.bfloat16,
                           device=bucket.device)
    lead, n = tuple(bucket.shape[:-1]), int(bucket.shape[-1])
    return {"q": torch.zeros(bucket.shape, dtype=CODE_DTYPES[wire_dtype],
                             device=bucket.device),
            "s": torch.zeros(lead + (n // LANE,), dtype=torch.float32,
                             device=bucket.device)}


def unsent_payload_like(bucket: torch.Tensor, wire_dtype: str):
    """The ring entry of a bucket the subset does not send: the reference's
    zero payload (``zero_payload_like``) as zero-stride views of one zero,
    which hold no memory. Such an entry is never consumed."""
    def zeros(shape, dtype):
        return torch.zeros((), dtype=dtype, device=bucket.device).expand(shape)
    meta = zero_payload_like(bucket.detach().to("meta"), wire_dtype)
    if isinstance(meta, dict):
        return {k: zeros(v.shape, v.dtype) for k, v in meta.items()}
    return zeros(meta.shape, meta.dtype)


def dtype_bytes(dtype) -> int:
    """Bytes per element of a torch dtype or a layout's dtype string (as
    numpy reckons it; ``"bfloat16"``, which plain numpy lacks, is 2)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return 2 if str(dtype) == "bfloat16" else int(np.dtype(dtype).itemsize)


def wire_itemsize(wire_dtype: str, bucket_dtype) -> int:
    """Bytes per code element on the wire (scales counted apart);
    ``bucket_dtype`` is a torch dtype or a layout's dtype string."""
    if wire_dtype == "fp32":
        return dtype_bytes(bucket_dtype)
    return {"bf16": 2, "int8": 1, "fp8": 1}[wire_dtype]
