"""A configuration's initial weights, made from the seed on the device in a
few large calls, in the configuration's parameter dtype: one draw of
N(0, 1) for every normally drawn weight, scaled per weight; one uniform
draw for every Mamba dt bias; the fixed ``A_log``, ones and zeros. The
program and the reference both start from these tensors."""
from __future__ import annotations

import math
from typing import List

import torch

from .traffic import stream_seed


def make(specs, seed: int, device, dtype: torch.dtype) -> List[torch.Tensor]:
    """One replica's weights in ``specs`` order (``(name, shape, init,
    scale)``, the reference's ``leaf_specs``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    numel = [math.prod(s[1]) for s in specs]
    out: List[torch.Tensor] = [None] * len(specs)
    normal = [j for j, s in enumerate(specs) if s[2] == "normal"]
    buf = torch.empty(sum(numel[j] for j in normal), dtype=dtype,
                      device=device)
    buf.normal_(generator=gen)
    off = 0
    for j in normal:
        out[j] = buf[off:off + numel[j]].view(specs[j][1]).mul_(specs[j][3])
        off += numel[j]
    dt = [j for j, s in enumerate(specs) if s[2] == "dt_bias"]
    if dt:
        u = torch.rand(sum(numel[j] for j in dt), generator=gen,
                       dtype=torch.float32, device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        v = torch.exp(u * (hi - lo) + lo)
        v = (v + torch.log(-torch.expm1(-v))).to(dtype)
        off = 0
        for j in dt:
            out[j] = v[off:off + numel[j]].view(specs[j][1])
            off += numel[j]
    for j, (_, shape, init, _) in enumerate(specs):
        if init == "A_log":
            n = shape[-1]
            a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
            out[j] = torch.log(a).expand(shape).to(dtype).contiguous()
        elif init in ("ones", "zeros"):
            out[j] = (torch.ones if init == "ones" else torch.zeros)(
                shape, dtype=dtype, device=device)
        elif out[j] is None:
            raise ValueError(f"{specs[j][0]}: unknown init {init!r}")
    return out
