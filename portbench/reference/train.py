"""GossipGraD training steps in plain PyTorch: the reference that a cell's
first steps are judged by.

``dp`` replicas start from the same weights. At step ``t`` each replica
takes the gradient of its own loss on its own rows; the protocol
(``protocols/<bundle.protocol>.py``) mixes its weights, bucket by bucket,
with a partner's, rounded to the parameter dtype; then the optimizer
(``optim/<optimizer.name>.py``) steps from the mixed weights at the
schedule's rate (``schedules/<optimizer.schedule.name>.py``), all
arithmetic in float32 and the weights and the state stored in the
configuration's dtype: the single sweep of GossipGraD's fused engine.

The model's loss and gradient come from the family's plain module
(``dense``, ``mamba``), in float32 or, for the control, with fp8 products
(``precision``). ``fault`` plants one of the faults a program could have:
``half`` (each replica's loss over half its rows, or half its positions
where it has one row), ``no_exchange`` (each replica its own partner) or
``wire_key`` (a coded wire keyed by the wrong dispatch).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import gossip as G
from .precision import matmul_fn, strict_fp32

FAULTS = (None, "half", "no_exchange", "wire_key")


def _module(kind: str, name: str):
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def family(cfg: Dict):
    return importlib.import_module(f"{__package__}.{cfg['family']}")


def protocol(job: Dict):
    return _module("protocols", job["bundle"]["protocol"])


def optimizer(job: Dict):
    return _module("optim", job["optimizer"]["name"])


def half_of(tokens: torch.Tensor) -> torch.Tensor:
    """Half of a replica's batch: its first half of rows, or of positions
    where it has one row."""
    b, s1 = tokens.shape[-2], tokens.shape[-1]
    if b >= 2:
        return tokens[..., :b // 2, :]
    return tokens[..., :(s1 - 1) // 2 + 1]


def leaf_norms(x: torch.Tensor) -> torch.Tensor:
    """Per replica row, the float64 norm of ``x`` (rows, ...)."""
    return torch.linalg.vector_norm(x.reshape(x.shape[0], -1).float(),
                                    dim=1, dtype=torch.float64)


class Reference:
    """The first steps of a cell in plain PyTorch. ``leaves``: one
    replica's initial weights in ``leaf_specs`` order (the configuration's
    dtype)."""

    def __init__(self, cfg: Dict, job: Dict, leaves: List[torch.Tensor], *,
                 seed: int, precision: str = "fp32",
                 fault: Optional[str] = None):
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: want one of {FAULTS}")
        strict_fp32()
        self.cfg, self.job, self.fault, self.seed = cfg, job, fault, seed
        self.fam = family(cfg)
        self.specs = self.fam.leaf_specs(cfg)
        self.mm = matmul_fn(precision)
        self.dp = int(job["bundle"]["dp"])
        self.dev = leaves[0].device
        self.dtype = leaves[0].dtype
        sizes = [int(np.prod(s[1])) for s in self.specs]
        self.slots, self.sizes = G.flat_layout(sizes, leaves[0].element_size())
        self.leaf_sizes = sizes
        self.buckets = [torch.zeros(self.dp, n, dtype=self.dtype,
                                    device=self.dev) for n in self.sizes]
        for j, x in enumerate(leaves):
            self.view(self.buckets, j).copy_(x.reshape(1, -1).expand(self.dp, -1))
        self.opt = optimizer(job)
        self.state = {}
        for b in self.buckets:
            for k, v in self.opt.init(b).items():
                self.state.setdefault(k, []).append(v)
        self.sched = _module("schedules", job["optimizer"]["schedule"]["name"])
        self.proto = protocol(job).Protocol(self)
        self.t = 0

    def view(self, buckets, j: int) -> torch.Tensor:
        b, off = self.slots[j]
        return buckets[b][:, off:off + self.leaf_sizes[j]]

    def leaves(self, buckets) -> List[torch.Tensor]:
        return [self.view(buckets, j).view((self.dp,) + tuple(s[1]))
                for j, s in enumerate(self.specs)]

    def _grad(self, r: int, tokens: torch.Tensor):
        w = {s[0]: x[r].float().requires_grad_(True)
             for s, x in zip(self.specs, self.leaves(self.buckets))}
        if self.fault == "half":
            tokens = half_of(tokens)
        loss = self.fam.loss(w, tokens, self.cfg, self.mm)
        loss.backward()
        return loss.detach(), [w[s[0]].grad.reshape(-1) for s in self.specs]

    def step(self, tokens: torch.Tensor) -> float:
        """One step on ``tokens`` (dp, b, S+1); returns the replica-mean
        loss. Updates the weights and the optimizer state in place."""
        t, args = self.t, self.job["optimizer"]
        lr = self.sched.lr(args["schedule"], t)
        mix = self.proto.begin(self, t)
        losses, self.first_grads = [], []
        for r in range(self.dp):
            loss, grads = self._grad(r, tokens[r])
            losses.append(loss)
            if t == 0:
                self.first_grads.append([leaf_norms(g[None])[0]
                                         for g in grads])
            for i in range(len(self.buckets)):
                p32 = self.buckets[i][r].float()
                mixed = mix(i, r, p32) if mix is not None else None
                if mixed is not None:
                    p32 = mixed.to(self.dtype).float()
                g32 = torch.zeros_like(p32)
                for j, (b, off) in enumerate(self.slots):
                    if b == i:
                        g32[off:off + self.leaf_sizes[j]] = grads[j]
                st = {k: v[i][r].float() for k, v in self.state.items()}
                p32, st = self.opt.update(p32, g32, st, lr=lr, args=args)
                self.buckets[i][r] = p32.to(self.dtype)
                for k, v in st.items():
                    self.state[k][i][r] = v.to(self.state[k][i].dtype)
            del grads
        self.proto.end(self, t)
        self.t += 1
        return float(torch.stack(losses).mean())


def readings(cfg: Dict, job: Dict, leaves: List[torch.Tensor],
             batches: torch.Tensor, *, seed: int, precision: str = "fp32",
             fault: Optional[str] = None,
             payloads: Sequence[int] = ()) -> Dict:
    """What the comparison reads from ``len(batches)`` reference steps:
    each step's loss; per replica and leaf the norm of the first gradient
    as the optimizer holds it after the first step, and in float32 as the
    model gives it; the norm of the weights' change after the last step;
    and dispatch 0's wire payloads of the buckets ``payloads``."""
    ref = Reference(cfg, job, leaves, seed=seed, precision=precision,
                    fault=fault)
    losses, held = [], None
    for t in range(batches.shape[0]):
        losses.append(ref.step(batches[t]))
        if t == 0:
            held = torch.stack(
                [leaf_norms(ref.opt.first_gradient(x, job["optimizer"]))
                 for x in ref.leaves(ref.state[ref.opt.HELD])], 1)
            grad = torch.tensor([[float(v) for v in row]
                                 for row in ref.first_grads],
                                dtype=torch.float64)
    change = torch.stack(
        [leaf_norms(x.float() - x0.float().reshape((1,) + tuple(x.shape[1:])))
         for x, x0 in zip(ref.leaves(ref.buckets), leaves)], 1)
    out = {"losses": losses, "held_norms": held.cpu().tolist(),
           "grad_norms": grad.tolist(), "change_norms": change.cpu().tolist()}
    if payloads:
        out["payloads"] = ref.proto.payloads(list(payloads))
    return out
