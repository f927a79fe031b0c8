"""The system under test as the benchmark drives it: the port's
``make_train_step_bundle`` and ``init_train_state`` with the traffic
file's ``bundle`` keywords passed through as they stand, its optimizer
and schedule found by name in ``repro_torch.optim``, fed the benchmark's
weights, stepped through ``TrainStepBundle.step`` as ``Trainer.run``
steps it (``rotate=False``, the step counter as the phase), and read back
through its state. One process holds every replica, or (``group``) one
rank of a process mesh holds its own."""
from __future__ import annotations

import functools
import importlib
from typing import Dict, List, Optional

import torch


def program_config(cfg: Dict):
    return importlib.import_module(
        f"portbench.models.{cfg['family']}").program_config(cfg)


def program_optimizer(spec: Dict):
    """``{"name", "schedule": {"name", ...}, ...}`` to the port's optimizer:
    ``repro_torch.optim.<name>(<schedule>(...), ...)``."""
    from repro_torch import optim
    kw = dict(spec)
    sched = dict(kw.pop("schedule"))
    make = getattr(optim, kw.pop("name"))
    return make(getattr(optim, sched.pop("name"))(**sched), **kw)


class Program:
    def __init__(self, cfg: Dict, job: Dict, leaves: List[torch.Tensor], *,
                 seed: int, device, group=None, dist=None):
        from repro_torch.models import lm_specs
        from repro_torch.train import init_train_state, make_train_step_bundle
        from repro_torch.tree import tree_flatten
        self.pcfg = program_config(cfg)
        opt = program_optimizer(job["optimizer"])
        kw = dict(job["bundle"], seed=seed, wire_seed=seed, device=device)
        if job.get("ssm_scan_chunk"):
            from repro_torch.models.mamba import ssm_scan_chunked_torch
            kw["ssm_scan_impl"] = functools.partial(
                ssm_scan_chunked_torch, chunk=int(job["ssm_scan_chunk"]))
        where = {"dp": kw.pop("dp")}
        if group is not None:
            where = {"dist": dist, "group": group}
        self.bundle = make_train_step_bundle(self.pcfg, opt, **kw, **where)
        specs, td = tree_flatten(lm_specs(self.pcfg))
        got = [tuple(x.shape) for x in leaves]
        want = [tuple(s.shape) for s in specs]
        if got != want:
            raise ValueError(f"the weights' shapes {got} are not the "
                             f"program's {want}")
        packed = bool(kw.get("gossip_packed", False))
        self.state = init_train_state(
            self.pcfg, opt, packed=packed,
            layout=self.bundle.layout if packed else None,
            params=td.unflatten(list(leaves)), device=device,
            inbox=self.bundle.protocol.staleness, wire=self.bundle.wire,
            **where)
        self.steps = 0

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step on ``tokens`` (replicas held, rows, S+1); the
        replica-mean loss, on the device."""
        self.state, _, metrics = self.bundle.step(
            self.state, {"tokens": tokens}, self.steps, rotate=False)
        self.steps += 1
        return metrics["loss"]

    def leaves(self, which: str, key: Optional[str] = None
               ) -> List[torch.Tensor]:
        """The weights (``params``) or the optimizer state ``key`` (``opt``)
        as the program's leaves, each (replicas held, ...)."""
        from repro_torch.tree import tree_flatten
        x = self.state["params"] if which == "params" else (
            self.state["opt"][key])
        with torch.no_grad():
            tree = x.unpack() if hasattr(x, "unpack") else x
            return [v.detach() for v in tree_flatten(tree)[0]]

    def payload(self, bucket: int):
        """The newest dispatch's wire payload of ``bucket`` as this process
        received it: int8 codes and float32 scales on the host, or None
        where the wire carries no codes."""
        inbox = self.state.get("inbox")
        got = inbox["slots"][-1][bucket] if inbox else None
        if not isinstance(got, dict):
            return None
        return got["q"].detach().cpu(), got["s"].detach().cpu()
