"""A run with the timed path broken underneath comes out not correct, on
the CPU at toy size under each cell's limits: the state returned
unchanged, half of each replica's batch with the mean over the rest, the
exchange left out, the wire's codes keyed by the wrong dispatch. So does
the control: the reference with fp8 products put in the program's
place."""
import pytest
import torch

from portbench import compare, toy, yardstick
from portbench.reference.train import family, half_of, readings
from portbench.test_portbench_harness import CELLS, SEED, _run


def _unchanged(monkeypatch):
    from repro_torch.core import PackedParams
    from repro_torch.train.step import TrainStepBundle
    orig = TrainStepBundle.step

    def step(self, state, batch, phase, *, rotate=True):
        p = state["params"]
        copy = {"params": PackedParams([b.detach().clone().requires_grad_()
                                        for b in p.buckets], p.layout),
                "opt": dict(state["opt"], mom=state["opt"]["mom"].like(
                    [m.clone() for m in state["opt"]["mom"].buckets]))}
        if "inbox" in state:
            copy["inbox"] = state["inbox"]
        _, nxt, metrics = orig(self, copy, batch, phase, rotate=rotate)
        return state, nxt, metrics
    monkeypatch.setattr(TrainStepBundle, "step", step)


def _half(monkeypatch):
    from portbench.program import Program
    orig = Program.step
    monkeypatch.setattr(Program, "step",
                        lambda self, tokens: orig(self, half_of(tokens)))


def _no_exchange(monkeypatch):
    from repro_torch.core import async_gossip, gossip
    ident = lambda x, recv_from, group=None: x  # noqa: E731
    monkeypatch.setattr(gossip, "exchange", ident)
    monkeypatch.setattr(async_gossip, "exchange", ident)


def _wire_key(monkeypatch):
    from repro_torch.core import async_gossip
    orig = async_gossip.encode_bucket
    monkeypatch.setattr(
        async_gossip, "encode_bucket",
        lambda wire, b, t, i, group=None: orig(wire, b, t + 1, i, group))


FAULTS = {"unchanged": _unchanged, "half": _half, "no_exchange": _no_exchange,
          "wire_key": _wire_key}


@pytest.mark.parametrize("fault,name", [
    (f, n) for f in ("unchanged", "half", "no_exchange") for n in CELLS] + [
    ("wire_key", "olmo1b-async-int8")])
def test_portbench_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    FAULTS[fault](monkeypatch)
    res, _ = _run(name)
    assert not res["correct"], res["checks"]
    if fault == "wire_key":
        assert res["checks"]["wire_gap"]["value"] > 0.05


@pytest.mark.parametrize("name", CELLS)
def test_portbench_control_is_not_correct(name):
    """The reference with fp8 products, put in the program's place, fails
    the cell's limits."""
    _, _, cfg, job, limits = toy.toy_cell(name)
    from portbench import traffic, weights
    from portbench.reference.train import protocol
    specs = family(cfg).leaf_specs(cfg)
    dt = getattr(torch, cfg["param_dtype"])
    fails = 0
    for seed in (SEED, SEED + 1):
        ring = traffic.make_ring(job, cfg["vocab"], seed, "cpu")[:3]
        leaves = weights.make(specs, seed, "cpu", dt)
        pay = protocol(job).checked_payloads(
            job, len(yardstick.buckets(cfg)), seed)
        ref = readings(cfg, job, leaves, ring, seed=seed, payloads=pay)
        ctl = readings(cfg, job, leaves, ring, seed=seed, precision="fp8",
                       payloads=pay)
        ok, checks = compare.judge(
            compare.gaps(dict(ctl, grad_norms=ref["grad_norms"]), ref), limits)
        fails += not ok
    assert fails == 2
