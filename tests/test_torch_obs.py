"""The port's spans and counters (``repro_torch.spans``) on the CPU, over a
toy packed train step of sync ``gossip`` and of ``gossip_async`` with the
int8 wire at subset 0.5 (4 stacked replicas, a reduced qwen3 cut into 4
buckets):

* with no profiler no ``record_function`` is entered and no counter moves;
* under a CPU profiler the ranges nest as ``repro.step`` ⊃
  {``repro.forward`` ⊃ ``repro.mixer``, ``repro.backward``,
  ``repro.update`` ⊃ {``repro.encode``, ``repro.exchange``}}, with one
  ``repro.mixer`` a layer in the forward and one more in the backward under
  remat (its recompute);
* ``exchange_bytes`` over a subset period is exactly what
  ``core/gossip.py: sent_bytes_at`` gives a replica row, times the rows
  held; the batch ring shuffle adds nothing;
* spans change no number: losses and params are bit-equal with the
  profiler on and off, remat off, on and ``"dots"`` (whose selective
  checkpoint's dispatch mode sees ``record_function``'s ops).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gossip import sent_bytes_at  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               make_train_step_bundle)
from repro_torch.train import step as step_mod  # noqa: E402

DP, ROWS, SEQ, BUCKETS = 4, 2, 8, 4
PROTOCOLS = {"sync": dict(protocol="gossip"),
             "async_int8": dict(protocol="gossip_async", staleness=2,
                                wire_dtype="int8", gossip_subset=0.5)}
REMATS = {"off": dict(remat=False), "on": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}
UPDATE_PARTS = (spans.ENCODE, spans.EXCHANGE)


@pytest.fixture(autouse=True)
def small(monkeypatch):
    """One intra-op thread, deterministic algorithms (the CPU embedding
    gather's backward adds in no fixed order otherwise) and 4 buckets."""
    was = (torch.get_num_threads(),
           torch.are_deterministic_algorithms_enabled())
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    monkeypatch.setattr(step_mod, "build_layout", functools.partial(
        step_mod.build_layout, target_bucket_bytes=40_000))
    yield
    torch.set_num_threads(was[0])
    torch.use_deterministic_algorithms(was[1])


def _run(proto, remat="off"):
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=32),
                              param_dtype="float32", compute_dtype="float32")
    opt = sgd(0.1, momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, gossip_packed=True,
                                    device="cpu", seed=3, wire_seed=3,
                                    **PROTOCOLS[proto], **REMATS[remat])
    assert bundle.layout.num_buckets == BUCKETS
    state = init_train_state(cfg, opt, dp=DP, packed=True,
                             layout=bundle.layout, device="cpu", seed=1,
                             inbox=bundle.protocol.staleness,
                             wire=bundle.wire)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (8, DP, ROWS, SEQ + 1), generator=gen)
    return cfg, bundle, state, toks


def _steps(bundle, state, toks, phases, rotate=False):
    losses = []
    for t in phases:
        state, _, m = bundle.step(state, {"tokens": toks[t % len(toks)]}, t,
                                  rotate=rotate)
        losses.append(m["loss"])
    return state, losses


def _ranges(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro.")]


def _within(inner, outers):
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


@pytest.mark.parametrize("proto", list(PROTOCOLS))
def test_spans_off_enter_nothing(proto, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, bundle, state, toks = _run(proto)
    before = spans.counters()
    _steps(bundle, state, toks, range(2), rotate=True)
    assert spans.counters() == before


@pytest.mark.parametrize("remat", ["off", "on"])
@pytest.mark.parametrize("proto", list(PROTOCOLS))
def test_spans_nest_in_the_step(proto, remat):
    cfg, bundle, state, toks = _run(proto, remat)
    state, _ = _steps(bundle, state, toks, range(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(bundle, state, toks, range(1, 2))
    got = _ranges(prof)
    by = {n: [r for r in got if r[0] == n] for n in
          (spans.STEP, spans.FORWARD, spans.BACKWARD, spans.UPDATE,
           spans.MIXER, spans.ENCODE, spans.EXCHANGE)}
    assert len(by[spans.STEP]) == 1
    assert len(by[spans.FORWARD]) == len(by[spans.BACKWARD]) == 1
    assert len(by[spans.UPDATE]) == 1 and by[spans.EXCHANGE]
    assert len(by) == len({r[0] for r in got})
    for name in (spans.FORWARD, spans.BACKWARD, spans.UPDATE):
        assert all(_within(r, by[spans.STEP]) for r in by[name])
    for name in UPDATE_PARTS:
        assert all(_within(r, by[spans.UPDATE]) for r in by[name]), name
    fwd = [r for r in by[spans.MIXER] if _within(r, by[spans.FORWARD])]
    bwd = [r for r in by[spans.MIXER] if _within(r, by[spans.BACKWARD])]
    assert len(fwd) == cfg.n_layers
    assert len(bwd) == (cfg.n_layers if remat == "on" else 0)
    assert len(fwd) + len(bwd) == len(by[spans.MIXER])


@pytest.mark.parametrize("proto", list(PROTOCOLS))
def test_exchange_bytes_count_what_the_wire_sends(proto):
    _, bundle, state, toks = _run(proto)
    period = bundle.protocol.period
    state, _ = _steps(bundle, state, toks, range(1))
    before = spans.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = _steps(bundle, state, toks, range(1, 1 + period))
    after = spans.counters()
    want = sum(sent_bytes_at(bundle.layout, bundle.wire, t % period)
               ["total_bytes"] for t in range(1, 1 + period)) * DP
    assert after[spans.EXCHANGE_BYTES] - before.get(
        spans.EXCHANGE_BYTES, 0) == want
    # one exchange range a sent bucket
    sent = period * (BUCKETS if proto == "sync" else BUCKETS // 2)
    assert sum(r[0] == spans.EXCHANGE for r in _ranges(prof)) == sent
    # the same phase with the batch shuffle: the shuffle counts nothing
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(bundle, state, toks, [1 + period], rotate=True)
    shuffled = spans.counters()
    assert (shuffled[spans.EXCHANGE_BYTES] - after[spans.EXCHANGE_BYTES]
            == sent_bytes_at(bundle.layout, bundle.wire,
                             (1 + period) % period)["total_bytes"] * DP)


@pytest.mark.parametrize("remat", list(REMATS))
@pytest.mark.parametrize("proto", list(PROTOCOLS))
def test_spans_change_no_number(proto, remat):
    runs = []
    for traced in (False, True):
        _, bundle, state, toks = _run(proto, remat)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                state, losses = _steps(bundle, state, toks, range(3))
            assert any(r[0] == spans.MIXER for r in _ranges(prof))
        else:
            state, losses = _steps(bundle, state, toks, range(3))
        runs.append((torch.stack(losses),
                     [b.detach().clone() for b in state["params"].buckets]))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
