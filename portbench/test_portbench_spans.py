"""The reading of the program's spans (``portbench/spans.py``) on the CPU:
its rules on synthetic records (a nested name counts once, a launch from
another thread counts for the range it starts in, a backward node counts
for ``repro.mixer`` by its sequence number, an idle gap by its middle, a
short count of steps raises); a session is read only where it agrees
with the harness's trace; every new reader returns nothing without
device activity and reads what a summary holds; and a real CPU profile of
a toy cell's traced steps, whose ``repro.step`` ranges the adapter finds
and whose mixer's backward nodes map to ``repro.mixer``."""
import dataclasses
import types

import pytest

from portbench import spans as S
from portbench import toy, traffic, weights
from portbench.run import load_cell, reader
from portbench.trace import Trace

NEW = ["forward_ms_per_step", "backward_ms_per_step", "update_ms_per_step",
       "mixer_ms_per_step", "wire_encode_device_ms_per_step",
       "exchange_gb_per_s"]
E = S.Event
WINDOW = (0, 1000)


def _range(name, s, e, thread=1):
    return E(name, s, e, thread)


def _launch(corr, t, thread=1):
    return E("cudaLaunchKernel", t, t + 1, thread, corr)


def _kernel(corr, s, e):
    return E("kernel", s, e, corr=corr)


def _sum(host, calls, device, steps=1):
    return S.summarize_events(host, calls, device, WINDOW, steps)


def test_a_nested_name_counts_once():
    host = [_range(S.STEP, 0, 900), _range(S.UPDATE, 100, 500),
            _range(S.UPDATE, 200, 300)]
    got = _sum(host, [_launch(7, 250)], [_kernel(7, 260, 300)])
    assert got.launches[S.UPDATE] == got.launches[S.STEP] == 1
    assert got.device_s[S.UPDATE] == pytest.approx(40e-9)
    assert got.host_s[S.UPDATE] == pytest.approx(400e-9)


def test_a_launch_from_another_thread_counts_for_backward():
    host = [_range(S.STEP, 0, 900), _range(S.FORWARD, 10, 100),
            _range(S.BACKWARD, 100, 800)]
    calls = [_launch(1, 50), _launch(2, 400, thread=9)]
    got = _sum(host, calls, [_kernel(1, 60, 70), _kernel(2, 410, 450)])
    assert got.launches[S.BACKWARD] == 1 and got.launches[S.FORWARD] == 1
    assert got.device_s[S.BACKWARD] == pytest.approx(40e-9)
    assert got.launches[S.STEP] == 2


def test_a_backward_node_counts_for_the_mixer_by_its_sequence_number():
    node = S.NODE + "MmBackward0"
    host = [_range(S.STEP, 0, 900), _range(S.FORWARD, 10, 100),
            _range(S.MIXER, 20, 60),
            E("aten::mm", 30, 40, 1, seq=5),          # inside the mixer
            E("aten::mul", 70, 80, 1, seq=6),         # outside it
            _range(S.BACKWARD, 100, 800),
            E(node, 200, 300, 9, seq=5, fwd_thread=1),
            E(node, 400, 500, 9, seq=6, fwd_thread=1),
            E(node, 600, 700, 9, seq=5, fwd_thread=2)]   # another thread's
    calls = [_launch(1, 250, 9), _launch(2, 450, 9), _launch(3, 650, 9)]
    device = [_kernel(1, 255, 265), _kernel(2, 455, 475),
              _kernel(3, 655, 695)]
    got = _sum(host, calls, device)
    assert got.launches[S.MIXER] == 1
    assert got.device_s[S.MIXER] == pytest.approx(10e-9)
    assert got.launches[S.BACKWARD] == 3
    assert [e.start for e in S.mixer_nodes(host)] == [200]


def test_a_gap_counts_by_its_middle():
    host = [_range(S.STEP, 0, 1000), _range(S.FORWARD, 0, 400),
            _range(S.BACKWARD, 400, 1000)]
    # gaps: [0, 100) middle 50, [200, 500) middle 350, [600, 1000) middle 800
    got = _sum(host, [], [_kernel(1, 100, 200), _kernel(2, 500, 600)])
    assert got.idle_s[S.FORWARD] == pytest.approx(400e-9)
    assert got.idle_s[S.BACKWARD] == pytest.approx(400e-9)
    assert got.busy_s == pytest.approx(200e-9)
    assert got.device_s[S.STEP] == 0.0      # no launch recorded


def test_too_few_steps_raise():
    host = [_range(S.STEP, 0, 400)]
    with pytest.raises(RuntimeError, match="1 'repro.step' ranges"):
        _sum(host, [], [], steps=2)
    with pytest.raises(RuntimeError):
        _sum([], [], [], steps=1)


def _ctx(name="olmo1b-async-int8", **kw):
    bench, wl, cfg, job, limits = load_cell(toy.ROOT, name)
    tr = Trace(steps=2, window_s=1.0, busy_s=0.0, device_events=0,
               kernels={}, gaps=[])
    return types.SimpleNamespace(**dict(dict(
        cfg=cfg, job=job, rows=traffic.replicas(job), trace=tr,
        program=None, steps=[5, 6]), **kw))


@pytest.mark.parametrize("name", NEW)
def test_every_new_reader_reads_nothing_without_device_events(name):
    assert reader(toy.ROOT, name)(_ctx()) is None


def test_the_readers_read_a_summary():
    sp = S.Spans(steps=2, window_s=1.0, busy_s=0.9, device_events=10,
                 host_s={n: 0.1 for n in (S.STEP, S.FORWARD, S.BACKWARD,
                                          S.UPDATE, S.MIXER, S.ENCODE,
                                          S.EXCHANGE)},
                 device_s={S.FORWARD: 0.2, S.BACKWARD: 0.6, S.UPDATE: 0.08,
                           S.MIXER: 0.4, S.ENCODE: 0.05, S.EXCHANGE: 0.01},
                 launches={}, idle_s={S.BACKWARD: 0.02},
                 counters={"exchange_bytes": 3 * 10 ** 9})
    got = {n: reader(toy.ROOT, n)(_ctx(spans=sp)) for n in NEW}
    assert got == pytest.approx({
        "forward_ms_per_step": 100.0, "backward_ms_per_step": 300.0,
        "update_ms_per_step": 40.0, "mixer_ms_per_step": 200.0,
        "wire_encode_device_ms_per_step": 25.0, "exchange_gb_per_s": 300.0})
    sync = _ctx("olmo1b-sync-sgd", spans=sp)
    assert reader(toy.ROOT, "wire_encode_device_ms_per_step")(sync) is None


@pytest.mark.parametrize("name,inside", [
    ("olmo1b-sync-sgd", "SoftmaxBackward0"),
    ("mamba7b-sync-sgd-4k", "LogaddexpBackward0")])
def test_a_toy_cells_profile(name, inside):
    import torch

    from portbench.program import Program
    from portbench.reference.train import family
    bench, wl, cfg, job, limits = toy.toy_cell(name)
    dev = torch.device("cpu")
    prog = Program(cfg, job, weights.make(family(cfg).leaf_specs(cfg), 5,
                                          dev, torch.float32),
                   seed=5, device=dev)
    k = 2
    prof, counters = S.trace_steps(prog, job, cfg, traffic.replicas(job), k)
    host, calls, device, win = S.events_of(prof)
    got = S.summarize_events(host, calls, device, win, k, counters)
    assert got.steps == k and got.busy_s == 0.0
    assert counters["exchange_bytes"] > 0
    assert {S.STEP, S.FORWARD, S.BACKWARD, S.UPDATE, S.MIXER,
            S.EXCHANGE} <= set(got.host_s)
    nodes = {e.name[len(S.NODE):] for e in S.mixer_nodes(host)}
    assert inside in nodes
    assert not nodes & {"RsqrtBackward0", "LogsumexpBackward0"}
    # through the readers' entry, as if the trace held device activity:
    # no session here agrees with it, so each of the tries traces again
    # and nothing is read, once a run
    ctx = _ctx(name, cfg=cfg, job=job, program=prog, steps=list(range(k)),
               trace=dataclasses.replace(_ctx().trace, device_events=1,
                                         busy_s=0.5))
    assert reader(toy.ROOT, "forward_ms_per_step")(ctx) is None
    assert reader(toy.ROOT, "mixer_ms_per_step")(ctx) is None
    assert ctx.spans is None
    assert prog.steps == (k + 1) * (1 + S.TRIES)


def _session(events=20, busy=0.9, exchange=0.02):
    """A readers' session of two steps against ``_trace``'s."""
    return S.Spans(steps=2, window_s=1.0, busy_s=busy, device_events=events,
                   host_s={S.STEP: 1.0, S.EXCHANGE: 0.1},
                   device_s={S.EXCHANGE: exchange}, launches={},
                   idle_s={}, counters={"exchange_bytes": 10 ** 9})


def _trace():
    return Trace(steps=2, window_s=1.0, busy_s=0.9, device_events=20,
                 kernels={"indexSelectLargeIndex": [0.02, 4],
                          "gemm": [0.8, 16]}, gaps=[])


@pytest.mark.parametrize("off,share", [
    (dict(), 0.0), (dict(events=19), 0.05), (dict(busy=0.99), 0.1),
    (dict(exchange=0.0152), 0.24)])
def test_a_sessions_distance_from_the_harness_trace(off, share):
    assert S._off(_session(**off), _trace()) == pytest.approx(share)


def _traced(monkeypatch, sessions):
    """``of``'s sessions drawn from ``sessions``; the list of those taken."""
    taken = []

    def trace_steps(prog, job, cfg, rows, k):
        taken.append(sessions[len(taken)])
        return None, {}
    monkeypatch.setattr(S, "trace_steps", trace_steps)
    monkeypatch.setattr(S, "summarize", lambda prof, k, counters: taken[-1])
    prog = types.SimpleNamespace(bundle=types.SimpleNamespace(group=None))
    return taken, _ctx(trace=_trace(), program=prog)


def test_an_off_session_is_traced_again_and_one_that_agrees_kept(
        monkeypatch):
    good = _session(exchange=0.0201)
    taken, ctx = _traced(monkeypatch, [_session(exchange=0.0135), good])
    assert S.of(ctx) is good and len(taken) == 2
    assert reader(toy.ROOT, "exchange_gb_per_s")(ctx) == pytest.approx(
        1 / 0.0201)
    assert len(taken) == 2


def test_no_agreeing_session_reads_nothing(monkeypatch):
    taken, ctx = _traced(monkeypatch, [_session(events=19)] * S.TRIES)
    assert all(reader(toy.ROOT, n)(ctx) is None for n in NEW)
    assert len(taken) == S.TRIES
