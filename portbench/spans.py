"""The program's own spans (``repro_torch.spans``: ``repro.step``,
``repro.forward``, ``repro.backward``, ``repro.update``, ``repro.mixer``,
``repro.exchange``, ``repro.encode``) and counters, read from a profiler
session of the traced steps: for each span name, host seconds, inclusive
device seconds and launches, and the window's idle seconds.

The session is the kind ``trace.py`` reads: the ``portbench.window`` range
around ``k`` steps, each in a ``portbench.step`` range, the device
synchronized at both ends; the same device activity (every CUDA-side event
that is not a range, starting in the window) and the same idle gaps (the
window less the union of device intervals), so its totals reconcile with
``trace.Trace``. The rules:

* a range is a host event whose name starts with ``repro.``; a name counts
  as the union of its ranges, on every thread;
* a device event counts for a name when the host call with its correlation
  id (the runtime or driver call that launched it) starts inside a range of
  that name, on any thread: the host runs one step at a time, and the main
  thread waits inside ``repro.backward`` while autograd's thread launches.
  A name that nests in itself counts once;
* ``repro.mixer`` also holds each backward node (``autograd::engine::
  evaluate_function: ...``) whose sequence number and forward thread are
  those of a forward op that ran inside ``repro.mixer``: the mixer's
  backward. (Remat's recompute runs the mixer's code again inside the
  backward, in its own ``repro.mixer`` ranges.);
* an idle gap counts for a name when its middle lies inside a range of
  that name, the rule ``trace._host_op`` names gaps by.

``steps`` is the number of ``repro.step`` ranges that start in the window;
it must equal the traced step count. ``summarize_events`` is the rule over
plain records, ``events_of`` the adapter from a ``torch.profiler``
session, ``of(ctx)`` what the metric readers call.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib.util
from typing import Dict, List, NamedTuple, Optional, Tuple

from portbench import trace as T
from portbench.metrics.exchange_ms_per_step import NAMES as EXCHANGE_KERNELS

PREFIX = "repro."
STEP = PREFIX + "step"
FORWARD = PREFIX + "forward"
BACKWARD = PREFIX + "backward"
UPDATE = PREFIX + "update"
MIXER = PREFIX + "mixer"
EXCHANGE = PREFIX + "exchange"
ENCODE = PREFIX + "encode"
NODE = "autograd::engine::evaluate_function: "
AGREE, TRIES = 0.02, 3


class Event(NamedTuple):
    """One profiler record: times in ns; ``corr`` links a launch to its
    device events; ``seq`` and ``fwd_thread`` tie a backward node to the
    forward op that made it (``seq`` -1: none)."""
    name: str
    start: int
    end: int
    thread: int = 0
    corr: int = 0
    seq: int = -1
    fwd_thread: int = 0


@dataclasses.dataclass
class Spans:
    steps: int
    window_s: float
    busy_s: float
    device_events: int
    host_s: Dict[str, float]
    device_s: Dict[str, float]
    launches: Dict[str, int]
    idle_s: Dict[str, float]
    counters: Dict[str, int]

    def ms_per_step(self, table: Dict[str, float], name: str
                    ) -> Optional[float]:
        """``table``'s seconds of ``name`` as ms a step; None where no range
        of that name ran."""
        if name not in self.host_s:
            return None
        return 1e3 * table.get(name, 0.0) / self.steps


class _Ranges:
    """A sorted union of intervals, asked whether it holds a time."""

    def __init__(self, ivs: List[Tuple[int, int]]):
        merged: List[List[int]] = []
        for s, e in sorted(ivs):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]

    def seconds(self, w0: int, w1: int) -> float:
        return sum(max(0, min(e, w1) - max(s, w0))
                   for s, e in zip(self.starts, self.ends)) / 1e9


def mixer_nodes(host: List[Event]) -> List[Event]:
    """The backward nodes of the ops that ran inside ``repro.mixer``."""
    mixer = _Ranges([(e.start, e.end) for e in host if e.name == MIXER])
    made = {(e.seq, e.thread) for e in host
            if e.seq >= 0 and not e.name.startswith(NODE)
            and mixer.holds(e.start)}
    return [e for e in host if e.name.startswith(NODE)
            and (e.seq, e.fwd_thread) in made]


def summarize_events(host: List[Event], calls: List[Event],
                     device: List[Event], window: Tuple[int, int],
                     steps: int, counters: Optional[Dict[str, int]] = None
                     ) -> Spans:
    """The rules above over plain records: ``host`` the ranges and ops,
    ``calls`` the launching runtime calls, ``device`` the device events,
    ``window`` the window's (start, end)."""
    w0, w1 = window
    ivs: Dict[str, List[Tuple[int, int]]] = {}
    for e in host:
        if e.name.startswith(PREFIX) and e.end > w0 and e.start < w1:
            ivs.setdefault(e.name, []).append((e.start, e.end))
    found = sum(1 for s, _ in ivs.get(STEP, []) if w0 <= s < w1)
    if found != steps:
        raise RuntimeError(f"{found} {STEP!r} ranges in the window for "
                           f"{steps} traced steps")
    if MIXER in ivs:
        ivs[MIXER] += [(e.start, e.end) for e in mixer_nodes(host)]
    ranges = {name: _Ranges(v) for name, v in ivs.items()}
    launched = {e.corr: e.start for e in calls if e.corr}
    dev = sorted((e.start, e.end, e.corr) for e in device
                 if w0 <= e.start < w1)
    device_s = {name: 0.0 for name in ranges}
    launches = {name: 0 for name in ranges}
    for s, e, corr in dev:
        t = launched.get(corr)
        if t is None:
            continue
        for name, r in ranges.items():
            if r.holds(t):
                device_s[name] += (min(e, w1) - s) / 1e9
                launches[name] += 1
    busy, gaps, cur = 0, [], w0
    for s, e, _ in dev:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += min(e, w1) - max(s, cur)
            cur = min(max(cur, e), w1)
    if w1 > cur:
        gaps.append((cur, w1))
    idle_s = {name: 0.0 for name in ranges}
    for g0, g1 in gaps:
        for name, r in ranges.items():
            if r.holds((g0 + g1) // 2):
                idle_s[name] += (g1 - g0) / 1e9
    return Spans(steps=steps, window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 device_events=len(dev), host_s={n: r.seconds(w0, w1) for n, r in ranges.items()},
                 device_s=device_s, launches=launches, idle_s=idle_s,
                 counters=dict(counters or {}))


def events_of(prof):
    """``(host, calls, device, window)`` from a ``torch.profiler`` session
    with the ``portbench.window`` range: host ranges and the ops that carry
    a sequence number, runtime calls by ``trace.py``'s name rule, device
    events by its device rule."""
    from torch.autograd import DeviceType
    host, calls, device, win = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        s, name = e.start_ns(), e.name()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(T.MARK)):
                device.append(Event(name, s, end, corr=e.correlation_id()))
        elif name == T.WINDOW:
            win = (s, end)
        elif name.startswith(("cuda", "cu")):
            calls.append(Event(name, s, end, e.start_thread_id(),
                               e.correlation_id()))
        elif name.startswith(PREFIX) or e.sequence_nr() >= 0:
            host.append(Event(name, s, end, e.start_thread_id(),
                              seq=e.sequence_nr(),
                              fwd_thread=e.fwd_thread_id()))
    if win is None:
        raise RuntimeError(f"no {T.WINDOW!r} range in the trace")
    return host, calls, device, win


def summarize(prof, steps: int, counters=None) -> Spans:
    host, calls, device, win = events_of(prof)
    return summarize_events(host, calls, device, win, steps, counters)


def trace_steps(prog, job, cfg, rows: int, k: int):
    """``(profile, counters)``: ``k`` more steps of the program ``prog``
    traced as the harness traces its own (one step first, then the
    window), on a ring of ``k + 1`` batches drawn from seed 0 (the step's
    work does not depend on the tokens), and the counters' change over the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import traffic
    from repro_torch import spans as P
    dev = torch.device(prog.bundle.device)
    ring = traffic.make_ring(dict(job, ring=k + 1), cfg["vocab"], 0,
                             dev)[:, :rows]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prog.step(ring[0])
    sync()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    before = P.counters()
    with profile(activities=acts) as prof:
        with record_function(T.WINDOW):
            for j in range(k):
                with record_function(T.STEP):
                    prog.step(ring[j + 1])
            sync()
    after = P.counters()
    return prof, {n: v - before.get(n, 0) for n, v in after.items()}


def _off(sp: Spans, tr: T.Trace) -> float:
    """How far a session lies from the harness's trace of the same steps,
    the largest share: device events a step, busy time a step, and the
    device time inside ``repro.exchange`` a step against the exchange's
    kernels by name (``metrics/exchange_ms_per_step.py``)."""
    offs = [sp.device_events / sp.steps / (tr.device_events / tr.steps),
            sp.busy_s / sp.steps / (tr.busy_s / tr.steps)]
    seconds, launches = tr.kernel_seconds(*EXCHANGE_KERNELS)
    if launches:
        offs.append(sp.device_s.get(EXCHANGE, 0.0) / sp.steps
                    / (seconds / tr.steps))
    return max(abs(x - 1) for x in offs)


def of(ctx) -> Optional[Spans]:
    """The spans of the traced run ``ctx``: ``ctx.spans`` where the harness
    read them from its own traced steps, else as many more steps traced
    here (once a run: kept as ``ctx.spans``). None where the trace holds
    no device activity, the program has no spans, or no session agrees
    with the harness's trace.

    A second profiler session in a process has been seen, now and then, to
    lose device records or stretch their times (1.6% fewer events a step,
    12% more busy time, or the exchange's time 24% short, against the
    harness's trace of the same steps), so a session that lies more than
    ``AGREE`` from the harness's trace (``_off``) is traced again, up to
    ``TRIES`` times, and none is read if none agrees. Under a replica
    group every rank must step alike, so it traces once."""
    if hasattr(ctx, "spans"):
        return ctx.spans
    tr = ctx.trace
    if (tr is None or tr.device_events == 0 or tr.busy_s <= 0
            or ctx.program is None
            or importlib.util.find_spec("repro_torch.spans") is None):
        return None
    k = len(ctx.steps)
    ctx.spans = None
    for _ in range(TRIES if ctx.program.bundle.group is None else 1):
        prof, counters = trace_steps(ctx.program, ctx.job, ctx.cfg,
                                     ctx.rows, k)
        sp = summarize(prof, k, counters)
        del prof
        if _off(sp, tr) <= AGREE:
            ctx.spans = sp
            break
    return ctx.spans
