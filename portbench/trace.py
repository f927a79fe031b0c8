"""Reading a ``torch.profiler`` trace of a few steps: the device's busy time
and idle gaps inside the traced window, device time and launches by kernel
name, and the host op that ran during each gap.

The window is the harness's ``portbench.window`` range, with the device
synchronized at both ends; device activity is every CUDA-side event
(kernels, copies, sets), summed as a union of intervals, so overlapping
streams count once. Events are read from the profiler's raw results
(``key_averages()`` builds a Python record per event first, which at tens
of thousands of kernels a step takes minutes)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

MARK = "portbench."
WINDOW = MARK + "window"
STEP = MARK + "step"


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    device_events: int
    kernels: Dict[str, List[float]]        # name -> [seconds, launches]
    gaps: List[Tuple[str, float]]          # (host op during it, seconds)

    def kernel_seconds(self, *needles: str) -> Tuple[float, int]:
        """Seconds and launches of the kernels whose name holds any of
        ``needles``."""
        names = [k for k in self.kernels if any(n in k for n in needles)]
        return (sum(self.kernels[k][0] for k in names),
                int(sum(self.kernels[k][1] for k in names)))

    def breakdown(self, k: int = 10) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:k]
        return {"device_ops": [[n[:160], v[0]] for n, v in ops],
                "idle_gaps": [[n, s] for n, s in
                              sorted(self.gaps, key=lambda g: -g[1])[:k]]}


def _host_op(cpu: List[Tuple[int, int, str]], at: int) -> str:
    """The innermost host op or range running at ``at`` (ns, a gap's
    middle), not a CUDA runtime call."""
    best = None
    for s, e, name in cpu:
        if s <= at < e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "host (no op)"


def summarize(prof, steps: int) -> Trace:
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    cpu, dev, win = [], [], None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a range the harness marks shows up on the device's track too
            if not (e.is_user_annotation() or e.name().startswith(MARK)):
                dev.append((s, s + d, e.name()))
        elif e.name() == WINDOW:
            win = (s, s + d)
        elif not e.name().startswith(("cuda", "cu", "Memcpy", "Memset")):
            cpu.append((s, s + d, e.name()))
    if win is None:
        raise RuntimeError(f"no {WINDOW!r} range in the trace")
    w0, w1 = win
    dev = sorted(x for x in dev if w0 <= x[0] < w1)
    kernels: Dict[str, List[float]] = {}
    busy, gaps, cur = 0, [], w0
    for s, e, name in dev:
        rec = kernels.setdefault(name, [0.0, 0])
        rec[0] += (min(e, w1) - s) / 1e9
        rec[1] += 1
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += min(e, w1) - max(s, cur)
            cur = min(max(cur, e), w1)
    if w1 > cur:
        gaps.append((cur, w1))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    cpu = [c for c in cpu if c[1] > w0 and c[0] < w1]
    labelled = [(_host_op(cpu, (g0 + g1) // 2), (g1 - g0) / 1e9)
                for g0, g1 in longest]
    return Trace(steps=steps, window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                 device_events=len(dev), kernels=kernels, gaps=labelled)
