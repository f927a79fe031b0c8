"""The blocks' self mixers split by kind: device ms a step launched inside
``repro.mixer.mamba`` or ``repro.mixer.attn`` (attention and MLA), the
program's ranges inside ``repro.mixer`` (``models/blocks.py:
block_apply``), with ``repro.mixer``'s attribution: the forward, remat's
recompute, and the backward nodes of the ops that ran inside
(``portbench/spans.py``).

Read from a traced session of its own (``spans.trace_steps``,
``spans.events_of``): ``spans.summarize_events`` over its host events with
one kind's ranges named ``repro.mixer`` and every other range of the mixer
dropped. A session is read only where it agrees with the harness's trace
(``spans._off`` within ``spans.AGREE``), up to ``spans.TRIES`` sessions
(one under a replica group, whose ranks must step alike), once a run
(``ctx.mixer_kinds``); a kind with no range in it reads nothing."""
from __future__ import annotations

from typing import Dict, List, Optional

from portbench import spans

KINDS = {"mamba": spans.MIXER + ".mamba", "attn": spans.MIXER + ".attn"}


def as_mixer(host: List[spans.Event], name: str) -> List[spans.Event]:
    """``host`` with the ranges ``name`` renamed ``repro.mixer`` and the
    other ranges of the mixer (``repro.mixer``, ``repro.mixer.*``)
    dropped."""
    out = []
    for e in host:
        if e.name == name:
            out.append(e._replace(name=spans.MIXER))
        elif not (e.name == spans.MIXER
                  or e.name.startswith(spans.MIXER + ".")):
            out.append(e)
    return out


def split(host, calls, device, window, steps) -> Dict[str, Optional[float]]:
    """Device ms a step of each kind's mixers; None for a kind with no
    range in the session."""
    out = {}
    for kind, name in KINDS.items():
        if not any(e.name == name for e in host):
            out[kind] = None
            continue
        sp = spans.summarize_events(as_mixer(host, name), calls, device,
                                    window, steps)
        out[kind] = sp.ms_per_step(sp.device_s, spans.MIXER)
    return out


def _measure(ctx) -> Optional[Dict[str, Optional[float]]]:
    tr = ctx.trace
    if (tr is None or tr.device_events == 0 or tr.busy_s <= 0
            or ctx.program is None):
        return None
    k = len(ctx.steps)
    for _ in range(spans.TRIES if ctx.program.bundle.group is None else 1):
        prof, counters = spans.trace_steps(ctx.program, ctx.job, ctx.cfg,
                                           ctx.rows, k)
        host, calls, device, window = spans.events_of(prof)
        del prof
        whole = spans.summarize_events(host, calls, device, window, k,
                                       counters)
        if spans._off(whole, tr) <= spans.AGREE:
            return split(host, calls, device, window, k)
    return None


def read(ctx, kind: str) -> Optional[float]:
    """Device ms a step of the ``kind`` mixers ("mamba" or "attn") of the
    traced run ``ctx``, or None."""
    if not hasattr(ctx, "mixer_kinds"):
        ctx.mixer_kinds = _measure(ctx)
    return None if ctx.mixer_kinds is None else ctx.mixer_kinds[kind]
