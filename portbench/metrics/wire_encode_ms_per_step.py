"""Host ms a step of the int8 wire's encode (``kernels/quantize.py:
encode_wire`` through ``core/gossip.py: encode_bucket``), timed after the
traced steps from outside the step: per step of the rotating subset's
period, the device synchronized, every bucket that step sends encoded at
its shape with its keys, synchronized again; the median of 3 rounds, then
the mean over the period. None without the int8 wire."""
import statistics
import time

import torch

from portbench.reference import gossip as G


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def read(ctx):
    b = ctx.job["bundle"]
    if b.get("wire_dtype") != "int8" or ctx.program is None:
        return None
    from repro_torch.core.gossip import encode_bucket
    bundle, prog = ctx.program.bundle, ctx.program
    bks = prog.state["params"].buckets
    dev = bks[0].device
    period = G.subset_period(len(bks), float(b["gossip_subset"]))
    per_step = []
    with torch.no_grad():
        for k in range(period):
            t = prog.steps + k
            sent = G.subset_mask(len(bks), float(b["gossip_subset"]), t)
            rounds = []
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                for i, x in enumerate(bks):
                    if sent[i]:
                        encode_bucket(bundle.wire, x.detach(), t, i,
                                      bundle.group)
                _sync(dev)
                rounds.append(time.perf_counter() - t0)
            per_step.append(statistics.median(rounds))
    return 1e3 * sum(per_step) / period
