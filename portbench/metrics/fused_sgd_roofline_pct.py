"""The fused mix+SGD sweep's share of its memory roofline, %: the bytes
its launches in the traced steps must move once
(``yardstick.fused_sgd_bytes``) over the HBM rate, against their traced
time."""
from portbench.yardstick import PEAK, fused_sgd_bytes


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds("fused_sgd_kernel")
    if not launches:
        return None
    nbytes = sum(fused_sgd_bytes(ctx.cfg, ctx.job, s, ctx.rows)
                 for s in ctx.steps)
    return 100.0 * nbytes / PEAK["hbm_bytes"] / seconds
