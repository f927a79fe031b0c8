"""Model FLOPs of a step (``yardstick.train_flops_per_step``) over the
traced steps' wall time a step times the bf16 dense peak, in %: of the
replicas this process holds, on its card."""
from portbench.yardstick import PEAK, train_flops_per_step


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.busy_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return 100.0 * train_flops_per_step(ctx.cfg, ctx.job, ctx.rows) / (
        step_s * PEAK["bf16_flops"])
