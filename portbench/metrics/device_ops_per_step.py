"""Device activities (kernels, copies, sets) a step in the traced window."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.device_events == 0:
        return None
    return tr.device_events / tr.steps
