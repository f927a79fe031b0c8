"""Device ms a step of the exchange's kernels, by name: the stacked
replicas' row gathers (``index_select``: ``indexSelect*``, one launch a
sent bucket, two under the int8 wire), or NCCL's kernels between cards.
Nothing else on the train path launches ``index_select``: the embedding
lookup and its backward run ``index`` and ``index_put`` kernels."""

NAMES = ("indexSelect", "nccl")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(*NAMES)
    if not launches:
        return None
    return 1e3 * seconds / tr.steps
