"""Device ms a step of the attention mixers (``models/attention.py``),
launched inside ``repro.mixer.attn`` in the forward and remat's recompute
or by a backward node of an op that ran there
(``portbench/mixer_kinds.py``)."""
from portbench import mixer_kinds


def read(ctx):
    return mixer_kinds.read(ctx, "attn")
