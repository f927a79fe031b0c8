"""Device ms a step of the Mamba mixers (``models/mamba.py``), launched
inside ``repro.mixer.mamba`` in the forward and remat's recompute or by a
backward node of an op that ran there (``portbench/mixer_kinds.py``)."""
from portbench import mixer_kinds


def read(ctx):
    return mixer_kinds.read(ctx, "mamba")
