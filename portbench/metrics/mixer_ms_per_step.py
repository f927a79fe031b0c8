"""Device ms a step of the blocks' self mixers (``models/blocks.py:
block_apply`` → ``attention.py`` or ``mamba.py``): launched inside
``repro.mixer`` in the forward and in remat's recompute, or by a backward
node of an op that ran there (``portbench/spans.py``)."""
from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s.ms_per_step(s.device_s, spans.MIXER)
