"""Device ms a step launched inside ``repro.update`` (``train/step.py``:
the gradient exchange, the encode, the exchange and the fused sweep or
the optimizer and the mix), by the span rules of
``portbench/spans.py``."""
from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s.ms_per_step(s.device_s, spans.UPDATE)
