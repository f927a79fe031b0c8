"""Device ms a step launched inside ``repro.forward`` (``train/step.py``:
the loss over the batch, every layer's forward), by the span rules of
``portbench/spans.py``."""
from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    return None if s is None else s.ms_per_step(s.device_s, spans.FORWARD)
