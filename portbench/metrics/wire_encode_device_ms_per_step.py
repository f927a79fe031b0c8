"""Device ms a step launched inside ``repro.encode`` (``core/gossip.py:
encode_bucket`` → ``kernels/quantize.py: encode_wire``): the wire's
encode inside the step, where ``wire_encode_ms_per_step`` times it again
from outside (``portbench/spans.py``). None without the int8 wire."""
from portbench import spans


def read(ctx):
    if ctx.job["bundle"].get("wire_dtype") != "int8":
        return None
    s = spans.of(ctx)
    return None if s is None else s.ms_per_step(s.device_s, spans.ENCODE)
