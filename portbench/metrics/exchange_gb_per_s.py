"""The exchange's rate, GB/s: the bytes this process's replica rows
receive (the program's ``exchange_bytes`` counter, ``core/gossip.py:
exchange``) over the device seconds launched inside ``repro.exchange``
(``portbench/spans.py``). Stacked, the ``index_select`` reads as many
bytes again."""
from portbench import spans


def read(ctx):
    s = spans.of(ctx)
    if s is None or not s.device_s.get(spans.EXCHANGE):
        return None
    return s.counters.get("exchange_bytes", 0) / s.device_s[spans.EXCHANGE] / 1e9
