"""One reader per per-layer metric, ``<metric name>.py``, found by the name
in ``BENCHMARK.json``. ``read(ctx)`` returns the metric's value, or None
where the traced run holds nothing for it to read (the harness then leaves
the metric out of the line). ``ctx`` holds the configuration (``cfg``),
the traffic file (``job``), the replica rows this process holds
(``rows``), the trace summary (``trace.Trace``) of the traced steps, the
step numbers they ran at (``steps``) and the program (``program``). A run
on several cards reads each card's and reports their mean."""
