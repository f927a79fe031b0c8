"""One module a traffic ``kind``: ``run_cell(workload, seed, seconds,
trace, *, root, device, t_start, cell)`` runs one cell of that kind once
and returns its result line and its standard error lines."""
