"""A benchmark cell shrunk to a size a CPU test holds: the cell's own
``BENCHMARK.json`` entry, traffic file and limits, its configuration at
toy widths (the families' shapes, not their sizes), short sequences and
float32 weights and products, where the program and the reference agree
to rounding: a clean run then passes the cell's limits by a wide margin,
and a run that fails them fails by its fault. For the tests only; the
benchmark's runs never use it."""
from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_TOY = {"dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256),
        "mamba": dict(n_layers=2, d_model=64, d_state=8, dt_rank=4,
                      vocab=256)}


def toy_cell(workload: str):
    """``(bench, workload entry, cfg, job, limits)`` of ``workload`` at toy
    size in float32."""
    from portbench.run import load_cell
    bench, wl, cfg, job, limits = load_cell(ROOT, workload)
    cfg = dict(cfg, **_TOY[cfg["family"]], param_dtype="float32",
               compute_dtype="float32")
    job = dict(job, seq_len=32, ring=6)
    if job.get("ssm_scan_chunk"):
        job["ssm_scan_chunk"] = 8
    return bench, wl, cfg, job, limits
