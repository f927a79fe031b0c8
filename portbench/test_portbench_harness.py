"""The harness on the CPU at toy size: a clean run of each cell comes out
correct under the cell's limits (``test_portbench_faults.py`` breaks it);
a traced run reads only what its trace holds; nothing the harness loads
is JAX or the JAX package; the benchmark file keeps to its contract's
shape. The look for a card is skipped: ``run_cell`` runs on the CPU."""
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import compare, toy
from portbench.run import forbidden_modules, load_cell, run_cell

CELLS = ["olmo1b-sync-sgd", "mamba7b-sync-sgd-4k", "olmo1b-async-int8"]
SEED = 2 ** 31 + 17


def _run(name, trace=False, seed=SEED, cell=None):
    return run_cell(name, seed, 0.2, trace, device="cpu",
                    t_start=time.time(), cell=cell or toy.toy_cell(name))


@pytest.mark.parametrize("name", CELLS)
def test_portbench_clean_run_is_correct(name):
    res, lines = _run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert [ln.split()[1] for ln in lines[-len(res["checks"]):]] == list(
        res["checks"])
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(res["checks"])
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "train_peak_gb",
                                   "setup_s"}


def test_portbench_traced_run_reads_only_what_it_finds():
    """On the CPU the trace holds no device activity: every device reader
    returns nothing, the host-clock encode timing still reads."""
    res, _ = _run("olmo1b-async-int8", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"wire_encode_ms_per_step"}
    assert res["device"]["busy_s"] == 0.0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_portbench_loads_no_jax():
    """In a fresh process, the harness and every cell's path at toy size
    load no module named jax, jaxlib, flax or repro (whole top-level
    names: repro_torch is not repro)."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(toy.ROOT)!r}, {str(toy.ROOT / 'src')!r}]\n"
        "from portbench import run, toy, calibrate\n"
        f"for name in {CELLS!r}:\n"
        "    run.run_cell(name, 5, 0.05, name.endswith('int8'), device='cpu',\n"
        "                 t_start=time.time(), cell=toy.toy_cell(name))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]", found
    assert "'repro_torch'" in loaded and "'jax'" not in loaded
    assert forbidden_modules.__doc__


def test_portbench_benchmark_file_keeps_its_shape():
    root = toy.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "train_tokens_per_s", "train_peak_gb"} <= e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200
        load_cell(root, w["name"])       # its files exist
        lim = json.loads((root / "portbench" / "limits" /
                          f"{w['name']}.json").read_text())
        assert {"loss_gap", "grad_gap", "change_gap"} <= set(lim)
        assert all(isinstance(lim[k], float) for k in compare.NAMES
                   if k in lim)
    for m in bench["per_layer"]:
        assert name.match(m["name"]) and m["moves"] in e2e
        assert (root / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for c in bench["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])


def test_portbench_ranks_run_is_correct():
    """A cell on four cards runs one process a card; on the CPU, four gloo
    ranks of the port's replica mode at toy size. Their readings, in
    replica order, pass the cell's limits against the same reference, and
    the rate counts all four replicas' tokens."""
    bench, wl, cfg, job, limits = toy.toy_cell("olmo1b-sync-sgd")
    cell = (bench, dict(wl, chips=4), cfg, job, limits)
    res, lines = _run("olmo1b-sync-sgd", cell=cell)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4 and res["attempted"] >= 1
    assert res["checks"]["grad_gap"]["value"] < 1e-4
    assert any(ln.startswith("setup to the window") for ln in lines)
    traced, _ = _run("olmo1b-sync-sgd", trace=True, cell=cell)
    assert traced["correct"] and traced["metrics"] == {}
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_portbench_toy_cell_on_the_card(card, name):
    res, _ = run_cell(name, SEED, 0.5, False, device=card,
                      t_start=time.time(), cell=toy.toy_cell(name))
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes"] > 0
