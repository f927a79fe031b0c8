"""One cell of the PyTorch port's benchmark, once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json``: its configuration file under
``portbench/configs/``, its traffic file ``portbench/traffic/<traffic>.json``
and its limits ``portbench/limits/<workload>.json``. The traffic file's
``kind`` names the module that runs it, ``portbench/kinds/<kind>.py``
(``train``: set-up, the timed window or the traced steps, then the plain
reference and the comparison that decides ``correct``).

Prints one JSON line last on standard output; exits non-zero and prints
none without as many CUDA cards as the cell asks for, or if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every kernel cache inside the checkout, at fixed paths (the port's
    own nvcc libraries already go to ``build/kernels/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def load_cell(root: Path, workload: str):
    """(benchmark, workload entry, configuration, traffic, limits)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    base = root / "portbench"
    job = json.loads((base / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    return bench, wl, cfg, job, limits


def applies(metric, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device: str = "cuda", t_start: float = None,
             cell=None):
    """One run of ``workload`` by its traffic's kind; returns the result
    dict (the JSON line) and the standard error lines of its checks.
    ``t_start`` is the run's start by the wall clock (the process's by
    default); ``cell`` may replace what ``load_cell`` reads (the tests'
    small cells)."""
    cell = cell or load_cell(root, workload)
    kind = importlib.import_module(f"portbench.kinds.{cell[3]['kind']}")
    return kind.run_cell(workload, seed, seconds, trace, root=root,
                         device=device, cell=cell,
                         t_start=T_START if t_start is None else t_start)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    import torch
    bench, wl, *_ = load_cell(ROOT, args.workload)
    want = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"needs {want} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {power_limit()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr)
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
