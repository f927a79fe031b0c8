"""Training cells (traffic ``kind`` "train"), once.

1. set-up, in every process of the run: the weights and a ring of
   distinct token batches made on the card from the seed; the program's
   train step (``program.Program``) built from them; its first
   ``checked_steps`` steps driven through the same call the window
   drives, reading each step's loss, the first gradient as the optimizer
   holds it after the first step, the weights' change after the last, and
   the wire payloads that the protocol names; then the rest of
   ``warmup_steps``, so that every phase has run (kernels built into
   ``build/kernels/`` on a checkout's first run);
2. the window: steps back to back for ``--seconds``, the batches taken
   round the ring, no host read inside; it closes at the device
   synchronization after the last step dispatched. With ``--trace 1`` the
   profiler records a whole protocol period (at least ``TRACE_STEPS``
   steps) after one step instead, and the per-layer metrics are read from
   it (``portbench/metrics/<name>.py``);
3. the program freed, the plain reference (``portbench/reference/``) runs
   the checked steps from the same weights and batches, and ``correct``
   is decided (``compare.py``).

A cell on one chip runs in this process, which holds every replica. A
cell on ``chips`` > 1 runs one process a card (``portbench/ranks.py``),
each one replica of the process mesh (the port's replica mode over NCCL,
or gloo on the CPU); ``bundle.dp`` is then the number of cards. They run
the window for the same number of steps, agreed from the checked steps'
time, and the reference runs in this process once they have ended.
"""
from __future__ import annotations

import gc
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import Dict, List

TRACE_STEPS = 2


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _free(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def program_readings(prog, ring, specs, cfg, job, seed, dev, dtype, *,
                     payloads=()) -> Dict:
    """Drive the program's first ``checked_steps`` steps and read what the
    comparison needs, with dispatch 0's wire payloads of the buckets
    ``payloads``; then the rest of the warm-up. ``step_s`` is the
    quickest checked step after the first, by the host clock."""
    import torch

    from portbench import weights
    from portbench.reference.train import leaf_norms, optimizer
    opt = optimizer(job)
    checked = int(job["checked_steps"])
    warm = max(int(job["warmup_steps"]), checked)
    losses, held, change, got, times = [], None, None, {}, []
    for i in range(warm):
        t0 = time.perf_counter()
        loss = prog.step(ring[i % ring.shape[0]])
        if i < checked:
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        if i == 0:
            held = torch.stack(
                [leaf_norms(opt.first_gradient(x, job["optimizer"]))
                 for x in prog.leaves("opt", opt.HELD)], 1)
            got = {b: prog.payload(b) for b in payloads}
        if i == checked - 1:
            p0 = weights.make(specs, seed, dev, dtype)
            change = torch.stack(
                [leaf_norms(x.float() - x0.float().unsqueeze(0))
                 for x, x0 in zip(prog.leaves("params"), p0)], 1)
            del p0
    out = {"losses": losses, "held_norms": held.cpu().tolist(),
           "change_norms": change.cpu().tolist(),
           "step_s": min(times[1:] or times)}
    if payloads:
        out["payloads"] = {b: p for b, p in got.items() if p is not None}
    return out


def drive(cell, seed: int, seconds: float, trace: bool, *, device: str,
          root: Path, rank: int = 0, world: int = 1, port: int = 0) -> Dict:
    """One process's part of a run: set-up, the window or the traced
    steps, and its readings, as plain data."""
    import torch

    from portbench import run, traffic, weights
    from portbench.program import Program
    from portbench.reference.train import family, protocol
    bench, wl, cfg, job, limits = cell
    dev = torch.device(device)
    dist = group = None
    if world > 1:
        from repro_torch.launch.mesh import (init_replica_group,
                                             make_smoke_mesh)
        from repro_torch.train.sharding import make_distribution
        dist = make_distribution(make_smoke_mesh(world, 1), "replica")
        group = init_replica_group(
            dev.type, dist=dist, rank=rank, world_size=world,
            local_rank=rank, init_method=f"tcp://localhost:{port}")
        dev = group.device
    dtype = getattr(torch, cfg["param_dtype"])
    specs = family(cfg).leaf_specs(cfg)
    proto_seed = int(seed) % (1 << 32)
    replicas = traffic.replicas(job) // world
    marks = [("imports", time.time())]
    ring = traffic.make_ring(job, cfg["vocab"], seed, dev)
    if world > 1:
        ring = ring[:, rank:rank + 1].contiguous()
    leaves = weights.make(specs, seed, dev, dtype)
    _sync(dev)
    marks.append(("weights and tokens", time.time()))
    prog = Program(cfg, job, leaves, seed=proto_seed, device=dev,
                   group=group, dist=dist)
    del leaves
    _free(dev)
    marks.append(("program built", time.time()))
    nb = len(prog.bundle.layout.bucket_sizes) if prog.bundle.layout else 0
    payloads = protocol(job).checked_payloads(job, nb, proto_seed)
    got = program_readings(prog, ring, specs, cfg, job, seed, dev, dtype,
                           payloads=payloads)
    _sync(dev)
    marks.append(("checked and warm-up steps", time.time()))
    rec = {"rank": rank, "payloads": payloads, "readings": got,
           "setup_peak": _peak(dev)}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start = prog.steps
    if world > 1:
        # every rank runs the same steps: as many as the quickest checked
        # step fits into the window, the most any rank asks for
        n = torch.tensor([max(1, round(seconds / got["step_s"]))],
                         device=dev)
        torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MAX)
        n = int(n.item())
        torch.distributed.barrier()
    rec["window_start"] = time.time()
    if not trace:
        losses = []
        t0 = time.perf_counter()
        while True:
            losses.append(prog.step(ring[(start + len(losses))
                                         % ring.shape[0]]))
            if (len(losses) >= n if world > 1
                    else time.perf_counter() - t0 >= seconds):
                break
        _sync(dev)
        rec.update(steps=len(losses), elapsed=time.perf_counter() - t0,
                   failed=int((~torch.isfinite(torch.stack(losses))).sum()),
                   window_peak=_peak(dev))
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as T
        period = int(prog.bundle.protocol.period)
        k = period * max(1, -(-TRACE_STEPS // period))
        prog.step(ring[start % ring.shape[0]])
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        first = prog.steps
        _sync(dev)
        with profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                for j in range(k):
                    with record_function(T.STEP):
                        prog.step(ring[(first + j) % ring.shape[0]])
                _sync(dev)
        rec["window_peak"] = _peak(dev)
        tr = T.summarize(prof, k)
        del prof
        ctx = types.SimpleNamespace(
            cfg=cfg, job=job, rows=replicas, trace=tr, program=prog,
            steps=list(range(first, first + k)))
        metrics = {}
        for m in bench["per_layer"]:
            if run.applies(m, wl["name"]):
                v = run.reader(root, m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = v
        rec.update(steps=k + 1, failed=0, metrics=metrics, busy_s=tr.busy_s,
                   window_s=tr.window_s, breakdown=tr.breakdown())
    rec["marks"] = marks
    del prog
    _free(dev)
    if world > 1:
        from repro_torch.launch.mesh import destroy_replica_group
        destroy_replica_group()
    return rec


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def drive_ranks(cell, seed: int, seconds: float, trace: bool, *,
                device: str, root: Path, world: int) -> List[Dict]:
    """``drive`` in ``world`` processes (``portbench/ranks.py``), one a
    card; their records by rank. Waits for every one, and ends the others
    as soon as one fails."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="portbench-ranks-") as tmp:
        procs = []
        for r in range(world):
            spec = {"cell": cell, "seed": seed, "seconds": seconds,
                    "trace": trace, "device": device, "root": str(root),
                    "rank": r, "world": world, "port": port,
                    "out": str(Path(tmp) / f"rank{r}.pkl")}
            path = Path(tmp) / f"spec{r}.json"
            path.write_text(json.dumps(spec))
            procs.append(subprocess.Popen(
                [sys.executable, str(root / "portbench" / "ranks.py"),
                 str(path)], env=dict(os.environ, OMP_NUM_THREADS="1")))
        try:
            while any(p.poll() is None for p in procs) and not any(
                    p.poll() for p in procs):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank processes exited with {codes}")
        recs = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as fh:
                recs.append(pickle.load(fh))
    return recs


def _merge(recs: List[Dict]) -> Dict:
    """Each replica's readings in replica order (rank r holds replica r),
    the losses as every rank read them."""
    first = recs[0]["readings"]
    out = {"losses": first["losses"]}
    for key in ("held_norms", "change_norms"):
        out[key] = [row for x in recs for row in x["readings"][key]]
    if "payloads" in first:
        import torch
        out["payloads"] = {
            b: tuple(torch.cat([x["readings"]["payloads"][b][j]
                                for x in recs]) for j in (0, 1))
            for b in first["payloads"]
            if all(b in x["readings"]["payloads"] for x in recs)}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path, device: str, t_start: float, cell):
    """One run of a training cell; returns the result dict (the JSON line)
    and the standard error lines of its checks. ``t_start`` is the
    process's start by the host's wall clock."""
    import torch

    from portbench import compare, run, traffic, weights
    from portbench.reference.train import family, readings
    bench, wl, cfg, job, limits = cell
    chips = int(wl["chips"])
    if chips > 1:
        if traffic.replicas(job) != chips:
            raise ValueError(f"{workload}: one replica a card, so bundle.dp "
                             f"must be {chips}")
        recs = drive_ranks(cell, seed, seconds, trace, device=device,
                           root=root, world=chips)
    else:
        recs = [drive(cell, seed, seconds, trace, device=device, root=root)]
    lead = recs[0]
    got = _merge(recs)
    setup_s = lead["window_start"] - t_start
    peak = max(max(r["setup_peak"], r["window_peak"]) for r in recs)
    metrics = {}
    if not trace:
        elapsed = max(r["elapsed"] for r in recs)
        tokens = traffic.tokens_per_step(job) * lead["steps"]
        e2e = {"train_tokens_per_s": (tokens / elapsed, "tokens/s"),
               "train_peak_gb": (max(r["window_peak"] for r in recs) / 1e9,
                                 "GB"),
               "setup_s": (setup_s, "s")}
        for m in bench["end_to_end"]:
            if run.applies(m, workload) and m["name"] in e2e:
                v, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name in lead["metrics"]:
            vals = [r["metrics"][name] for r in recs if name in r["metrics"]]
            metrics[name] = {"value": sum(vals) / len(vals),
                             "unit": units[name]}
    dev = torch.device(device)
    checked = int(job["checked_steps"])
    t_ref = time.perf_counter()
    proto_seed = int(seed) % (1 << 32)
    dtype = getattr(torch, cfg["param_dtype"])
    leaves = weights.make(family(cfg).leaf_specs(cfg), seed, dev, dtype)
    batches = traffic.make_ring(job, cfg["vocab"], seed, dev)[:checked]
    ref = readings(cfg, job, leaves, batches, seed=proto_seed,
                   payloads=lead["payloads"])
    ref_s = time.perf_counter() - t_ref
    got["grad_norms"] = ref["grad_norms"]
    ok, checks = compare.judge(compare.gaps(got, ref), limits)
    failed = lead["failed"]
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        device_rec.update(
            busy_s=sum(r["busy_s"] for r in recs) / len(recs),
            window_s=sum(r["window_s"] for r in recs) / len(recs))
    result = {"correct": bool(ok and failed == 0),
              "attempted": lead["steps"], "failed": failed,
              "metrics": metrics, "device": device_rec}
    if trace:
        result["breakdown"] = lead["breakdown"]
    result["checks"] = checks
    last, lines = t_start, []
    for what, t in lead["marks"]:
        lines.append(f"setup {what}: {t - last:.3f} s")
        last = t
    lines.append(f"setup to the window: {setup_s:.3f} s")
    lines.append(f"reference {checked} steps: {ref_s:.3f} s")
    return result, lines + compare.check_lines(checks)
