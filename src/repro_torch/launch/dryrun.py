"""Dry run on PyTorch's ``meta`` device: trace every (arch x input shape x
mesh) once and reckon its H100 roofline terms. Nothing is allocated and no
card is needed.

Port of ``repro/launch/dryrun.py`` (``run_one``, ``main``). The reference
lowers and compiles each program against 512 placeholder devices and reads
XLA's memory and cost analyses and the HLO's collectives. The port runs the
same program eagerly on ``meta`` under ``launch/counting.py``'s
``CountingMode``: the FLOPs, the op bytes (each aten op reads its inputs
from HBM and writes its outputs there) and the live-storage peak of the
eager step, divided by the H100's datasheet rates (``launch/roofline.py``).

The traced program is what the reference's dry run builds:

* train: ``make_train_step_bundle(cfg, sgd(0.1, momentum=0.9), ...)`` with
  the reference's defaults (the per-leaf engine, ``gossip_packed=False``;
  ``ssm_scan_chunked_torch(chunk=256)`` under ``--ssm-scan chunked``);
* decode and prefill: ``serve/step.py: make_decode_step`` /
  ``make_prefill_step`` (with image or audio where the config has one).

``trace_train`` and ``trace_serve`` run one step under the counting mode on
any device: ``run_one`` calls them on ``meta``, and ``chip_smoke.py``'s
``[dryrun_check]`` on ``cuda``, where the counts must come out the same and
the peak and time are measured.

Per chip, a train record traces the fewest replicas that run the exchange
(2, stacked; 1 when the plan has dp 1) at the plan's local batch
``global_batch / dp``, divides by the traced replicas for one replica, then
by the in-replica shard count ``chips / dp`` for one chip. A serve record
traces the global batch and divides by ``chips``. That even split inside a
replica is a model until in-pod FSDP is ported (ROADMAP A.12b), as are the
exchange's bytes (``roofline.exchange_bytes``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single --out experiments/dryrun

Each combination writes an incremental JSON record
``{tag}__{mesh}__{arch}__{shape}.json``, so an interrupted sweep resumes
(``--force`` retraces).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.configs import SHAPES, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.counting import CountingMode, Counts
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import H100, exchange_bytes, roofline_terms
from repro_torch.launch.specs import (active_param_count, meta_params,
                                      param_count, resolve_config,
                                      serve_input_specs, train_input_specs)
from repro_torch.models import lm_cache_init, lm_init, lm_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import ssm_scan_chunked_torch
from repro_torch.optim import sgd
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.train import (Distribution, init_train_state,
                               make_distribution, make_train_step_bundle)
from repro_torch.tree import tree_flatten

__all__ = ["Trace", "trace_train", "trace_serve", "run_one", "main"]


@dataclasses.dataclass
class Trace:
    """One counted step: its ``counts``, the wall seconds it took
    (``seconds``, after a device synchronize), the bytes of the batch or
    serve inputs it took (``input_bytes``, in ``launch/specs.py``'s shapes),
    and ``rerun()``, which runs one more step of the same program,
    uncounted, and returns its outputs."""

    counts: Counts
    seconds: float
    input_bytes: int
    rerun: Callable[[], Any]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nbytes(inputs: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in inputs.values())


def _counted(dev: torch.device, live, input_bytes: int,
             step: Callable[[], Any]) -> Trace:
    _sync(dev)
    t0 = time.perf_counter()
    with CountingMode(live, device=dev.type) as mode:
        step()
    _sync(dev)
    return Trace(mode.counts, time.perf_counter() - t0, input_bytes, step)


def _params(cfg: ModelConfig, dev: torch.device, seed: int):
    """Random params on a real device; shapes alone on meta (a generator
    cannot live there)."""
    return (meta_params(cfg) if dev.type == "meta"
            else lm_init(cfg, seed=seed, device=dev))


def _draw(cfg: ModelConfig, spec: Dict[str, torch.Tensor],
          dev: torch.device, seed: int) -> Dict[str, torch.Tensor]:
    """The spec tensors themselves on meta; on a real device, tensors of
    their shapes and dtypes drawn from ``seed`` on the host: token ids below
    the vocab, embeddings and frames at scale 0.02."""
    if dev.type == "meta":
        return dict(spec)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, s in spec.items():
        if not s.dtype.is_floating_point:
            out[name] = torch.randint(0, cfg.vocab, s.shape, generator=gen,
                                      dtype=s.dtype).to(dev)
        else:
            out[name] = (torch.randn(s.shape, generator=gen) * 0.02).to(
                dev, s.dtype)
    return out


def trace_train(cfg: ModelConfig, dist_or_dp: Union[Distribution, int],
                seq_len: int, local_batch: int, device="meta", *,
                protocol: str = "gossip", topology: str = "dissemination",
                num_rotations: int = 2, remat: bool = True,
                remat_policy: Optional[str] = None, ssm_scan: str = "assoc",
                seed: int = 0) -> Trace:
    """One train step of ``cfg`` counted on ``device``: the replicas of
    ``dist_or_dp`` (a plan, or a count of flat stacked replicas) at
    ``local_batch`` sequences of ``seq_len`` positions each, sgd(0.1,
    momentum 0.9), the per-leaf engine, phase 0. The batch has
    ``specs.train_input_specs``' shapes."""
    dev = resolve_device(device)
    kw = ({"dist": dist_or_dp} if isinstance(dist_or_dp, Distribution)
          else {"dp": int(dist_or_dp)})
    rows = kw["dist"].dp if "dist" in kw else kw["dp"]
    opt = sgd(0.1, momentum=0.9)
    ssm_impl = (functools.partial(ssm_scan_chunked_torch, chunk=256)
                if ssm_scan == "chunked" else None)
    bundle = make_train_step_bundle(
        cfg, opt, protocol=protocol, topology=topology,
        num_rotations=num_rotations, remat=remat, remat_policy=remat_policy,
        ssm_scan_impl=ssm_impl, seed=seed, device=dev, **kw)
    state = init_train_state(cfg, opt, params=_params(cfg, dev, seed),
                             device=dev, inbox=bundle.protocol.staleness,
                             wire=bundle.wire, **kw)
    spec = train_input_specs(cfg, dist_or_dp, seq_len, rows * local_batch,
                             opt)[2]
    box = {"state": state, "batch": _draw(cfg, spec, dev, seed), "phase": 0}
    del state

    def step():
        box["state"], box["batch"], metrics = bundle.step(
            box["state"], box["batch"], box["phase"])
        box["phase"] += 1
        return metrics

    return _counted(dev, (box["state"], box["batch"]), _nbytes(spec), step)


def trace_serve(cfg: ModelConfig, kind: str, seq_len: int, batch: int,
                device="meta", *, seed: int = 0,
                dist: Optional[Distribution] = None) -> Trace:
    """One serve step of ``cfg`` counted on ``device``: ``kind`` "decode"
    (one token for each of ``batch`` sequences against a ``seq_len``
    cache, at position ``seq_len - 1``) or "prefill" (``batch`` prompts of
    ``seq_len`` positions, image or audio included). The inputs have
    ``specs.serve_input_specs``' shapes; on a real device the params and
    cache come from ``lm_init`` and ``lm_cache_init``. ``dist`` is the
    plan whose specs the bundle carries (default: the production mesh's)."""
    if kind not in ("decode", "prefill"):
        raise ValueError(f"unknown serve kind {kind!r}")
    dev = resolve_device(device)
    dist = dist or make_distribution(make_production_mesh(), cfg.dist_mode)
    spec = serve_input_specs(cfg, dist, seq_len, batch, kind)
    if dev.type == "meta":
        params, cache = spec["params"], spec["cache"]
    else:
        params = lm_init(cfg, seed=seed, device=dev)
        cache = lm_cache_init(cfg, batch, seq_len, device=dev)
    common = dict(param_shapes=params, param_axes=spec["params_axes"],
                  cache_shapes=cache)
    if kind == "decode":
        bundle = make_decode_step(cfg, dist, **common)
        ins = _draw(cfg, {"token": spec["token"]}, dev, seed)
        ins["pos"] = torch.full(spec["pos"].shape, seq_len - 1,
                                dtype=spec["pos"].dtype, device=dev)
        names = ("token", "pos")
    else:
        bundle = make_prefill_step(cfg, dist, with_image=cfg.vision is not None,
                                   with_audio=cfg.encoder is not None,
                                   **common)
        names = tuple(k for k in ("tokens", "image_embeds", "audio_frames")
                      if k in spec)
        ins = _draw(cfg, {k: spec[k] for k in names}, dev, seed)
    args = (params, cache) + tuple(ins[k] for k in names)
    del params, cache, spec

    def step():
        return bundle.step_fn(*args)

    return _counted(dev, args, _nbytes(ins), step)


def _per_chip(c: Counts, div: int) -> Dict[str, Any]:
    return {"flops": c.flops / div, "op_bytes": c.op_bytes / div,
            "entry": c.entry_bytes // div, "temp": c.temp_bytes // div,
            "peak": c.peak_bytes // div}


def _replica_bytes(cfg: ModelConfig) -> int:
    return int(sum(int(s.dtype.itemsize) * int(torch.Size(s.shape).numel())
                   for s in tree_flatten(lm_specs(cfg))[0]))


def _batch_bytes_per_chip(dist: Distribution, replica_bytes: float
                          ) -> float:
    """One chip's share of its replica's batch (the ring shuffle's
    payload): the replica's batch over the batch axes inside the
    replica."""
    shape = dist.mesh.shape
    batch_shards = 1
    for a in dist.batch_axes:
        batch_shards *= shape[a]
    return replica_bytes / max(batch_shards // max(dist.dp, 1), 1)


def run_one(arch: str, shape: str, *, multi_pod: bool,
            protocol: str = "gossip", num_rotations: int = 2,
            remat: bool = True, remat_policy=None, ssm_scan: str = "assoc",
            dist_mode: Optional[str] = None, topology: str = "dissemination",
            verbose: bool = True) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) on ``meta`` and return its record, in
    the reference's keys. ``hlo_flops_total`` keeps its name so that
    ``launch/report.py`` reads both sweeps: here it is the traced
    aten-level FLOPs per chip times the chips."""
    seq_len, global_batch, kind = SHAPES[shape]
    cfg, notes = resolve_config(arch, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = 1
    for n in mesh.axis_sizes:
        chips *= int(n)
    dist = make_distribution(mesh, dist_mode or cfg.dist_mode)
    dp = max(dist.dp, 1)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "chips": chips, "protocol": protocol if kind == "train" else None,
        "dist_mode": dist.mode, "dp": dist.dp, "notes": notes,
        "seq_len": seq_len, "global_batch": global_batch,
        "hardware": H100.name,
    }
    specs = lm_specs(cfg)
    rec["params"] = param_count(specs)
    rec["active_params"] = active_param_count(cfg, specs)
    ssm = ssm_scan if cfg.has_ssm() else "assoc"
    if ssm == "chunked":
        rec["ssm_scan"] = "chunked256"
    if kind == "train":
        local_b = global_batch // dp
        rows = min(dp, 2)
        shards = chips // dp
        tr = trace_train(cfg, rows, seq_len, local_b, "meta",
                         protocol=protocol, topology=topology,
                         num_rotations=num_rotations, remat=remat,
                         remat_policy=remat_policy, ssm_scan=ssm)
        div = rows * shards
        notes["per_chip"] = (f"traced {rows} replica(s) of {local_b} x "
                             f"{seq_len}; / {rows} replicas / {shards} "
                             "in-replica shards (an even split: a model "
                             "until ROADMAP A.12b)")
        rb = _replica_bytes(cfg)
        coll = exchange_bytes(protocol, dp, shards, rb, rb,
                              _batch_bytes_per_chip(dist,
                                                    tr.input_bytes / rows))
        rec["tokens_per_step"] = global_batch * seq_len
        model_flops = 6.0 * rec["active_params"] * rec["tokens_per_step"]
    else:
        tr = trace_serve(cfg, kind, seq_len, global_batch, "meta", dist=dist)
        div = chips
        notes["per_chip"] = (f"traced the global batch {global_batch}; / "
                             f"{chips} chips (an even split: a model until "
                             "ROADMAP A.12b)")
        coll = exchange_bytes(None, dp, chips, 0, 0, 0)
        rec["tokens_per_step"] = (global_batch if kind == "decode"
                                  else global_batch * seq_len)
        model_flops = 2.0 * rec["active_params"] * rec["tokens_per_step"]
    rec["trace_s"] = round(tr.seconds, 2)
    c = _per_chip(tr.counts, div)
    rec["memory_analysis"] = {"argument_size_in_bytes": c["entry"],
                              "temp_size_in_bytes": c["temp"],
                              "peak_memory_in_bytes": c["peak"]}
    rec["cost_analysis"] = {"flops": c["flops"],
                            "bytes accessed": c["op_bytes"]}
    rec["collectives"] = coll
    rec["roofline"] = roofline_terms(c["flops"], c["op_bytes"],
                                     coll["wire_bytes"])
    rec["n_ops"] = tr.counts.n_ops
    rec["top_ops"] = tr.counts.as_dict(16)["top_ops"]
    rec["model_flops"] = model_flops
    rec["hlo_flops_total"] = c["flops"] * chips
    rec["useful_flop_ratio"] = (model_flops / rec["hlo_flops_total"]
                                if c["flops"] else None)
    if verbose:
        print(f"  memory: {rec['memory_analysis']}")
        print(f"  cost: {rec['cost_analysis']}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--protocol", default="gossip")
    ap.add_argument("--num-rotations", type=int, default=2)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ssm-scan", default="assoc",
                    choices=["assoc", "chunked"])
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--dist-mode", default=None,
                    choices=[None, "replica", "fsdp", "pure_dp"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for multi in meshes:
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape in shapes:
                path = os.path.join(
                    args.out, f"{args.tag}__{mesh_name}__{arch}__{shape}.json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {path}")
                    continue
                print(f"[dryrun] {mesh_name} {arch} {shape} "
                      f"proto={args.protocol}", flush=True)
                try:
                    rec = run_one(arch, shape, multi_pod=multi,
                                  protocol=args.protocol,
                                  num_rotations=args.num_rotations,
                                  remat=not args.no_remat,
                                  remat_policy=args.remat_policy,
                                  ssm_scan=args.ssm_scan,
                                  dist_mode=args.dist_mode, verbose=False)
                    rec["tag"] = args.tag
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    r = rec["roofline"]
                    print(f"  ok: trace {rec['trace_s']}s "
                          f"ops={rec['n_ops']} dominant={r['dominant']} "
                          f"compute={r['compute_s']:.2e}s "
                          f"memory={r['memory_s']:.2e}s "
                          f"collective={r['collective_s']:.2e}s", flush=True)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((mesh_name, arch, shape, repr(e)))
    print(f"sweep seconds: {time.perf_counter() - t_all:.1f}")
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
