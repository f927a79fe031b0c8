"""One process per replica rank: the port's engines over ``torch.distributed``
(gloo, CPU) against the port's oracle and its stacked runs.

Each test spawns one Python process per rank (``launch.mesh.
init_replica_group`` with ``init_method=file://`` under ``tmp_path``, so
concurrent test workers never share a port), gives every wait a timeout
and kills the ranks that outlive it, so a hung rank fails its test. Each
rank passes its ``ReplicaGroup`` to the engines it builds.

* p = 8 (mirroring tests/test_gossip_distributed.py): the per-leaf mix over
  period + 2 phases in static and dynamic mode, alpha 0.25, the packed mix,
  the per-leaf async ring (k 2, drops) and the replica mean against
  ``core.simulate`` bit for bit, and the ring shuffle.
* p = 4, 4 steps of the trainer against the same runs with the replicas
  stacked: packed fused sync ``gossip``, per-leaf sync ``gossip``, fused
  ``gossip_async`` (k 2, drop 0.2, int8 wire at subset 0.5, 7 buckets) and
  per-leaf ``agd``. Losses and params within rtol = atol = 2e-4 (each rank's
  forward runs a batch of one replica where the stacked one runs four).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import build_schedule  # noqa: E402
from repro_torch.core import simulate as S  # noqa: E402
from repro_torch.core.async_gossip import exchange_ok, init_inbox_ring  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 240
TOL = dict(rtol=2e-4, atol=2e-4)

_WORKER = r"""
import functools, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_replica_group, destroy_replica_group
rank, world, init, out, task = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
cfg = json.loads(sys.argv[6])
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.train.sharding import make_distribution
group = init_replica_group("cpu", dist=make_distribution(
    make_smoke_mesh(world, 1), "replica"), rank=rank, world_size=world,
    init_method=init, timeout_s=120)
res = {}


def tree_of(seed):
    rng = np.random.default_rng(seed)
    full = {"w1": rng.normal(size=(world, 5, 3)).astype(np.float32),
            "w2": rng.normal(size=(world, 130)).astype(np.float32),
            "w3": rng.normal(size=(world, 2, 7, 11)).astype(np.float32)}
    return {k: torch.from_numpy(v[rank:rank + 1].copy()) for k, v in full.items()}


def keep(tag, tree):
    for k, v in tree.items():
        res[f"{tag}/{k}"] = v.detach().numpy().copy()


if task == "mix":
    from repro_torch.core import (PackedParams, build_layout, build_schedule,
                                  make_packed_gossip_mix)
    from repro_torch.core.async_gossip import (init_inbox_ring,
                                               make_async_gossip_mix)
    from repro_torch.core.gossip import make_gossip_mix, replica_mean
    from repro_torch.core.protocols import make_ring_shuffle
    sched = build_schedule(world, num_rotations=2, seed=3)
    for mode in ("static", "dynamic"):
        x = tree_of(0)
        mix = make_gossip_mix(sched, mode=mode, group=group)
        for t in range(sched.period + 2):
            mix(x, t if mode == "static" else torch.tensor(t))
            keep(f"{mode}/{t}", x)
    x = tree_of(1)
    make_gossip_mix(sched, alpha=0.25, group=group)(x, 0)
    keep("alpha", x)
    x = tree_of(2)
    layout = build_layout(x, skip_leading=1, target_bucket_bytes=1024)
    packed = PackedParams.pack(x, layout)
    pmix = make_packed_gossip_mix(sched, layout, group=group)
    for t in range(sched.period):
        pmix(packed, t)
    keep("packed", packed.unpack())
    x = tree_of(3)
    ring = init_inbox_ring(x, 2, 1)
    amix = make_async_gossip_mix(sched, staleness=2, drop_rate=0.3,
                                 drop_seed=5, group=group)
    for t in range(sched.period + 2):
        x, ring = amix(x, ring, t)
        keep(f"async/{t}", x)
    keep("async_slot", ring["slots"][-1])
    res["async_valid"] = ring["valid"]
    x = tree_of(4)
    keep("mean", {k: replica_mean(v, group) for k, v in x.items()})
    batch = torch.full((1, 3, 2), float(rank))
    res["shuffle"] = make_ring_shuffle(world, group)({"t": batch})["t"].numpy()
else:
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models import lm_init, reduced
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import Trainer, init_train_state, make_train_step_bundle
    import repro_torch.train.step as step_mod
    import dataclasses
    step_mod.build_layout = functools.partial(
        step_mod.build_layout, target_bucket_bytes=cfg["bucket_bytes"])
    mcfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                       d_model=cfg["d"]),
                               param_dtype="float32", compute_dtype="float32")
    for name, kw in cfg["cases"].items():
        opt = sgd(step_decay(0.3, 0.1, 2), momentum=0.9)
        bundle = make_train_step_bundle(mcfg, opt, dp=world, device="cpu",
                                        group=group, **kw)
        state = init_train_state(mcfg, opt, dp=world,
                                 packed=kw.get("gossip_packed", False),
                                 layout=bundle.layout, device="cpu",
                                 params=lm_init(mcfg, seed=0, device="cpu"),
                                 inbox=bundle.protocol.staleness,
                                 wire=bundle.wire, group=bundle.group)
        ds = ShardedTokenDataset(mcfg.vocab, cfg["seq"], n_shards=world,
                                 batch_per_shard=2)
        tr = Trainer(bundle, state, ds, log_every=0)
        hist = tr.run(cfg["steps"])
        res[f"{name}/loss"] = np.asarray([h["loss"] for h in hist])
        params = tr.state["params"]
        params = params.unpack() if kw.get("gossip_packed") else params
        from repro_torch.tree import tree_flatten
        for i, v in enumerate(tree_flatten(params)[0]):
            res[f"{name}/p{i}"] = v.detach().numpy().copy()
        if "inbox" in tr.state:
            res[f"{name}/valid"] = tr.state["inbox"]["valid"]
np.savez(out, **res)
destroy_replica_group()
print("RANK_OK", rank)
"""


def _spawn(tmp_path, world: int, task: str, cfg=None):
    """Run the worker on ``world`` ranks; every rank's arrays, by rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init,
         str(tmp_path / f"rank{r}.npz"), task, json.dumps(cfg or {})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log[-3000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _tree(seed, world):
    rng = np.random.default_rng(seed)
    full = {"w1": rng.normal(size=(world, 5, 3)).astype(np.float32),
            "w2": rng.normal(size=(world, 130)).astype(np.float32),
            "w3": rng.normal(size=(world, 2, 7, 11)).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in full.items()}


def _rows(ranks, tag, keys=("w1", "w2", "w3")):
    return {k: np.concatenate([r[f"{tag}/{k}"] for r in ranks]) for k in keys}


def _equal(ranks, tag, want):
    got = _rows(ranks, tag)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].view(np.int32),
                                      v.numpy().view(np.int32), err_msg=tag)


def test_p8_mix_shuffle_and_mean_match_the_oracle(tmp_path):
    p = 8
    ranks = _spawn(tmp_path, p, "mix")
    sched = build_schedule(p, num_rotations=2, seed=3)
    for mode in ("static", "dynamic"):
        want = _tree(0, p)
        for t in range(sched.period + 2):
            want = S.gossip_mix_sim(want, sched.recv_from(t))
            _equal(ranks, f"{mode}/{t}", want)
    x = _tree(1, p)
    want, _ = S.gossip_mix_sim_delayed(
        x, {k: v[sched.recv_from(0)] for k, v in x.items()},
        sched.recv_from(0), 0.25)
    _equal(ranks, "alpha", want)
    want = _tree(2, p)
    for t in range(sched.period):
        want = S.gossip_mix_sim(want, sched.recv_from(t))
    _equal(ranks, "packed", want)
    want = _tree(3, p)
    ring = init_inbox_ring(want, 2, p)
    for t in range(sched.period + 2):
        ok = exchange_ok(ring["t"], np.arange(p), 5, 0.3)
        want, ring = S.gossip_mix_sim_delayed_k(want, ring,
                                                sched.recv_from(t), 0.5, ok)
        _equal(ranks, f"async/{t}", want)
    _equal(ranks, "async_slot", ring["slots"][-1])
    np.testing.assert_array_equal(
        np.concatenate([r["async_valid"] for r in ranks]), ring["valid"])
    assert not ring["valid"].all()
    _equal(ranks, "mean", S.allreduce_mean_sim(_tree(4, p)))
    shuffled = np.concatenate([r["shuffle"] for r in ranks])
    np.testing.assert_array_equal(
        shuffled, np.roll(np.arange(p, dtype=np.float32)[:, None, None]
                          * np.ones((1, 3, 2), np.float32), 1, axis=0))


CASES = {
    "packed_fused_gossip": dict(gossip_packed=True),
    "leaf_gossip": dict(),
    "async_int8": dict(gossip_packed=True, protocol="gossip_async",
                       staleness=2, drop_rate=0.2, wire_dtype="int8",
                       gossip_subset=0.5),
    "leaf_agd": dict(protocol="agd"),
}
TRAIN = dict(d=32, seq=8, steps=4, bucket_bytes=24 << 10)


def _stacked(name, kw, dp):
    import dataclasses
    import functools

    import repro_torch.train.step as step_mod
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models import lm_init, reduced
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    from repro_torch.tree import tree_flatten
    orig = step_mod.build_layout
    step_mod.build_layout = functools.partial(
        orig, target_bucket_bytes=TRAIN["bucket_bytes"])
    try:
        cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                          d_model=TRAIN["d"]),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        opt = sgd(step_decay(0.3, 0.1, 2), momentum=0.9)
        bundle = make_train_step_bundle(cfg, opt, dp=dp, device="cpu", **kw)
        if kw.get("gossip_subset"):   # a subset with buckets to pick from
            assert bundle.layout.num_buckets == 7
        state = init_train_state(cfg, opt, dp=dp,
                                 packed=kw.get("gossip_packed", False),
                                 layout=bundle.layout, device="cpu",
                                 params=lm_init(cfg, seed=0, device="cpu"),
                                 inbox=bundle.protocol.staleness,
                                 wire=bundle.wire)
        ds = ShardedTokenDataset(cfg.vocab, TRAIN["seq"], n_shards=dp,
                                 batch_per_shard=2)
        tr = Trainer(bundle, state, ds, log_every=0)
        hist = tr.run(TRAIN["steps"])
    finally:
        step_mod.build_layout = orig
    params = tr.state["params"]
    params = params.unpack() if kw.get("gossip_packed") else params
    return ([h["loss"] for h in hist],
            [v.detach().numpy() for v in tree_flatten(params)[0]],
            tr.state.get("inbox", {}).get("valid"))


def test_p4_trainers_match_the_stacked_runs(tmp_path):
    p = 4
    ranks = _spawn(tmp_path, p, "train", dict(TRAIN, cases=CASES))
    for name, kw in CASES.items():
        losses, params, valid = _stacked(name, kw, p)
        for r in ranks:   # every rank reports the replica mean of the losses
            np.testing.assert_allclose(r[f"{name}/loss"], losses, **TOL,
                                       err_msg=name)
        for i, want in enumerate(params):
            got = np.concatenate([r[f"{name}/p{i}"] for r in ranks])
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        if valid is not None:
            np.testing.assert_array_equal(
                np.concatenate([r[f"{name}/valid"] for r in ranks]), valid)
            assert not valid.all()


def test_nccl_world_larger_than_the_cards_raises(monkeypatch):
    """NCCL takes one card per rank: a world larger than the card count
    raises before any rendezvous, and is never moved onto gloo."""
    from repro_torch.launch import mesh
    from repro_torch.train.sharding import make_distribution
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    dist = make_distribution(mesh.make_smoke_mesh(2, 1), "replica")
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh.init_replica_group("cuda", dist=dist, rank=0, world_size=2,
                                init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launcher_runs_one_process_per_rank(capsys):
    """``WORLD_SIZE`` > 1 (as torchrun sets it): every rank trains its own
    replica over gloo and only rank 0 prints the final JSON line, whose
    losses are the stacked launcher's."""
    from repro_torch.launch.train import main
    argv = ["--smoke", "--smoke-mesh", "1,2,1", "--steps", "3", "--d-model",
            "32", "--seq-len", "8", "--global-batch", "4", "--log-every",
            "0", "--device", "cpu"]
    main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0].strip() == ""
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key
    assert got["dp"] == 2 and got["packed"] is False
