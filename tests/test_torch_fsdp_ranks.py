"""In-pod FSDP with one process per mesh position: the port's packed engines
over gloo ranks (CPU) against the reference and against the port's own
stacked shard-local runs.

Every world spawns one Python process per mesh position
(``launch.mesh.init_replica_group(dist=...)`` with ``init_method=file://``
under ``tmp_path``), gives every wait a timeout and kills the ranks that
outlive it, as ``tests/test_torch_dist.py`` does. The worlds:

* (2, 2, 2) fsdp, 8 ranks: the packed fused and unfused sgd runs of the
  reference's ``_E2E_SCRIPT`` (``tests/test_hier_packed.py``), 6 steps
  from the reference's own weights, and each rank's mesh position;
* (2, 2, 1) fsdp, 4 ranks (dp 2 over pods, the replica's rows split over
  ``data``): one int8 exchange's codes and scales, the agd and every_logp
  replica means, gossip_async int8 at subset 0.5, fused adamw, unfused
  lars (with its trust ratios), and checkpoints: save at step 3 and resume
  to 6, a stacked run's file restored;
* (1, 2, 2) replica mode, 4 ranks (dp 2, the model axis sharding): the
  same exchange and the async int8 run;
* (1, 4, 1), 4 whole-replica ranks: checkpoints of the fp32 async ring.

One subprocess runs the reference (8 forced host devices): the mesh
positions of six (mesh, mode) plans from ``shard_map``'s axis indices,
and the two ``_E2E_SCRIPT`` runs with their initial weights. Trajectories
are held within rtol = atol = 2e-4; exchanges, replica means and
checkpoints bit for bit.
"""
import contextlib
import dataclasses
import functools
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 240
TOL = dict(rtol=2e-4, atol=2e-4)
MESHES = [((1, 2, 2), "fsdp"), ((1, 2, 2), "replica"), ((2, 2, 1), "fsdp"),
          ((2, 2, 1), "replica"), ((2, 2, 2), "fsdp"),
          ((2, 2, 2), "replica")]
SMALL = dict(d=32, seq=8, per_shard=4, bucket_bytes=24 << 10)
ASYNC_INT8 = dict(protocol="gossip_async", staleness=2, drop_rate=0.2,
                  wire_dtype="int8", gossip_subset=0.5)
RANK_CASES = {   # 4 steps each, on (2, 2, 1) fsdp
    "async_int8": dict(opt="sgd", kw=dict(gossip_packed=True, **ASYNC_INT8)),
    "adamw_fused": dict(opt="adamw", kw=dict(gossip_packed=True)),
    "lars_unfused": dict(opt="lars", kw=dict(gossip_packed=True)),
}
CKPT_CASES = {
    "fsdp_221": ((2, 2, 1), "fsdp", dict(gossip_packed=True, **ASYNC_INT8)),
    "replica_141": ((1, 4, 1), "replica",
                    dict(gossip_packed=True, protocol="gossip_async",
                         staleness=2, fused_update=False)),
}

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import get_config
from repro.core.gossip import _axis_rank
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

out = {"mesh": {}}
for pod, data, model in ((1, 2, 2), (2, 2, 1), (2, 2, 2)):
    if pod > 1:
        shape, names = (pod, data, model), ("pod", "data", "model")
    else:
        shape, names = (data, model), ("data", "model")
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    for mode in ("fsdp", "replica"):
        d = make_distribution(mesh, mode)
        batch = tuple(a for a in d.shard_axes if a in d.batch_axes)

        def f(x, d=d, batch=batch, mesh=mesh):
            v = jnp.stack([_axis_rank(mesh, tuple(d.dp_axes)),
                           _axis_rank(mesh, tuple(d.shard_axes)),
                           _axis_rank(mesh, batch)])
            return v.reshape((1,) * len(names) + (3,))

        pos = jax.shard_map(f, mesh=mesh, in_specs=P(*names),
                            out_specs=P(*names, None))(jnp.zeros(shape))
        out["mesh"][f"{pod},{data},{model}/{mode}"] = (
            np.asarray(pos).reshape(n, 3), d.dp, tuple(d.dp_axes),
            tuple(d.shard_axes))

cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                          param_dtype="float32", compute_dtype="float32",
                          dist_mode="fsdp")
dist = make_distribution(make_smoke_mesh(2, 2, pod=2), "fsdp")
opt = sgd(0.3, momentum=0.9)
ss, sa, bs = train_input_specs(cfg, dist, 24, 4, opt)
out["init"] = jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])
for name, fused in (("packed_fused", True), ("packed_unfused", False)):
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol="gossip", remat=False, gossip_packed=True,
        fused_update=fused)
    assert bundle.layout.num_shards == 4 and bundle.fused == fused
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                packed=True, layout=bundle.layout)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=24, n_shards=2,
                             batch_per_shard=2, seed=0)
    out[name] = [h["loss"] for h in
                 Trainer(bundle, state, ds, log_every=0).run(6)]
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
print("REF_OK")
"""

_WORKER = r"""
import dataclasses, functools, json, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
rank, world, init, out, spec = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4],
                                json.loads(sys.argv[5]))
sys.path.insert(0, spec["tests"])
import test_torch_fsdp_ranks as T
from repro_torch.launch.mesh import destroy_replica_group, init_replica_group
dist = T.plan(spec["mesh"], spec["mode"])
group = init_replica_group("cpu", dist=dist, rank=rank, world_size=world,
                           init_method=init, timeout_s=120)
members = {k: np.array(torch.distributed.get_process_group_ranks(g)
                       if g is not None else [rank])
           for k, g in (("inner", group.inner), ("batch", group.batch))}
res = {"position": np.array([group.replica, group.shard, group.batch_index]),
       "cross": np.array(group.cross_ranks), **members}
for task in spec["tasks"]:
    res.update(getattr(T, "task_" + task)(dist, group, spec))
with open(out, "wb") as fh:
    pickle.dump(res, fh)
destroy_replica_group()
print("RANK_OK", rank)
"""


def plan(shape, mode):
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import make_distribution
    pod, data, model = shape
    return make_distribution(make_smoke_mesh(data, model, pod=pod), mode)


def _cfg(d, dist_mode="fsdp"):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=d),
                               param_dtype="float32",
                               compute_dtype="float32", dist_mode=dist_mode)


def _opt(name):
    from repro_torch.optim import adamw, lars, sgd, step_decay
    lr = step_decay(0.3, 0.1, 2)
    return {"sgd": lambda: sgd(lr, momentum=0.9),
            "adamw": lambda: adamw(1e-3, weight_decay=0.02),
            "lars": lambda: lars(lr, weight_decay=1e-4)}[name]()


@contextlib.contextmanager
def _small_layouts():
    """Smaller buckets in the step module while a bundle is built, so that
    subsets pick among several (as ``tests/test_torch_dist.py`` does)."""
    import repro_torch.train.step as step_mod
    orig = step_mod.build_layout
    step_mod.build_layout = functools.partial(
        orig, target_bucket_bytes=SMALL["bucket_bytes"])
    try:
        yield
    finally:
        step_mod.build_layout = orig


def _trainer(dist, opt_name, kw, group=None, params=None):
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.models import lm_init
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    cfg = _cfg(SMALL["d"], dist.mode)
    opt = _opt(opt_name)
    with _small_layouts():
        bundle = make_train_step_bundle(cfg, opt, dist=dist, device="cpu",
                                        group=group, remat=False, **kw)
    state = init_train_state(
        cfg, opt, dist=dist, packed=True, layout=bundle.layout,
        device="cpu", params=params or lm_init(cfg, seed=0, device="cpu"),
        inbox=bundle.protocol.staleness, wire=bundle.wire, group=group)
    ds = ShardedTokenDataset(cfg.vocab, SMALL["seq"], n_shards=dist.dp,
                             batch_per_shard=SMALL["per_shard"])
    return Trainer(bundle, state, ds, log_every=0)


def _leaves(params):
    from repro_torch.tree import tree_flatten
    with torch.no_grad():
        return [x.detach().numpy().copy()
                for x in tree_flatten(params.unpack())[0]]


def _stretches(params):
    return [b.detach().numpy().copy() for b in params.buckets]


def _random_buckets(layout, dp, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((dp, n)).astype(np.float32))
            for n in layout.bucket_sizes]


def _chunk(x, group_or_pos, stride):
    q, s = group_or_pos
    return x[q:q + 1, s * stride:(s + 1) * stride]


# ------------------------------------------------------------- rank tasks

def task_e2e(dist, group, spec):
    """The reference's _E2E_SCRIPT runs on the ranks, from its weights."""
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    with open(spec["init"], "rb") as fh:
        init = pickle.load(fh)
    cfg = _cfg(64)
    out = {}
    for name, fused in (("packed_fused", True), ("packed_unfused", False)):
        opt = sgd(0.3, momentum=0.9)
        bundle = make_train_step_bundle(cfg, opt, dist=dist,
                                        gossip_packed=True,
                                        fused_update=fused, remat=False,
                                        device="cpu", group=group)
        assert bundle.layout.num_shards == 4 and bundle.fused == fused
        state = init_train_state(cfg, opt, dist=dist, packed=True,
                                 layout=bundle.layout, device="cpu",
                                 params=params_from_numpy(init,
                                                          device="cpu"),
                                 group=group)
        assert all(tuple(b.shape) == (1, n) for b, n in
                   zip(state["params"].buckets, bundle.layout.strides))
        # a ready stacked PackedParams: the rank keeps its row and chunk
        ready = init_train_state(
            cfg, opt, dist=dist, packed=True, layout=bundle.layout,
            device="cpu", group=group,
            params=params_from_numpy(init, layout=bundle.layout,
                                     lead=(dist.dp,), device="cpu"))
        out[f"{name}/ready_equal"] = all(
            torch.equal(a, b) for a, b in zip(ready["params"].buckets,
                                              state["params"].buckets))
        ds = ShardedTokenDataset(cfg.vocab, 24, n_shards=2,
                                 batch_per_shard=2, seed=0)
        hist = Trainer(bundle, state, ds, log_every=0).run(6)
        out[f"{name}/loss"] = np.array([h["loss"] for h in hist])
    return out


def _wire_inputs(dist):
    from repro_torch.core import build_schedule
    from repro_torch.train.step import _build_packed_layout
    with _small_layouts():
        layout = _build_packed_layout(dist, _cfg(SMALL["d"], dist.mode))
    return layout, build_schedule(dist.dp, num_rotations=2, seed=0)


def task_wire(dist, group, spec):
    """One int8 exchange of every bucket's stretch at phase 3."""
    from repro_torch.core.gossip import encode_bucket, exchange
    from repro_torch.kernels.quantize import WireFormat
    layout, sched = _wire_inputs(dist)
    wire = WireFormat("int8", seed=5)
    out = {}
    for i, full in enumerate(_random_buckets(layout, dist.dp, 7)):
        x = _chunk(full, (group.replica, group.shard), layout.strides[i])
        got = exchange(encode_bucket(wire, x.clone(), 3, i, group),
                       sched.recv_from(3), group)
        out[f"wire/{i}/q"] = got["q"].numpy()
        out[f"wire/{i}/s"] = got["s"].numpy()
    return out


def task_means(dist, group, spec):
    """agd's gradient mean and every_logp's parameter mean of stretches."""
    from repro_torch.core import PackedParams, make_protocol
    layout, _ = _wire_inputs(dist)
    out = {}
    for name in ("agd", "every_logp"):
        proto = make_protocol(name, dist.dp, group=group)
        full = _random_buckets(layout, dist.dp, 11)
        x = PackedParams([_chunk(b, (group.replica, group.shard), n).clone()
                          for b, n in zip(full, layout.strides)], layout,
                         group)
        if name == "agd":
            y = proto.comm_grads(x, 0)
        else:
            y = proto.comm_params(x, proto.schedule.substeps - 1)
        for i, b in enumerate(y.buckets):
            out[f"mean/{name}/{i}"] = b.numpy().copy()
    return out


def _trust_recorder():
    import repro_torch.optim.optimizers as O
    real, seen = O._trust, []

    def rec(wn, gn, **kw):
        t = real(wn, gn, **kw)
        seen.append(float(t))
        return t
    return O, real, rec, seen


def task_train(dist, group, spec):
    out = {}
    for name in spec["cases"]:
        case = RANK_CASES[name]
        O, real, rec, seen = _trust_recorder()
        O._trust = rec
        try:
            tr = _trainer(dist, case["opt"], case["kw"], group)
            hist = tr.run(4)
        finally:
            O._trust = real
        out[f"{name}/loss"] = np.array([h["loss"] for h in hist])
        out[f"{name}/leaves"] = _leaves(tr.state["params"])
        if seen:
            out[f"{name}/trust"] = np.array(seen)
        if "inbox" in tr.state:
            out[f"{name}/valid"] = tr.state["inbox"]["valid"]
    return out


def _bits(t):
    """A tensor's bits as numpy (bf16 and float8 have no numpy dtype)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.detach().contiguous().view(ints[t.element_size()]).numpy().copy()


def _ckpt_state(tr):
    st = tr.state
    res = {"params": _stretches(st["params"])}
    inbox = st.get("inbox")
    if inbox is not None:
        slots = []
        for sl in inbox["slots"]:
            bufs = sl.buckets if hasattr(sl, "buckets") else sl
            slots.append([{k: _bits(v) for k, v in b.items()}
                          if isinstance(b, dict) else _bits(b)
                          for b in bufs])
        res.update(slots=slots, valid=inbox["valid"].copy(), t=inbox["t"])
    return res


def task_ckpt(dist, group, spec):
    """Straight 6 steps; 3 steps, save, a fresh state restored, 3 more; the
    stacked run's file restored."""
    from repro_torch.checkpoint import restore_state, save_state
    kw = CKPT_CASES[spec["case"]][2]
    straight = _trainer(dist, "sgd", kw, group)
    straight.run(6)
    first = _trainer(dist, "sgd", kw, group)
    first.run(3)
    save_state(spec["rank_ckpt"], first.state, step=3, group=group)
    second = _trainer(dist, "sgd", kw, group)
    second.state, man = restore_state(spec["rank_ckpt"], second.state,
                                      group)
    assert man["step"] == 3
    second.run(3, start_step=3)
    other = _trainer(dist, "sgd", kw, group)
    other.state, _ = restore_state(spec["stacked_ckpt"], other.state, group)
    # a ring of another wire format resets to the template's bootstrap
    wired = _trainer(dist, "sgd", dict(kw, wire_dtype="bf16"), group)
    boot = _ckpt_state(wired)
    wired.state, _ = restore_state(spec["rank_ckpt"], wired.state, group)
    return {"ckpt/straight": _ckpt_state(straight),
            "ckpt/resumed": _ckpt_state(second),
            "ckpt/at3": _ckpt_state(first),
            "ckpt/from_stacked": _ckpt_state(other),
            "ckpt/reset": _ckpt_state(wired), "ckpt/boot": boot}


# ---------------------------------------------------------------- harness

def _spawn(tmp_path, tag, shape, mode, tasks, **spec):
    """Run the worker on every position of the mesh; each rank's results,
    by rank."""
    world = int(np.prod(shape))
    d = tmp_path / tag
    d.mkdir()
    spec = dict(spec, mesh=list(shape), mode=mode, tasks=list(tasks),
                tests=str(Path(__file__).parent))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), init,
         str(d / f"rank{r}.pkl"), json.dumps(spec)],
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
    ranks = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as fh:  # written by the ranks
            ranks.append(pickle.load(fh))
    return ranks


def _stacked_ckpt(path, case):
    """A stacked run of ``case`` saved at step 3."""
    from repro_torch.checkpoint import save_state
    shape, mode, kw = CKPT_CASES[case]
    tr = _trainer(plan(shape, mode), "sgd", kw)
    tr.run(3)
    save_state(str(path), tr.state, step=3)
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world and the reference subprocess, once for the module (the
    reference runs while the worlds that do not need its weights do)."""
    tmp = tmp_path_factory.mktemp("fsdp_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_out = tmp / "ref.pkl"
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(ref_out)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        res = {}
        stacked = {c: _stacked_ckpt(tmp / f"stacked_{c}", c)
                   for c in CKPT_CASES}
        res["stacked_at3"] = {c: _ckpt_state(tr) for c, tr in stacked.items()}
        res["221"] = _spawn(
            tmp, "221", (2, 2, 1), "fsdp", ["wire", "means", "train", "ckpt"],
            cases=list(RANK_CASES), case="fsdp_221",
            rank_ckpt=str(tmp / "rank_fsdp_221"),
            stacked_ckpt=str(tmp / "stacked_fsdp_221"))
        res["122"] = _spawn(tmp, "122", (1, 2, 2), "replica",
                            ["wire", "train"], cases=["async_int8"])
        res["141"] = _spawn(tmp, "141", (1, 4, 1), "replica", ["ckpt"],
                            case="replica_141",
                            rank_ckpt=str(tmp / "rank_replica_141"),
                            stacked_ckpt=str(tmp / "stacked_replica_141"))
        log, _ = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_OK" in log, log[-3000:]
    with open(ref_out, "rb") as fh:  # written by the subprocess above
        res["ref"] = pickle.load(fh)
    init = tmp / "init.pkl"
    with open(init, "wb") as fh:
        pickle.dump(res["ref"]["init"], fh)
    res["222"] = _spawn(tmp, "222", (2, 2, 2), "fsdp", ["e2e"],
                        init=str(init))
    res["tmp"] = tmp
    return res


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("shape,mode", MESHES)
def test_mesh_positions_equal_jax_mesh_order(runs, shape, mode):
    """Replica, shard and batch index of every rank equal the reference's
    ``_axis_rank`` over ``dp_axes``, ``shard_axes`` and the batch axes
    among them, in ``shard_map`` over the same mesh; the subgroups follow
    (a (2, 2, 2) fsdp world reports its own)."""
    from repro_torch.core.replica_group import mesh_tables
    want, dp, dp_axes, shard_axes = runs["ref"]["mesh"][
        ",".join(map(str, shape)) + "/" + mode]
    dist = plan(shape, mode)
    assert (dist.dp, tuple(dist.dp_axes), tuple(dist.shard_axes)) == (
        dp, dp_axes, shard_axes)
    t = mesh_tables(dist)
    got = np.stack([t.replica, t.shard, t.batch], 1)
    np.testing.assert_array_equal(got, want)
    n = len(want)
    for r in range(n):
        assert t.cross_ranks(r) == tuple(
            j for j in range(n) if want[j, 1] == want[r, 1])
        assert t.inner_ranks(r) == tuple(
            j for j in range(n) if want[j, 0] == want[r, 0])
    if (shape, mode) == ((2, 2, 2), "fsdp"):
        for r, rk in enumerate(runs["222"]):
            np.testing.assert_array_equal(rk["position"], want[r])
            assert tuple(rk["cross"]) == t.cross_ranks(r)
            assert tuple(rk["inner"]) == t.inner_ranks(r)
            assert tuple(rk["batch"]) == tuple(
                j for j in range(n) if want[j, 0] == want[r, 0]
                and want[j, 1] % 2 == want[r, 1] % 2)


@pytest.mark.parametrize("engine", ["packed_fused", "packed_unfused"])
def test_ranks_match_the_references_fsdp_run(runs, engine):
    """(2, 2, 2) fsdp on 8 gloo ranks, each holding its (1, stride)
    stretches, against the reference's run of the same engine on 8 forced
    host devices (its ``_E2E_SCRIPT``), 6 steps, within 2e-4; every rank
    reports the replica-mean loss."""
    want = runs["ref"][engine]
    for r in runs["222"]:
        np.testing.assert_allclose(r[f"{engine}/loss"], want, **TOL)
        assert r[f"{engine}/ready_equal"]   # a stacked PackedParams' chunk


def _stacked_exchange(dist):
    from repro_torch.core.gossip import encode_bucket, exchange
    from repro_torch.kernels.quantize import WireFormat
    layout, sched = _wire_inputs(dist)
    rf = torch.as_tensor(np.asarray(sched.recv_from(3), np.int64))
    return layout, [exchange(encode_bucket(WireFormat("int8", seed=5), b, 3,
                                           i), rf)
                    for i, b in enumerate(_random_buckets(layout, dist.dp,
                                                          7))]


@pytest.mark.parametrize("shape,mode,tag", [((2, 2, 1), "fsdp", "221"),
                                            ((1, 2, 2), "replica", "122")])
def test_wire_codes_equal_the_stacked_chunk(runs, shape, mode, tag):
    """One int8 exchange: each rank's received codes and scales are the
    stacked exchange's chunk at its (replica, shard), bit for bit (the
    stretch's noise keyed from the global offset shard * stride); then the
    async int8 subset 0.5 run stays within 2e-4 of the stacked one, with
    the same landed flags."""
    from repro_torch.core import sent_bytes_at
    from repro_torch.kernels.quantize import WireFormat
    dist = plan(shape, mode)
    layout, want = _stacked_exchange(dist)
    assert layout.num_shards == 2
    sent = sent_bytes_at(layout, WireFormat("int8", seed=5), 3)
    for r in runs[tag]:
        q, s = r["position"][:2]
        # the bytes a stretch receives are the per-chip accounting's
        assert sum(r[f"wire/{i}/{k}"].nbytes for i in range(len(want))
                   for k in "qs") == sent["total_bytes"]
        for i, w in enumerate(want):
            n = layout.strides[i]
            np.testing.assert_array_equal(
                r[f"wire/{i}/q"], _chunk(w["q"], (q, s), n).numpy())
            np.testing.assert_array_equal(
                r[f"wire/{i}/s"],
                _chunk(w["s"], (q, s), n // 128).numpy())
    _assert_trajectory(runs[tag], dist, "async_int8")


def _assert_trajectory(ranks, dist, name):
    case = RANK_CASES[name]
    tr = _trainer(dist, case["opt"], case["kw"])
    hist = tr.run(4)
    losses = [h["loss"] for h in hist]
    leaves = _leaves(tr.state["params"])
    for r in ranks:
        q = r["position"][0]
        np.testing.assert_allclose(r[f"{name}/loss"], losses, **TOL,
                                   err_msg=name)
        for got, want in zip(r[f"{name}/leaves"], leaves):
            np.testing.assert_allclose(got[0], want[q], **TOL, err_msg=name)
        if "inbox" in tr.state:
            np.testing.assert_array_equal(r[f"{name}/valid"],
                                          tr.state["inbox"]["valid"][q:q + 1])
    return tr


@pytest.mark.parametrize("name", ["agd", "every_logp"])
def test_replica_means_equal_the_stacked_run(runs, name):
    """(2, 2, 1) fsdp: agd's gradient mean and every_logp's parameter mean
    over the cross-replica group equal the stacked means' chunks bit for
    bit."""
    from repro_torch.core import PackedParams, make_protocol
    dist = plan((2, 2, 1), "fsdp")
    layout, _ = _wire_inputs(dist)
    proto = make_protocol(name, dist.dp)
    x = PackedParams(_random_buckets(layout, dist.dp, 11), layout)
    y = (proto.comm_grads(x, 0) if name == "agd"
         else proto.comm_params(x, proto.schedule.substeps - 1))
    for r in runs["221"]:
        q, s = r["position"][:2]
        for i, b in enumerate(y.buckets):
            np.testing.assert_array_equal(
                r[f"mean/{name}/{i}"],
                _chunk(b, (q, s), layout.strides[i]).numpy())


@pytest.mark.parametrize("name", ["adamw_fused", "lars_unfused"])
def test_optimizers_match_the_stacked_run(runs, name):
    """(2, 2, 1) fsdp, 4 steps: fused adamw on the stretches, and unfused
    lars, whose leaf norms gather the leaf and add the replicas' squares in
    replica order: within 2e-4 of the stacked shard-local run, lars's trust
    ratios within rtol 2e-6."""
    dist = plan((2, 2, 1), "fsdp")
    O, real, rec, seen = _trust_recorder()
    O._trust = rec
    try:
        tr = _assert_trajectory(runs["221"], dist, name)
    finally:
        O._trust = real
    assert tr.bundle.fused == (name == "adamw_fused")
    if name == "lars_unfused":
        assert seen
        for r in runs["221"]:
            np.testing.assert_allclose(r[f"{name}/trust"], seen, rtol=2e-6)


def _same(got, want, msg):
    if isinstance(want, dict):
        for k in want:
            _same(got[k], want[k], f"{msg}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{msg}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=msg)


def _rank_view(state, q, s, strides):
    """A rank's part of a stacked ``_ckpt_state``: row q, chunk s."""
    def cut(x, n):
        return x[q:q + 1, s * n:(s + 1) * n]
    out = {"params": [cut(b, n) for b, n in zip(state["params"], strides)]}
    if "slots" in state:
        out["slots"] = [[{"q": cut(b["q"], n), "s": cut(b["s"], n // 128)}
                         if isinstance(b, dict) else cut(b, n)
                         for b, n in zip(sl, strides)]
                        for sl in state["slots"]]
        out["valid"] = state["valid"][q:q + 1]
        out["t"] = state["t"]
    return out


@pytest.mark.parametrize("case,tag", [("fsdp_221", "221"),
                                      ("replica_141", "141")])
def test_checkpoints_resume_and_cross_restore(runs, case, tag):
    """A rank run saved at step 3 and resumed to 6 equals the straight
    6-step rank run bit for bit, rings and wire rings included; the files
    the ranks write restore in a stacked run (its state's chunks are the
    ranks' step-3 state), and a stacked run's file restores in the
    ranks."""
    from repro_torch.checkpoint import read_manifest, restore_state
    shape, mode, kw = CKPT_CASES[case]
    dist = plan(shape, mode)
    tr = _trainer(dist, "sgd", kw)
    strides = tr.bundle.layout.strides
    for r in runs[tag]:
        _same(r["ckpt/resumed"], r["ckpt/straight"], "resumed")
    path = str(runs["tmp"] / f"rank_{case}")
    assert read_manifest(path)["step"] == 3
    tr.state, _ = restore_state(path, tr.state)
    mine = _ckpt_state(tr)
    stacked = runs["stacked_at3"][case]
    for r in runs[tag]:
        q, s = r["position"][:2]
        _same(r["ckpt/at3"], _rank_view(mine, q, s, strides), "rank file")
        _same(r["ckpt/from_stacked"], _rank_view(stacked, q, s, strides),
              "stacked file")
        reset, boot = r["ckpt/reset"], r["ckpt/boot"]
        _same(reset["params"], r["ckpt/at3"]["params"], "reset params")
        _same(reset["slots"], boot["slots"], "reset ring")
        assert reset["t"] == 3 and not reset["valid"].any()


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_rank_restore_reads_only_its_row_and_chunk(runs, case, monkeypatch):
    """Restoring a stacked file into every rank's template (groups made
    from the plan's tables, no world: a restore runs no collective) reads
    one replica row of every leaf and makes no tensor of the stacked
    state: every array read and every tensor made has one row, and every
    packed bucket is the rank's ``(1, stride)`` stretch. Each rank's
    state is its chunk of the stacked one."""
    import repro_torch.checkpoint.io as io
    from repro_torch.checkpoint import restore_state
    from repro_torch.core.buckets import BucketLayout
    from repro_torch.core.replica_group import mesh_tables
    shape, mode, kw = CKPT_CASES[case]
    dist = plan(shape, mode)
    seen = []

    def recording(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            for x in (out if isinstance(out, tuple) else (out,)):
                seen.append(tuple(x.shape))
            return out
        return wrapped

    monkeypatch.setattr(io, "_read_member", recording(io._read_member))
    monkeypatch.setattr(io, "_tensor", recording(io._tensor))
    monkeypatch.setattr(BucketLayout, "pack", recording(BucketLayout.pack))
    tables = mesh_tables(dist)
    stacked = runs["stacked_at3"][case]
    for r in range(tables.replica.size):
        group = tables.group(r, "gloo", "cpu")
        tr = _trainer(dist, "sgd", kw, group)
        strides = tr.bundle.layout.strides
        seen.clear()
        tr.state, _ = restore_state(str(runs["tmp"] / f"stacked_{case}"),
                                    tr.state, group)
        assert seen and all(s == () or s[0] == 1 for s in seen), seen
        assert all(tuple(b.shape) == (1, n) for b, n in
                   zip(tr.state["params"].buckets, strides))
        _same(_ckpt_state(tr), _rank_view(stacked, group.replica,
                                          group.shard, strides), case)


def test_the_step_runs_under_its_distribution(monkeypatch):
    """``dist_ctx``: ``current_distribution()`` is None outside a step and
    the plan inside the train step's forward (nested contexts unwind);
    ``constrain_logical`` returns its input."""
    import repro_torch.train.step as step_mod
    from repro_torch.dist_ctx import (constrain_logical,
                                      current_distribution,
                                      use_distribution)
    seen = []
    real = step_mod.make_loss_fn

    def recording(*a, **kw):
        fn = real(*a, **kw)

        def loss_fn(params, batch):
            seen.append(current_distribution())
            return fn(params, batch)
        return loss_fn

    monkeypatch.setattr(step_mod, "make_loss_fn", recording)
    dist = plan((2, 2, 1), "fsdp")
    tr = _trainer(dist, "sgd", dict(gossip_packed=True))
    tr.run(1)
    assert seen == [dist] and current_distribution() is None
    other = plan((1, 2, 2), "replica")
    with use_distribution(dist):
        with use_distribution(other):
            assert current_distribution() is other
        assert current_distribution() is dist
    assert current_distribution() is None
    x = torch.ones(2, 3)
    assert constrain_logical(x, "batch,embed") is x


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(argv, world, cwd):
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
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
    assert all(o.strip() == "" for o, _ in outs[1:])
    return outs[0][0]


def test_launcher_runs_the_rank_mesh_and_its_checkpoints(tmp_path, capsys,
                                                         monkeypatch):
    """``--smoke --packed --smoke-mesh 2,2,2`` under ``WORLD_SIZE`` 8 (each
    rank one replica's model-axis stretch): 2 steps with ``--checkpoint``,
    then 2 more with ``--resume``, against the stacked launcher's same two
    runs within 2e-4, and the ranks' file against the stacked file; a
    ``WORLD_SIZE`` other than the mesh's positions raises."""
    from repro_torch.launch.train import main
    base = ["--smoke", "--packed", "--smoke-mesh", "2,2,2", "--steps", "2",
            "--d-model", "32", "--seq-len", "8", "--global-batch", "4",
            "--log-every", "0", "--device", "cpu"]
    stacked = str(tmp_path / "stacked")
    main(base + ["--checkpoint", stacked])
    main(base + ["--checkpoint", stacked, "--resume"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    ranks = str(tmp_path / "ranks")
    _torchrun(base + ["--checkpoint", ranks], 8, tmp_path)
    out = _torchrun(base + ["--checkpoint", ranks, "--resume"], 8, tmp_path)
    got = json.loads(out.strip().splitlines()[-2])
    assert got["start_step"] == want["start_step"] == 2
    assert got["num_shards"] == 2 and got["dp"] == 4
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key
    a, b = (np.load(os.path.join(d, "arrays.npz")) for d in (stacked, ranks))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        main(base)
