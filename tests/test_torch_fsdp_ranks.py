"""In-pod FSDP with one process per mesh position: the port's packed and
per-leaf engines over gloo ranks (CPU) against the reference and against
the port's own stacked runs (shard-local packed, or per-leaf).

Every world spawns one Python process per mesh position
(``launch.mesh.init_replica_group(dist=...)`` with ``init_method=file://``
under ``tmp_path``), gives every wait a timeout and kills the ranks that
outlive it, as ``tests/test_torch_dist.py`` does. The worlds:

* (2, 2, 2) fsdp, 8 ranks: the packed fused and unfused and the per-leaf
  sgd runs of the reference's ``_E2E_SCRIPT``
  (``tests/test_hier_packed.py``), 6 steps from the reference's own
  weights, and each rank's mesh position;
* (2, 2, 1) fsdp, 4 ranks (dp 2 over pods, the replica's rows split over
  ``data``): one int8 exchange's codes and scales, the agd and every_logp
  replica means, gossip_async int8 at subset 0.5, fused adamw, unfused
  lars (with its trust ratios), and checkpoints: save at step 3 and resume
  to 6, a stacked run's file restored; on the per-leaf engines (each rank
  holding its piece of every leaf) one mix's pieces, the two means,
  gossip_async (fp32 wire), adamw, lars and the checkpoints of the ring;
* (1, 2, 2) replica mode, 4 ranks (dp 2, the model axis sharding): the
  same exchange and the async int8 run, and one per-leaf mix;
* (1, 4, 1), 4 whole-replica ranks: checkpoints of the fp32 async ring,
  and per-leaf lars, whose norms span every replica (ROADMAP C.4);
* (1, 3, 1) fsdp, 3 ranks: per-leaf sgd on pieces of unequal length.

One subprocess runs the reference (8 forced host devices): the mesh
positions of six (mesh, mode) plans from ``shard_map``'s axis indices,
and the three ``_E2E_SCRIPT`` runs with their initial weights.
Trajectories are held within rtol = atol = 2e-4; exchanges, replica means
and checkpoints bit for bit.
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
LEAF_ASYNC = dict(protocol="gossip_async", staleness=2, drop_rate=0.2)
RANK_CASES = {   # 4 steps each; on (2, 2, 1) fsdp but leaf_lars_c4
    "async_int8": dict(opt="sgd", kw=dict(gossip_packed=True, **ASYNC_INT8)),
    "adamw_fused": dict(opt="adamw", kw=dict(gossip_packed=True)),
    "lars_unfused": dict(opt="lars", kw=dict(gossip_packed=True)),
    # the per-leaf engines on the ranks' pieces
    "leaf_async": dict(opt="sgd", kw=LEAF_ASYNC),
    "leaf_adamw": dict(opt="adamw", kw={}),
    "leaf_lars": dict(opt="lars", kw={}),
    # (1, 4, 1) replica mode: whole-replica ranks (ROADMAP C.4)
    "leaf_lars_c4": dict(opt="lars_c4", kw={}),
    # (1, 3, 1) fsdp: every leaf's pieces uneven, sent padded; 6 rows a
    # replica, 2 a rank
    "leaf_uneven": dict(opt="sgd", kw={}, per_shard=6),
}
CASES_221 = [c for c in RANK_CASES if c not in ("leaf_lars_c4",
                                                 "leaf_uneven")]
CKPT_CASES = {
    "fsdp_221": ((2, 2, 1), "fsdp", dict(gossip_packed=True, **ASYNC_INT8)),
    "replica_141": ((1, 4, 1), "replica",
                    dict(gossip_packed=True, protocol="gossip_async",
                         staleness=2, fused_update=False)),
    "leaf_221": ((2, 2, 1), "fsdp", LEAF_ASYNC),
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
for name, kw in (("packed_fused", dict(gossip_packed=True)),
                 ("packed_unfused", dict(gossip_packed=True,
                                         fused_update=False)),
                 ("leaf", dict(gossip_packed=False))):
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol="gossip", remat=False, **kw)
    packed = kw["gossip_packed"]
    if packed:
        assert bundle.layout.num_shards == 4
        assert bundle.fused == (name == "packed_fused")
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                packed=packed, layout=bundle.layout)
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
            "lars": lambda: lars(lr, weight_decay=1e-4),
            "lars_c4": lambda: lars(0.1, 0.9, weight_decay=1e-4)}[name]()


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


def _trainer(dist, opt_name, kw, group=None, params=None,
             per_shard=SMALL["per_shard"]):
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
        cfg, opt, dist=dist, packed=kw.get("gossip_packed", False),
        layout=bundle.layout, device="cpu",
        params=params or lm_init(cfg, seed=0, device="cpu"),
        inbox=bundle.protocol.staleness, wire=bundle.wire, group=group)
    ds = ShardedTokenDataset(cfg.vocab, SMALL["seq"], n_shards=dist.dp,
                             batch_per_shard=per_shard)
    return Trainer(bundle, state, ds, log_every=0)


def _leaves(tr):
    """A trainer's whole leaves: unpacked, gathered from the ranks' pieces
    (a collective), or the per-leaf tree itself."""
    from repro_torch.tree import tree_flatten
    b, params = tr.bundle, tr.state["params"]
    with torch.no_grad():
        if b.layout is not None:
            tree = params.unpack()
        elif b.pieces is not None:
            tree = b.pieces.gather_pieces(params, b.group)
        else:
            tree = params
        return [x.detach().numpy().copy() for x in tree_flatten(tree)[0]]


def _piece_table(dist):
    """The per-leaf piece table of the plan (``bundle.pieces`` of its
    ranks)."""
    from repro_torch.train.step import _build_packed_layout
    return _build_packed_layout(dist, _cfg(SMALL["d"], dist.mode))


def _random_tree(pieces, dp, seed):
    """A stacked tree of ``dp`` rows of seeded normal leaves."""
    rng = np.random.default_rng(seed)
    return pieces.treedef.unflatten(
        [torch.from_numpy(rng.standard_normal((dp,) + shp)
                          .astype(np.float32))
         for shp in pieces.leaf_shapes])


def _rank_pieces(pieces, tree, q, s):
    """Replica q's row of a stacked tree, cut to shard s's pieces."""
    from repro_torch.tree import tree_map
    return pieces.cut_pieces(tree_map(lambda x: x[q:q + 1], tree), s)


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
    out = {"leaf/loss": _e2e_leaf(cfg, dist, group, init)}
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


def _e2e_leaf(cfg, dist, group, init):
    """The per-leaf engine's run of the reference's _E2E_SCRIPT: each rank
    holds its piece of every leaf of the reference's weights."""
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    opt = sgd(0.3, momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dist=dist, remat=False,
                                    device="cpu", group=group)
    assert bundle.layout is None and bundle.pieces.num_shards == 4
    state = init_train_state(cfg, opt, dist=dist, device="cpu", group=group,
                             params=params_from_numpy(init, device="cpu"))
    for i, x in enumerate(tree_leaves(state["params"])):
        assert tuple(x.shape) == (1,) + bundle.pieces.piece_shape(
            i, group.shard)
    ds = ShardedTokenDataset(cfg.vocab, 24, n_shards=2, batch_per_shard=2,
                             seed=0)
    hist = Trainer(bundle, state, ds, log_every=0).run(6)
    return np.array([h["loss"] for h in hist])


def tree_leaves(tree):
    from repro_torch.tree import tree_flatten
    return tree_flatten(tree)[0]


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


def task_leaf_mix(dist, group, spec):
    """One per-leaf gossip mix of the rank's pieces at phase 3 (the
    exchange over the cross-replica group, then the mix op by op)."""
    from repro_torch.core import build_schedule
    from repro_torch.core.gossip import make_gossip_mix
    pieces = _piece_table(dist)
    tree = _rank_pieces(pieces, _random_tree(pieces, dist.dp, 7),
                        group.replica, group.shard)
    mix = make_gossip_mix(build_schedule(dist.dp, num_rotations=2, seed=0),
                          group=group)
    return {f"leaf_mix/{i}": x.numpy().copy()
            for i, x in enumerate(tree_leaves(mix(tree, 3)))}


def task_leaf_means(dist, group, spec):
    """agd's gradient mean and every_logp's parameter mean of pieces."""
    from repro_torch.core import make_protocol
    pieces = _piece_table(dist)
    out = {}
    for name in ("agd", "every_logp"):
        proto = make_protocol(name, dist.dp, group=group)
        x = _rank_pieces(pieces, _random_tree(pieces, dist.dp, 11),
                         group.replica, group.shard)
        y = (proto.comm_grads(x, 0) if name == "agd"
             else proto.comm_params(x, proto.schedule.substeps - 1))
        for i, leaf in enumerate(tree_leaves(y)):
            out[f"leaf_mean/{name}/{i}"] = leaf.numpy().copy()
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
            tr = _trainer(dist, case["opt"], case["kw"], group,
                          per_shard=case.get("per_shard", SMALL["per_shard"]))
            hist = tr.run(4)
        finally:
            O._trust = real
        out[f"{name}/loss"] = np.array([h["loss"] for h in hist])
        out[f"{name}/leaves"] = _leaves(tr)
        if seen:
            out[f"{name}/trust"] = np.array(seen)
        if "inbox" in tr.state:
            out[f"{name}/valid"] = tr.state["inbox"]["valid"]
    return out


def _bits(t):
    """A tensor's bits as numpy (bf16 and float8 have no numpy dtype)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    return t.detach().contiguous().view(ints[t.element_size()]).numpy().copy()


def _tree_bits(tree):
    return [_bits(x) for x in tree_leaves(tree)]


def _ckpt_state(tr):
    st = tr.state
    if tr.bundle.layout is None:   # per-leaf: trees of leaves or pieces
        res = {"params": _tree_bits(st["params"]),
               "mom": _tree_bits(st["opt"]["mom"])}
        inbox = st.get("inbox")
        if inbox is not None:
            res.update(slots=[_tree_bits(sl) for sl in inbox["slots"]],
                       valid=inbox["valid"].copy(), t=inbox["t"])
        return res
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
    """Per checkpoint case: straight 6 steps; 3 steps, save, a fresh state
    restored, 3 more; the stacked run's file restored."""
    out = {}
    for case in spec["ckpt_cases"]:
        out.update(_rank_ckpt(dist, group, spec, case))
    return out


def _rank_ckpt(dist, group, spec, case):
    from repro_torch.checkpoint import restore_state, save_state
    kw = CKPT_CASES[case][2]
    rank_ckpt = spec["ckpt"] + f"/rank_{case}"
    straight = _trainer(dist, "sgd", kw, group)
    straight.run(6)
    first = _trainer(dist, "sgd", kw, group)
    first.run(3)
    pieces = first.bundle.pieces
    save_state(rank_ckpt, first.state, step=3, group=group, pieces=pieces)
    second = _trainer(dist, "sgd", kw, group)
    second.state, man = restore_state(rank_ckpt, second.state, group,
                                      pieces)
    assert man["step"] == 3
    second.run(3, start_step=3)
    other = _trainer(dist, "sgd", kw, group)
    other.state, _ = restore_state(spec["ckpt"] + f"/stacked_{case}",
                                   other.state, group, pieces)
    out = {"straight": _ckpt_state(straight), "resumed": _ckpt_state(second),
           "at3": _ckpt_state(first), "from_stacked": _ckpt_state(other)}
    if kw.get("gossip_packed"):
        # a ring of another wire format resets to the template's bootstrap
        wired = _trainer(dist, "sgd", dict(kw, wire_dtype="bf16"), group)
        out["boot"] = _ckpt_state(wired)
        wired.state, _ = restore_state(rank_ckpt, wired.state, group)
        out["reset"] = _ckpt_state(wired)
    return {f"ckpt/{case}/{k}": v for k, v in out.items()}


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
            tmp, "221", (2, 2, 1), "fsdp",
            ["wire", "means", "leaf_mix", "leaf_means", "train", "ckpt"],
            cases=CASES_221, ckpt=str(tmp),
            ckpt_cases=["fsdp_221", "leaf_221"])
        res["122"] = _spawn(tmp, "122", (1, 2, 2), "replica",
                            ["wire", "leaf_mix", "train"],
                            cases=["async_int8"])
        res["141"] = _spawn(tmp, "141", (1, 4, 1), "replica",
                            ["ckpt", "train"], cases=["leaf_lars_c4"],
                            ckpt=str(tmp), ckpt_cases=["replica_141"])
        res["131"] = _spawn(tmp, "131", (1, 3, 1), "fsdp", ["train"],
                            cases=["leaf_uneven"])
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


@pytest.mark.parametrize("engine", ["packed_fused", "packed_unfused",
                                    "leaf"])
def test_ranks_match_the_references_fsdp_run(runs, engine):
    """(2, 2, 2) fsdp on 8 gloo ranks, each holding its (1, stride)
    stretches (packed) or its piece of every leaf (per-leaf), against the
    reference's run of the same engine on 8 forced host devices (its
    ``_E2E_SCRIPT``), 6 steps, within 2e-4; every rank reports the
    replica-mean loss."""
    want = runs["ref"][engine]
    for r in runs["222"]:
        np.testing.assert_allclose(r[f"{engine}/loss"], want, **TOL)
        if engine != "leaf":   # a stacked PackedParams' chunk
            assert r[f"{engine}/ready_equal"]


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


@pytest.mark.parametrize("shape,mode,tag", [((2, 2, 1), "fsdp", "221"),
                                            ((1, 2, 2), "replica", "122")])
def test_leaf_mix_equals_the_stacked_mix(runs, shape, mode, tag):
    """One per-leaf gossip mix at phase 3: each rank's mixed pieces (its
    piece exchanged with the partner replica's rank at the same shard) are
    the stacked mix's leaves at the same elements, bit for bit."""
    from repro_torch.core import build_schedule
    from repro_torch.core.gossip import make_gossip_mix
    dist = plan(shape, mode)
    pieces = _piece_table(dist)
    assert pieces.num_shards == 2
    tree = _random_tree(pieces, dist.dp, 7)
    make_gossip_mix(build_schedule(dist.dp, num_rotations=2, seed=0))(
        tree, 3)
    for r in runs[tag]:
        q, s = r["position"][:2]
        want = tree_leaves(_rank_pieces(pieces, tree, q, s))
        for i, w in enumerate(want):
            np.testing.assert_array_equal(r[f"leaf_mix/{i}"], w.numpy())


def _assert_trajectory(ranks, dist, name):
    case = RANK_CASES[name]
    tr = _trainer(dist, case["opt"], case["kw"],
                  per_shard=case.get("per_shard", SMALL["per_shard"]))
    hist = tr.run(4)
    losses = [h["loss"] for h in hist]
    leaves = _leaves(tr)
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


@pytest.mark.parametrize("name", ["agd", "every_logp"])
def test_leaf_means_equal_the_stacked_run(runs, name):
    """(2, 2, 1) fsdp: agd's gradient mean and every_logp's parameter mean
    of the ranks' pieces over the cross-replica group equal the stacked
    per-leaf means at the same elements, bit for bit."""
    from repro_torch.core import make_protocol
    dist = plan((2, 2, 1), "fsdp")
    pieces = _piece_table(dist)
    proto = make_protocol(name, dist.dp)
    x = _random_tree(pieces, dist.dp, 11)
    y = (proto.comm_grads(x, 0) if name == "agd"
         else proto.comm_params(x, proto.schedule.substeps - 1))
    for r in runs["221"]:
        q, s = r["position"][:2]
        for i, w in enumerate(tree_leaves(_rank_pieces(pieces, y, q, s))):
            np.testing.assert_array_equal(r[f"leaf_mean/{name}/{i}"],
                                          w.numpy())


def _assert_optimizer(ranks, dist, name):
    O, real, rec, seen = _trust_recorder()
    O._trust = rec
    try:
        tr = _assert_trajectory(ranks, dist, name)
    finally:
        O._trust = real
    if "lars" in name:
        assert seen
        for r in ranks:
            np.testing.assert_allclose(r[f"{name}/trust"], seen, rtol=2e-6)
    return tr


@pytest.mark.parametrize("name", ["adamw_fused", "lars_unfused",
                                  "leaf_async", "leaf_adamw", "leaf_lars"])
def test_optimizers_match_the_stacked_run(runs, name):
    """(2, 2, 1) fsdp, 4 steps: fused adamw on the stretches, and unfused
    lars, whose leaf norms gather the leaf and add the replicas' squares in
    replica order; on the per-leaf engines' pieces gossip_async (fp32
    wire, its landed flags equal), adamw, and lars, whose pieces' squares
    are added over the replica's shards and then the replicas: within
    2e-4 of the stacked run of the same engine (shard-local packed, or
    per-leaf), lars's trust ratios within rtol 2e-6."""
    tr = _assert_optimizer(runs["221"], plan((2, 2, 1), "fsdp"), name)
    assert tr.bundle.fused == (name == "adamw_fused")
    assert (tr.bundle.layout is None) == name.startswith("leaf")


def test_leaf_uneven_pieces_travel_padded(runs):
    """(1, 3, 1) fsdp, 3 ranks: every leaf splits into pieces of unequal
    length, so each gather and each reduce-scatter sends the pieces padded
    to the leaf's longest; the per-leaf sgd run on the ranks is within
    2e-4 of the stacked per-leaf run."""
    dist = plan((1, 3, 1), "fsdp")
    pieces = _piece_table(dist)
    assert all(len({s.size for s in row}) > 1 for row in pieces.piece_slots)
    _assert_trajectory(runs["131"], dist, "leaf_uneven")


def test_leaf_lars_norms_span_every_replica(runs):
    """ROADMAP C.4: (1, 4, 1) replica mode, 4 whole-replica gloo ranks of
    per-leaf ``lars(0.1, 0.9, weight_decay=1e-4)`` under sync gossip, 4
    steps: each leaf's norms add the replicas' squares in replica order,
    so the trust ratios are the stacked per-leaf run's, which spans every
    replica, within rtol 2e-6, and losses and params within 2e-4."""
    _assert_optimizer(runs["141"], plan((1, 4, 1), "replica"),
                      "leaf_lars_c4")


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


def _rank_view(state, q, s, bundle):
    """A rank's part of a stacked ``_ckpt_state`` of ``bundle``'s run: row
    q, chunk s of a stretch, or the piece of shard s of a leaf."""
    if bundle.layout is None:
        pieces = _piece_table(bundle.dist)

        def cut_tree(xs):
            return [pieces.piece(torch.from_numpy(x[q:q + 1]), i, s).numpy()
                    for i, x in enumerate(xs)]
        out = {k: cut_tree(state[k]) for k in ("params", "mom")}
        if "slots" in state:
            out.update(slots=[cut_tree(sl) for sl in state["slots"]],
                       valid=state["valid"][q:q + 1], t=state["t"])
        return out
    strides = bundle.layout.strides

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
                                      ("replica_141", "141"),
                                      ("leaf_221", "221")])
def test_checkpoints_resume_and_cross_restore(runs, case, tag):
    """A rank run saved at step 3 and resumed to 6 equals the straight
    6-step rank run bit for bit, rings and wire rings included (per-leaf:
    the params, the momentum and the ring's slots as the ranks' pieces);
    the files the ranks write restore in a stacked run (its state's chunks
    or pieces are the ranks' step-3 state), and a stacked run's file
    restores in the ranks."""
    from repro_torch.checkpoint import read_manifest, restore_state
    shape, mode, kw = CKPT_CASES[case]
    dist = plan(shape, mode)
    tr = _trainer(dist, "sgd", kw)

    def got(r, k):
        return r[f"ckpt/{case}/{k}"]
    for r in runs[tag]:
        _same(got(r, "resumed"), got(r, "straight"), "resumed")
    path = str(runs["tmp"] / f"rank_{case}")
    assert read_manifest(path)["step"] == 3
    tr.state, _ = restore_state(path, tr.state)
    mine = _ckpt_state(tr)
    stacked = runs["stacked_at3"][case]
    for r in runs[tag]:
        q, s = r["position"][:2]
        _same(got(r, "at3"), _rank_view(mine, q, s, tr.bundle), "rank file")
        _same(got(r, "from_stacked"), _rank_view(stacked, q, s, tr.bundle),
              "stacked file")
        if kw.get("gossip_packed"):
            reset, boot = got(r, "reset"), got(r, "boot")
            _same(reset["params"], got(r, "at3")["params"], "reset params")
            _same(reset["slots"], boot["slots"], "reset ring")
            assert reset["t"] == 3 and not reset["valid"].any()


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_rank_restore_reads_only_its_row_and_chunk(runs, case, monkeypatch):
    """Restoring a stacked file into every rank's template (groups made
    from the plan's tables, no world: a restore runs no collective) reads
    one replica row of every leaf and makes no tensor of the stacked
    state: every array read and every tensor made has one row, every
    packed bucket is the rank's ``(1, stride)`` stretch and every per-leaf
    tensor its ``(1, *piece_shape)`` piece. Each rank's state is its chunk
    or its pieces of the stacked one."""
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
        seen.clear()
        tr.state, _ = restore_state(str(runs["tmp"] / f"stacked_{case}"),
                                    tr.state, group, tr.bundle.pieces)
        assert seen and all(s == () or s[0] == 1 for s in seen), seen
        if tr.bundle.layout is not None:
            assert all(tuple(b.shape) == (1, n) for b, n in
                       zip(tr.state["params"].buckets,
                           tr.bundle.layout.strides))
        else:
            for i, x in enumerate(tree_leaves(tr.state["params"])):
                assert tuple(x.shape) == (1,) + tr.bundle.pieces.piece_shape(
                    i, group.shard)
        _same(_ckpt_state(tr), _rank_view(stacked, group.replica,
                                          group.shard, tr.bundle), case)


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


def _launcher_pair(tmp_path, capsys, base, world, tag):
    """The stacked launcher's run of ``base`` with ``--checkpoint``, then
    ``--resume``, and the same two under ``WORLD_SIZE`` ``world``: both
    final JSON lines and checkpoint dirs."""
    from repro_torch.launch.train import main
    stacked = str(tmp_path / f"stacked_{tag}")
    main(base + ["--checkpoint", stacked])
    main(base + ["--checkpoint", stacked, "--resume"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    ranks = str(tmp_path / f"ranks_{tag}")
    _torchrun(base + ["--checkpoint", ranks], world, tmp_path)
    out = _torchrun(base + ["--checkpoint", ranks, "--resume"], world,
                    tmp_path)
    got = json.loads(out.strip().splitlines()[-2])
    assert got["start_step"] == want["start_step"] == 2
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key
    a, b = (np.load(os.path.join(d, "arrays.npz")) for d in (stacked, ranks))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], **TOL, err_msg=k)
    return want, got


def test_launcher_runs_the_rank_mesh_and_its_checkpoints(tmp_path, capsys,
                                                         monkeypatch):
    """``--smoke --packed --smoke-mesh 2,2,2`` under ``WORLD_SIZE`` 8 (each
    rank one replica's model-axis stretch), and the per-leaf engine (no
    ``--packed``) on ``--smoke-mesh 1,2,2`` under ``WORLD_SIZE`` 4 (each
    rank its piece of every leaf of its replica): 2 steps with
    ``--checkpoint``, then 2 more with ``--resume``, against the stacked
    launcher's same two runs within 2e-4, and the ranks' file against the
    stacked file; a ``WORLD_SIZE`` other than the mesh's positions
    raises."""
    from repro_torch.launch.train import main
    small = ["--steps", "2", "--d-model", "32", "--seq-len", "8",
             "--global-batch", "4", "--log-every", "0", "--device", "cpu"]
    base = ["--smoke", "--packed", "--smoke-mesh", "2,2,2", *small]
    _, got = _launcher_pair(tmp_path, capsys, base, 8, "packed")
    assert got["num_shards"] == 2 and got["dp"] == 4
    want, got = _launcher_pair(
        tmp_path, capsys, ["--smoke", "--smoke-mesh", "1,2,2", *small], 4,
        "leaf")
    assert (want["num_shards"], got["num_shards"]) == (1, 2)
    assert got["dp"] == 2 and got["packed"] is False
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        main(base)


def test_pieces_may_be_empty():
    """A leaf with fewer elements than the chunks of the axes it does not
    use leaves some shards an empty ``(0,)`` piece: the pieces still tile
    it once, and an empty piece travels as zeros of the leaf's longest."""
    from repro_torch.core.buckets import build_layout
    tree = {"a": torch.arange(2.0), "b": torch.arange(15.0).reshape(5, 3)}
    lay = build_layout(tree, shard_axes=("data", "model"),
                       shard_axis_sizes=(2, 2),
                       shard_specs={"a": None, "b": None})
    assert [lay.piece_shape(0, s) for s in range(4)] == [(1,), (1,), (0,),
                                                         (0,)]
    assert [lay.piece_shape(1, s) for s in range(4)] == [(4,), (4,), (4,),
                                                         (3,)]
    for i, leaf in enumerate(tree_leaves(tree)):
        parts = [lay.piece(leaf[None], i, s) for s in range(4)]
        padded = [lay.padded_piece(p, i) for p in parts]
        assert {tuple(p.shape) for p in padded} == {(1, lay.piece_len(i))}
        assert torch.equal(lay.place_pieces(i, padded), leaf[None])


@pytest.mark.parametrize("shape,mode", MESHES)
def test_pieces_tile_each_leaf_once(shape, mode):
    """A per-leaf rank's pieces (``cut_pieces`` at its shard) tile every
    leaf once: ``place_pieces`` of every shard's piece, padded as the
    gather sends it, is the leaf bit for bit, each piece has
    ``piece_shape`` (the block's where it is a whole block), and the
    pieces' bytes over the replica are the replica's bytes, the count
    ``launch.roofline.in_replica_bytes`` takes."""
    from repro_torch.core.replica_group import mesh_tables
    dist = plan(shape, mode)
    pieces = _piece_table(dist)
    shards = mesh_tables(dist).num_shards
    assert pieces.num_shards == shards
    tree = _random_tree(pieces, 1, 3)
    cut = [pieces.cut_pieces(tree, s) for s in range(shards)]
    total = 0
    for i, leaf in enumerate(tree_leaves(tree)):
        parts = [tree_leaves(c)[i] for c in cut]
        for s, p in enumerate(parts):
            assert tuple(p.shape) == (1,) + pieces.piece_shape(i, s)
            total += p.numel() * p.element_size()
        back = pieces.place_pieces(i, [pieces.padded_piece(p, i)
                                       for p in parts])
        assert torch.equal(back, leaf)
    assert total == sum(x.numel() * x.element_size()
                        for x in tree_leaves(tree))
