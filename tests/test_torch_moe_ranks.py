"""Expert parallelism over ``model`` on the rank paths, and serving over a
process mesh: the port's ``models.moe._expert_compute_manual`` on gloo
ranks (CPU) against the reference's own manual path and against the
port's stacked runs.

One subprocess runs the reference with 4 forced host devices: under
``use_distribution(make_distribution(mesh, mode))`` its ``make_loss_fn``
value and gradient, ``lm_prefill`` and ``lm_decode`` take
``_expert_compute_manual`` (counted), on reduced fp32 jamba over (1, 2,
2) fsdp and kimi-k2 (shared expert, top-2) over the (2, 2) replica plan.

The worlds, one process per mesh position (``init_replica_group`` with a
``file://`` rendezvous; every wait has a timeout and ranks that outlive it
are killed, as in ``tests/test_torch_fsdp_ranks.py``):

* (1, 2, 2) fsdp, jamba: the first step's loss and gradients on the
  per-leaf and packed rank paths against the reference; the experts a
  rank computes (``E / M``) and the collectives of one per-leaf step (the
  experts gathered over the batch group only, the partial sums over the
  model group); 3-step trajectories against the port's stacked runs;
  remat on against off bit for bit, and the model-group collectives a
  step with remat off, on and ``save_moe_combine``; serving: prefill and
  decode logits against the reference, greedy tokens against the
  one-process engine, a batch of 3 (which does not split) served over
  the sequence-parallel cache against the one-process port;
* (1, 2, 2) replica, kimi-k2: the per-leaf first step against the
  reference.

Plus the launcher's ``--smoke --arch jamba-v0.1-52b --smoke-mesh 1,2,2``
on 4 ranks against the same launcher in one process, and the model and
batch groups tiling every replica. Tolerances: 2e-4.
"""
import dataclasses
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
JAMBA, KIMI = "jamba-v0.1-52b", "kimi-k2-1t-a32b"
D, B, S = 32, 4, 8               # width, global rows, tokens a row
PROMPT, MAX_SEQ, NEW = 6, 16, 3  # serving: prefill, cache, decode steps
WORLDS = {"fsdp": (JAMBA, "fsdp"), "replica": (KIMI, "replica")}
MESHES = [((1, 2, 2), "fsdp"), ((1, 2, 2), "replica"), ((2, 2, 1), "fsdp"),
          ((2, 2, 1), "replica"), ((2, 2, 2), "fsdp"),
          ((2, 2, 2), "replica")]

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.dist_ctx import use_distribution
from repro.launch.mesh import make_smoke_mesh
from repro.models import lm_cache_init, lm_decode, lm_init, lm_prefill, reduced
from repro.models import moe
from repro.train import make_distribution
from repro.train.loss import make_loss_fn

D, B, S, PROMPT, MAX_SEQ, NEW = (int(a) for a in sys.argv[2:8])
calls = [0]
manual = moe._expert_compute_manual


def counted(*a, **kw):
    calls[0] += 1
    return manual(*a, **kw)


moe._expert_compute_manual = counted
out = {}
for tag, arch, mode in (("fsdp", "jamba-v0.1-52b", "fsdp"),
                        ("replica", "kimi-k2-1t-a32b", "replica")):
    cfg = dataclasses.replace(reduced(get_config(arch), d_model=D),
                              param_dtype="float32", compute_dtype="float32",
                              dist_mode=mode)
    dist = make_distribution(make_smoke_mesh(2, 2), mode)
    params = lm_init(jax.random.key(0), cfg)[0]
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    vg = jax.jit(jax.value_and_grad(make_loss_fn(cfg), has_aux=True))
    prefill = jax.jit(lambda p, t, c: lm_prefill(p, cfg, t, c))
    decode = jax.jit(lambda p, t, c, pos: lm_decode(p, cfg, t, c, pos))
    calls[0] = 0
    with use_distribution(dist):
        (loss, _), grads = vg(params, {"tokens": jnp.asarray(toks)})
        logits, cache = prefill(params, jnp.asarray(toks[:, :PROMPT]),
                                lm_cache_init(cfg, B, MAX_SEQ))
        served = [np.asarray(logits)]
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = decode(params, jnp.asarray(toks[:, t]), cache,
                                   jnp.int32(t))
            served.append(np.asarray(logits))
    out[tag] = {"init": jax.tree.map(np.asarray, params), "tokens": toks,
                "loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
                "served": served, "manual_calls": calls[0]}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
print("REF_OK")
"""

_WORKER = r"""
import importlib, json, pickle, sys
import torch
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
rank, world, init, out, spec = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4],
                                json.loads(sys.argv[5]))
sys.path.insert(0, spec["tests"])
T = importlib.import_module(spec["module"])
from repro_torch.launch.mesh import destroy_replica_group, init_replica_group
dist = T.plan(spec["mode"])
group = init_replica_group("cpu", dist=dist, rank=rank, world_size=world,
                           init_method=init, timeout_s=120)
res = {"model_ranks": group.model_ranks, "model_index": group.model_index}
for task in spec["tasks"]:
    res.update(getattr(T, "task_" + task)(dist, group, spec))
with open(out, "wb") as fh:
    pickle.dump(res, fh)
destroy_replica_group()
print("RANK_OK", rank)
"""


def plan(mode, shape=(1, 2, 2)):
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import make_distribution
    pod, data, model = shape
    return make_distribution(make_smoke_mesh(data, model, pod=pod), mode)


def _cfg(arch, mode):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return dataclasses.replace(reduced(get_config(arch), d_model=D),
                               param_dtype="float32",
                               compute_dtype="float32", dist_mode=mode)


def _leaves(tree):
    from repro_torch.tree import tree_flatten
    return tree_flatten(tree)[0]


def _np(tree):
    return [x.detach().numpy().copy() for x in _leaves(tree)]


def _init(spec, device="cpu"):
    from repro_torch.checkpoint import params_from_numpy
    with open(spec["ref"], "rb") as fh:
        ref = pickle.load(fh)[spec["world"]]
    return ref, params_from_numpy(ref["init"], device=device)


def _bundle(cfg, dist, group, packed, **kw):
    from repro_torch.optim import sgd
    from repro_torch.train import make_train_step_bundle
    opt = sgd(0.3, momentum=0.9)
    return opt, make_train_step_bundle(cfg, opt, dist=dist, device="cpu",
                                       gossip_packed=packed, group=group,
                                       **dict(dict(remat=False), **kw))


def _whole(bundle, tree_or_packed):
    """The replica's whole leaves of a rank's params or gradients: the
    packed stretches gathered and assembled, the pieces gathered whole (a
    stacked run's as they are)."""
    from repro_torch.core.buckets import _gather_stretches
    group = bundle.group
    with torch.no_grad():
        if bundle.layout is not None:
            full = [b if group is None else _gather_stretches(b, group)
                    for b in tree_or_packed.buckets]
            return _np(bundle.layout.unpack(full))
        if group is None:
            return _np(tree_or_packed)
        return _np(bundle.pieces.gather_pieces(tree_or_packed, group))


def _ffn_widths():
    """Wrap ``moe._expert_ffn`` to record the expert count of every call."""
    from repro_torch.models import moe
    real, seen = moe._expert_ffn, []

    def rec(wg, wi, wo, xe, out_dtype):
        seen.append(int(wg.shape[-3]))
        return real(wg, wi, wo, xe, out_dtype)
    return moe, real, rec, seen


def _traffic(group):
    """Wrap ``torch.distributed.all_gather`` to record (group, bytes sent
    a member) of every call."""
    import torch.distributed as tdist
    real, seen = tdist.all_gather, []
    names = {id(group.inner): "inner", id(group.batch): "batch",
             id(group.model): "model"}

    def rec(parts, x, group=None, **kw):
        seen.append((names.get(id(group), "other"),
                     x.numel() * x.element_size()))
        return real(parts, x, group=group, **kw)
    return tdist, real, rec, seen


def _step1(cfg, dist, group, packed, spec):
    """One step of the rank path from the reference's weights on its rows
    of the reference's batch: the loss, the gradients the step computed
    (read where the protocol receives them), the expert counts of the
    FFN calls and, per-leaf, the all-gathers of the step."""
    from repro_torch.train import init_train_state
    ref, init = _init(spec)
    opt, bundle = _bundle(cfg, dist, group, packed)
    state = init_train_state(cfg, opt, dist=dist, packed=packed,
                             layout=bundle.layout, device="cpu",
                             params=init, group=group)
    rows = B // group.batch_shards
    lo = group.batch_index * rows
    batch = {"tokens": torch.from_numpy(
        ref["tokens"][None, lo:lo + rows].astype(np.int64))}
    got = {}
    real_grads = bundle.protocol.comm_grads

    def record(grads, phase):
        got["gathers"] = list(gathers)   # the forward's and backward's
        got["grads"] = [x[0] for x in _whole(bundle, grads)]
        return real_grads(grads, phase)
    bundle.protocol.comm_grads = record
    moe, real_ffn, rec_ffn, widths = _ffn_widths()
    tdist, real_ag, rec_ag, gathers = _traffic(group)
    moe._expert_ffn, tdist.all_gather = rec_ffn, rec_ag
    try:
        _, _, metrics = bundle.step(state, batch, 0, rotate=False)
    finally:
        moe._expert_ffn, tdist.all_gather = real_ffn, real_ag
    tag = "step1/" + ("packed" if packed else "leaf")
    out = {f"{tag}/loss": float(metrics["loss"]),
           f"{tag}/grads": got["grads"], f"{tag}/widths": widths,
           f"{tag}/gathers": got["gathers"]}
    if not packed:
        out["piece_bytes"] = [bundle.pieces.piece_len(i) * 4
                              for i in range(bundle.pieces.num_leaves)]
    return out


def task_step1(dist, group, spec):
    cfg = _cfg(*WORLDS[spec["world"]])
    out = _step1(cfg, dist, group, False, spec)
    if spec["world"] == "fsdp":
        out.update(_step1(cfg, dist, group, True, spec))
    return out


def _trainer(cfg, dist, group, packed, **kw):
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.train import Trainer, init_train_state
    from repro_torch.models import lm_init
    opt, bundle = _bundle(cfg, dist, group, packed, **kw)
    state = init_train_state(cfg, opt, dist=dist, packed=packed,
                             layout=bundle.layout, device="cpu",
                             params=lm_init(cfg, seed=0, device="cpu"),
                             group=group)
    ds = ShardedTokenDataset(cfg.vocab, S, n_shards=dist.dp,
                             batch_per_shard=B // dist.dp)
    return Trainer(bundle, state, ds, log_every=0)


def _run3(tr):
    hist = tr.run(3)
    return [h["loss"] for h in hist]


def task_train(dist, group, spec):
    """3 steps per-leaf and packed (remat off), per-leaf with remat on and
    with ``save_moe_combine``; the model-group collectives of one step."""
    from repro_torch.models import moe
    cfg = _cfg(JAMBA, "fsdp")
    out = {}
    for tag, packed, kw in (("leaf", False, {}), ("packed", True, {}),
                            ("remat", False, dict(remat=True)),
                            ("save", False, dict(
                                remat=True,
                                remat_policy="save_moe_combine"))):
        tr = _trainer(cfg, dist, group, packed, **kw)
        tr.run(1)
        counts = dict(moe.model_collectives)
        tr.run(1, start_step=1)
        out[f"{tag}/collectives"] = {
            k: v - counts[k] for k, v in moe.model_collectives.items()}
        tr.run(1, start_step=2)
        out[f"{tag}/loss"] = [h["loss"] for h in tr.history]
        out[f"{tag}/params"] = _whole(tr.bundle, tr.state["params"])
        if not packed:
            out[f"{tag}/pieces"] = _np(tr.state["params"])
    return out


def task_serve(dist, group, spec):
    """The serve steps' prefill and decode logits and the engine's greedy
    tokens over the ranks from the reference's weights (each rank its
    pieces, gathered once); then the first 3 rows, a batch that does not
    split, served over the ranks' sequence-parallel cache."""
    from repro_torch.models import lm_axes, lm_cache_init
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                        rank_cache_init, rank_serving_params,
                                        serve_pieces)
    cfg = _cfg(JAMBA, "fsdp")
    ref, init = _init(spec)
    pieces = serve_pieces(cfg, dist).cut_pieces(init, group.shard)
    weights = rank_serving_params(cfg, dist, pieces, group)
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    out = {"serve/expert_shapes": [
        tuple(x.shape) for x, d in zip(_leaves(weights),
                                       dist.expert_dims(_specs(cfg)))
        if d is not None]}
    with torch.inference_mode():
        cache = lm_cache_init(cfg, B // group.batch_shards, MAX_SEQ,
                              device="cpu")
        kw = dict(param_shapes=weights, param_axes=lm_axes(cfg),
                  cache_shapes=cache, group=group)
        prefill = make_prefill_step(cfg, dist, **kw).step_fn
        decode = make_decode_step(cfg, dist, **kw).step_fn
        logits, cache = prefill(weights, cache, toks[:, :PROMPT])
        served = [logits.numpy().copy()]
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = decode(weights, cache, toks[:, t],
                                   torch.tensor(t))
            served.append(logits.numpy().copy())
        cache = rank_cache_init(cfg, dist, group, 3, MAX_SEQ, device="cpu")
        kw.update(cache_shapes=cache, max_seq=MAX_SEQ)
        logits, cache = make_prefill_step(cfg, dist, **kw).step_fn(
            weights, cache, toks[:3, :PROMPT])
        rows3 = [logits.numpy().copy()]
        decode = make_decode_step(cfg, dist, **kw).step_fn
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = decode(weights, cache, toks[:3, t],
                                   torch.tensor(t))
            rows3.append(logits.numpy().copy())
    engine = ServingEngine(cfg, pieces, MAX_SEQ, device="cpu", dist=dist,
                           group=group)
    out.update({"serve/logits": served, "serve/rows3": rows3,
                "serve/tokens": engine.generate(
                    ref["tokens"][:, :PROMPT], NEW + 2)})
    return out


def _specs(cfg):
    from repro_torch.models import lm_specs
    return lm_specs(cfg)


# ---------------------------------------------------------------- harness

def _spawn(tmp, world, tasks, module="test_torch_moe_ranks", mode=None,
           **spec):
    """Run the worker on every position of the world's (1, 2, 2) mesh;
    each rank's results, by rank. The worker calls ``task_<name>`` of the
    test module ``module`` (which also provides ``plan``) for each of
    ``tasks``, under the plan of ``mode`` (default: the world's)."""
    d = tmp / world
    d.mkdir()
    spec = dict(spec, world=world, mode=mode or WORLDS[world][1],
                tasks=list(tasks), module=module,
                tests=str(Path(__file__).parent))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "4", init,
         str(d / f"rank{r}.pkl"), json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
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
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as fh:  # written by the ranks
            ranks.append(pickle.load(fh))
    return ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(argv, world, cwd):
    """The launcher on ``world`` ranks as ``torchrun`` starts them; rank
    0's final JSON line."""
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
    return json.loads(outs[0][0].strip().splitlines()[-1])


LAUNCH = ["--smoke", "--arch", JAMBA, "--smoke-mesh", "1,2,2", "--steps",
          "2", "--device", "cpu", "--d-model", str(D), "--seq-len", str(S),
          "--global-batch", "4", "--log-every", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, then the two worlds and the launcher on
    4 ranks; the port's stacked runs meanwhile."""
    tmp = tmp_path_factory.mktemp("moe_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_out = tmp / "ref.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(ref_out),
         *map(str, (D, B, S, PROMPT, MAX_SEQ, NEW))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    res = {}
    try:
        res["launch_ranks"] = _torchrun(LAUNCH, 4, tmp)
        torch.set_num_threads(1)
        cfg = _cfg(JAMBA, "fsdp")
        for tag, packed in (("leaf", False), ("packed", True)):
            tr = _trainer(cfg, plan("fsdp"), None, packed)
            res[f"stacked/{tag}/loss"] = _run3(tr)
            res[f"stacked/{tag}/params"] = _whole(tr.bundle,
                                                  tr.state["params"])
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_OK" in log, log[-3000:]
    with open(ref_out, "rb") as fh:  # written by the subprocess above
        res["ref"] = pickle.load(fh)
    res["fsdp"] = _spawn(tmp, "fsdp", ["step1", "train", "serve"],
                         ref=str(ref_out))
    res["replica"] = _spawn(tmp, "replica", ["step1"], ref=str(ref_out))
    return res


# ------------------------------------------------------------------ tests

def _ref_grads(ref):
    from repro_torch.checkpoint import params_from_numpy
    return _np(params_from_numpy(ref["grads"], device="cpu"))


def test_the_reference_takes_its_manual_path(runs):
    """The reference's loss, prefill and decode under the plan each reach
    ``_expert_compute_manual`` (one trace each)."""
    for world in WORLDS:
        assert runs["ref"][world]["manual_calls"] == 3


@pytest.mark.parametrize("world,path", [("fsdp", "leaf"),
                                        ("fsdp", "packed"),
                                        ("replica", "leaf")])
def test_first_step_matches_the_references_manual_path(runs, world, path):
    """Reduced fp32 jamba on (1, 2, 2) fsdp (per-leaf and packed) and
    kimi-k2 on the (2, 2) replica plan (per-leaf): every rank's first-step
    loss and the replica's gradients it computed, against the reference's
    ``make_loss_fn`` value and gradient under the plan, within 2e-4; each
    rank's FFN ran its ``E / M`` experts only."""
    ref = runs["ref"][world]
    want = _ref_grads(ref)
    moes = [b.moe for b in _cfg(*WORLDS[world]).blocks if b.moe is not None]
    for r in runs[world]:
        assert abs(r[f"step1/{path}/loss"] - ref["loss"]) <= 2e-4 * ref["loss"]
        got = r[f"step1/{path}/grads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4,
                                       atol=2e-4 * np.abs(w).max())
        assert r[f"step1/{path}/widths"] == [
            m.n_experts // len(r["model_ranks"]) for m in moes]


def test_per_leaf_experts_gather_over_the_batch_group_only(runs):
    """One per-leaf step on (1, 2, 2) fsdp: each expert leaf is one
    all-gather over the batch group of its padded piece, every other leaf
    one over the in-replica group; the model group carries one partial
    sum forward and one gradient sum backward."""
    from repro_torch.train.step import expert_dims
    cfg = _cfg(JAMBA, "fsdp")
    dims = plan("fsdp").expert_dims(_specs(cfg))
    assert expert_dims(cfg, plan("fsdp"), None) is None
    n_exp = sum(d is not None for d in dims)
    assert n_exp == 3
    for r in runs["fsdp"]:
        gathers = r["step1/leaf/gathers"]
        params = gathers[:len(dims)]
        assert [g for g, _ in params] == [
            "inner" if d is None else "batch" for d in dims]
        assert [n for _, n in params] == r["piece_bytes"]
        rest = [g for g, _ in gathers[len(dims):]]
        assert rest.count("model") == 2 and rest.count("inner") == 0
        assert rest.count("batch") == 0


@pytest.mark.parametrize("path", ["leaf", "packed"])
def test_trajectories_match_the_stacked_run(runs, path):
    """3 steps of every rank against the port's stacked run of the plan
    (the auto path on whole experts): losses and the gathered params
    within 2e-4."""
    for r in runs["fsdp"]:
        np.testing.assert_allclose(r[f"{path}/loss"],
                                   runs[f"stacked/{path}/loss"], **TOL)
        for g, w in zip(r[f"{path}/params"], runs[f"stacked/{path}/params"]):
            np.testing.assert_allclose(g, w, **TOL)


def test_remat_replays_the_partial_sum_bit_for_bit(runs):
    """Remat on (and with ``save_moe_combine``) equals remat off bit for
    bit; a step's model-group collectives: off 1 partial sum and 1
    gradient sum, on 2 and 1 (the recompute replays the partial sum),
    ``save_moe_combine`` too (saving the combine does not spare the
    replay: the sum's inputs are recomputed before it)."""
    for r in runs["fsdp"]:
        for tag in ("remat", "save"):
            assert r[f"{tag}/loss"] == r["leaf/loss"]
            for a, b in zip(r[f"{tag}/pieces"], r["leaf/pieces"]):
                assert np.array_equal(a, b)
        assert r["leaf/collectives"] == {"partial_sum": 1, "grad_sum": 1}
        assert r["packed/collectives"] == {"partial_sum": 1, "grad_sum": 1}
        assert r["remat/collectives"] == {"partial_sum": 2, "grad_sum": 1}
        assert r["save/collectives"] == {"partial_sum": 2, "grad_sum": 1}


def test_serving_over_the_ranks(runs):
    """(1, 2, 2) fsdp: each rank's serving weights hold its ``E / M``
    experts; prefill and decode logits of the global batch on every rank
    against the reference's under the plan within 2e-4; the engine's
    greedy tokens equal the one-process engine's on the same weights; a
    batch that does not split over the batch group (3 rows) is served over
    the sequence-parallel cache, its logits within 2e-4 of the one-process
    port's."""
    from repro_torch.checkpoint import params_from_numpy
    from repro_torch.models import lm_cache_init, lm_decode, lm_prefill
    from repro_torch.serve import ServingEngine
    cfg = _cfg(JAMBA, "fsdp")
    ref = runs["ref"]["fsdp"]
    params = params_from_numpy(ref["init"], device="cpu")
    one = ServingEngine(cfg, params, MAX_SEQ, device="cpu").generate(
        ref["tokens"][:, :PROMPT], NEW + 2)
    toks = torch.from_numpy(ref["tokens"][:3].astype(np.int64))
    with torch.inference_mode():
        logits, cache = lm_prefill(params, cfg, toks[:, :PROMPT],
                                   lm_cache_init(cfg, 3, MAX_SEQ,
                                                 device="cpu"))
        rows3 = [logits.numpy().copy()]
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = lm_decode(params, cfg, toks[:, t], cache,
                                      torch.tensor(t))
            rows3.append(logits.numpy().copy())
    E = cfg.blocks[1].moe.n_experts
    for r in runs["fsdp"]:
        assert {s[1] for s in r["serve/expert_shapes"]} == {E // 2}
        assert len(r["serve/logits"]) == len(ref["served"]) == NEW + 1
        for g, w in zip(r["serve/logits"], ref["served"]):
            assert g.shape == (B, cfg.vocab)
            np.testing.assert_allclose(g, w, **TOL)
        assert np.array_equal(r["serve/tokens"], one)
        assert len(r["serve/rows3"]) == len(rows3)
        for g, w in zip(r["serve/rows3"], rows3):
            assert g.shape == (3, cfg.vocab)
            np.testing.assert_allclose(g, w, **TOL)


def test_launcher_on_four_ranks_matches_one_process(runs, capsys):
    """``--smoke --arch jamba-v0.1-52b --smoke-mesh 1,2,2`` (the reduced
    model's replica plan: dp 2, the model axis splitting the experts) on 4
    ranks against the same launcher in one process, within 2e-4."""
    from repro_torch.launch.train import main
    main(LAUNCH)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = runs["launch_ranks"]
    assert got["num_shards"] == 2 and want["num_shards"] == 1
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key


@pytest.mark.parametrize("shape,mode", MESHES)
def test_model_and_batch_groups_tile_every_replica(shape, mode):
    """Every rank's model group and batch group meet in the rank alone,
    and the model groups (as the batch groups) of a replica partition it:
    together they tile the replica once."""
    from repro_torch.core.replica_group import mesh_tables
    t = mesh_tables(plan(mode, shape))
    for q in range(t.dp):
        inner = set(t.inner_ranks(int(t.rank_of[q, 0])))
        models = {t.model_ranks(r) for r in inner}
        batches = {t.batch_ranks(r) for r in inner}
        assert sorted(r for g in models for r in g) == sorted(inner)
        assert sorted(r for g in batches for r in g) == sorted(inner)
        assert len(models) * len(batches) == len(inner)
        for r in inner:
            assert set(t.model_ranks(r)) & set(t.batch_ranks(r)) == {r}
            assert t.model_ranks(r) == tuple(sorted(t.model_ranks(r)))
