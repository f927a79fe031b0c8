"""The per-leaf engines and the launcher's default path in the port, against
the reference.

* ``make_gossip_mix`` (static and dynamic phases, alpha 0.5 and 0.25, the
  default mix and ``mix_impl=gossip_mix_1d``) against the reference's
  ``gossip_mix_sim`` (alpha 0.5) and ``gossip_mix_sim_delayed`` fed the
  gathered partner (alpha 0.25: the same expression), bit for bit in fp32
  over period + 2 phases; at p = 8 every phase, per-leaf == packed ==
  oracle bit for bit (tests/test_buckets.py:318), and in bf16 the per-leaf
  mix equals the reference's ``make_gossip_mix`` under ``shard_map`` (a
  subprocess with 8 forced host devices) bit for bit.
* ``make_async_gossip_mix`` against ``gossip_mix_sim_delayed_k`` bit for
  bit: params, every slot and ``valid``, k in {1, 2, 4}, drops on and off
  with a drop on a replica other than 0, default mix and the kernel's
  plain version under ``mix_impl`` (per-row alpha).
* The per-leaf trainer at dp = 4 (sync ``gossip``, ``agd``,
  ``every_logp``, ``gossip_async`` k 2 drop 0.2) against the reference's
  per-leaf trainer (a subprocess with 4 forced host devices), and the
  async one against the reference's ``make_async_sim_train_step`` too,
  within rtol = atol = 2e-4; per-leaf async == packed ``fused_update=False``
  in the port bit for bit.
* packed == leaf at dp = 1 bit for bit (tests/test_buckets.py:113).
* The launcher without ``--packed`` against the reference launcher's
  losses within 1e-4; the refusals; packed <-> leaf checkpoints in both
  directions and across the two packages.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simulate as R  # noqa: E402
from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.async_gossip import init_inbox_ring as ref_init_ring  # noqa: E402
from repro_torch.checkpoint import (array_to_torch,  # noqa: E402
                                    params_from_numpy, restore_state,
                                    save_state)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PackedParams, build_layout,  # noqa: E402
                              build_schedule, make_packed_gossip_mix,
                              make_protocol)
from repro_torch.core.async_gossip import (init_inbox_ring,  # noqa: E402
                                           make_async_gossip_mix)
from repro_torch.core.gossip import linear_pairs, make_gossip_mix  # noqa: E402
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.kernels import gossip_mix, gossip_mix_1d  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import sgd, step_decay  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DP, P8 = 4, 8
D_MODEL, SEQ, GLOBAL_B, STEPS, LR, EVERY = 32, 16, 8, 4, 0.3, 2
K, DROP = 2, 0.2
TOL = dict(rtol=2e-4, atol=2e-4)
PROTOCOLS = ["gossip", "agd", "every_logp", "gossip_async"]


def _t(x):
    return array_to_torch(np.asarray(x), "cpu")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view({2: torch.int16, 4: torch.int32}[x.element_size()]
                      ).numpy()
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _same(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _tree(rng, p, dtype=np.float32):
    return {"w1": rng.normal(size=(p, 5, 3)).astype(dtype),
            "w2": rng.normal(size=(p, 130)).astype(dtype),
            "w3": rng.normal(size=(p, 2, 7, 11)).astype(dtype)}


# ------------------------------------------------------ the sync engine

@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("alpha", [0.5, 0.25])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_gossip_mix_matches_the_oracle(mode, alpha, impl):
    rng = np.random.default_rng(0)
    sched = build_schedule(DP, num_rotations=2, seed=3)
    tree = _tree(rng, DP)
    got = tree_map(_t, tree)
    want = jax.tree.map(jnp.asarray, tree)
    mix = make_gossip_mix(sched, alpha=alpha, mode=mode,
                          mix_impl=gossip_mix_1d if impl else None)
    launches = gossip_mix.launches.count
    for t in range(sched.period + 2):
        ph = t if mode == "static" else torch.tensor(t, dtype=torch.int32)
        out = mix(got, ph)
        assert out is got   # in place on the leaves
        rf = jnp.asarray(sched.recv_from(t))
        if alpha == 0.5:
            want = R.gossip_mix_sim(want, rf)
        else:
            want, _ = R.gossip_mix_sim_delayed(
                want, jax.tree.map(lambda x: x[rf], want), rf, alpha)
        _same(got, want)
    # the plain version on CPU tensors: no kernel launch is counted
    assert gossip_mix.launches.count == launches


def test_gossip_mix_modes_and_pairs():
    sched = build_schedule(DP, seed=1)
    with pytest.raises(ValueError, match="mode"):
        make_gossip_mix(sched, mode="packed")
    mix = make_gossip_mix(sched)
    x = {"w": torch.zeros(DP, 3)}
    with pytest.raises(TypeError, match="static"):
        mix(x, torch.tensor(0))
    with pytest.raises(ValueError, match="dp=2"):
        mix({"w": torch.zeros(2, 3)}, 0)
    from repro.core.gossip import linear_pairs as ref_linear_pairs
    from repro.core.topology import build_schedule as ref_build_schedule
    ref = ref_build_schedule(DP, seed=1)
    for t in range(sched.period):
        assert linear_pairs(sched, t) == ref_linear_pairs(ref, t)


def test_packed_equals_leaf_all_phases():
    """p = 8, every phase: the packed engine, the per-leaf engine and the
    oracle bit for bit in fp32 (tests/test_buckets.py:318)."""
    rng = np.random.default_rng(2)
    sched = build_schedule(P8, num_rotations=2, seed=11)
    tree = _tree(rng, P8)
    layout = build_layout(tree, skip_leading=1)
    packed = PackedParams.pack(tree_map(_t, tree), layout)
    leaf = tree_map(_t, tree)
    want = jax.tree.map(jnp.asarray, tree)
    pmix, lmix = make_packed_gossip_mix(sched, layout), make_gossip_mix(sched)
    for t in range(sched.period):
        pmix(packed, t)
        lmix(leaf, t)
        want = R.gossip_mix_sim(want, jnp.asarray(sched.recv_from(t)))
        _same(packed.unpack(), want)
        _same(leaf, want)


_BF16_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import repro
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import build_schedule, make_gossip_mix
tree, alphas = pickle.load(open(sys.argv[1], "rb"))
mesh = jax.make_mesh((8,), ("data",))
sched = build_schedule(8, num_rotations=2, seed=11)
specs = jax.tree.map(lambda x: P("data", *([None] * (x.ndim - 1))), tree)
out = {}
for alpha in alphas:
    # dynamic mode: one compiled switch over the phases, the same mix
    mix = jax.jit(make_gossip_mix(mesh, ("data",), sched, specs,
                                  alpha=alpha, mode="dynamic"))
    got = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)
    steps = []
    for t in range(sched.period):
        got = mix(got, jnp.int32(t))
        steps.append(jax.tree.map(lambda x: np.asarray(x).view(np.int16), got))
    out[alpha] = steps
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_bf16_leaf_mix_is_the_references(tmp_path):
    """The default mix in bf16, op by op in the leaf's dtype with the
    coefficients rounded to bf16, equals the reference's ``_mix_leaf``
    under shard_map bit for bit (alpha 0.5, 0.25 and 0.3); the kernel
    mixes in fp32 and rounds once (another function in bf16)."""
    rng = np.random.default_rng(3)
    tree = _tree(rng, P8)
    alphas = (0.5, 0.25, 0.3)
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    src.write_bytes(pickle.dumps((tree, alphas)))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _BF16_SCRIPT, str(src),
                        str(dst)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ref = pickle.loads(dst.read_bytes())
    sched = build_schedule(P8, num_rotations=2, seed=11)
    for alpha in alphas:
        got = tree_map(lambda x: _t(x).to(torch.bfloat16), tree)
        mix = make_gossip_mix(sched, alpha=alpha)
        for t in range(sched.period):
            mix(got, t)
            for k in sorted(tree):
                np.testing.assert_array_equal(
                    got[k].view(torch.int16).numpy(), ref[alpha][t][k])


# ------------------------------------------------------ the async engine

@pytest.mark.parametrize("impl", [None, "kernel"])
@pytest.mark.parametrize("drop", [0.0, 0.3], ids=["nodrop", "drop30"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_async_gossip_mix_matches_delayed_k(k, drop, impl):
    """Params, every slot and ``valid`` bit for bit over a period plus the
    bootstrap. With drops, some replica other than 0 misses an exchange
    that replica 0 receives, so a scalar alpha for every row would show."""
    rng = np.random.default_rng(10 + k)
    sched = build_schedule(P8, seed=5)
    tree = _tree(rng, P8)
    got = tree_map(_t, tree)
    want = jax.tree.map(jnp.asarray, tree)
    ring = init_inbox_ring(got, k, P8)
    wring = ref_init_ring(want, k, P8)
    mix = make_async_gossip_mix(sched, alpha=0.5, staleness=k,
                                drop_rate=drop, drop_seed=3,
                                mix_impl=gossip_mix_1d if impl else None)
    split = False
    for t in range(sched.period + k):
        valid = ring["valid"][:, 0]
        split |= bool(valid[0] == 1 and (valid[1:] == 0).any())
        got, ring = mix(got, ring, t)
        ok = ref_exchange_ok(wring["t"], jnp.arange(P8), 3, drop)
        want, wring = R.gossip_mix_sim_delayed_k(
            want, wring, jnp.asarray(sched.recv_from(t)), 0.5, ok)
        _same(got, want)
        for gs, ws in zip(ring["slots"], wring["slots"]):
            _same(gs, ws)
        np.testing.assert_array_equal(ring["valid"], np.asarray(wring["valid"]))
        assert ring["t"] == int(wring["t"]) == t + 1
    assert split == bool(drop), "no drop on a replica other than 0"


def test_async_engine_refuses_a_ring_of_another_depth():
    sched = build_schedule(DP, seed=0)
    x = {"w": torch.zeros(DP, 4)}
    mix = make_async_gossip_mix(sched, staleness=2)
    with pytest.raises(ValueError, match="staleness 2"):
        mix(x, init_inbox_ring(x, 1, DP), 0)
    with pytest.raises(ValueError, match="staleness"):
        make_async_gossip_mix(sched, staleness=0)


# ------------------------------------------- trainers and the launcher

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={dp}"
import repro
import dataclasses, io, contextlib, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import build_schedule, make_async_sim_train_step
from repro.core.async_gossip import init_inbox_ring
from repro.data import ShardedTokenDataset, make_replica_batches
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)
from repro.train.loss import make_loss_fn
import repro.launch.train as L

OUT, CKPT = sys.argv[1], sys.argv[2]
cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh({dp}, 1), "replica")
opt = sgd(step_decay({lr}, 0.1, {every}), momentum=0.9)
ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}}
ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards={dp},
                         batch_per_shard={gb} // {dp}, seed=0)
for proto in {protocols}:
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol=proto, staleness={k}, drop_rate={drop}, remat=False,
        gossip_packed=False)
    assert not bundle.fused and bundle.layout is None
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                inbox=bundle.protocol.staleness)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run({steps})
    out[proto] = {{"loss": [h["loss"] for h in hist],
                   "params": jax.tree.map(np.asarray, tr.state["params"]),
                   "mom": jax.tree.map(np.asarray, tr.state["opt"]["mom"])}}
    if "inbox" in tr.state:
        out[proto]["valid"] = np.asarray(tr.state["inbox"]["valid"])

# the async simulator as a second oracle of the per-leaf async trainer
loss_fn = make_loss_fn(cfg)
step = make_async_sim_train_step(lambda p, b: loss_fn(p, b)[0], opt,
                                 build_schedule({dp}), staleness={k},
                                 drop_rate={drop})
params = jax.tree.map(lambda x: jnp.broadcast_to(x, ({dp},) + x.shape),
                      lm_init(jax.random.key(0), cfg)[0])
st, ring, losses = opt.init(params), init_inbox_ring(params, {k}, {dp}), []
for t in range({steps}):
    batch = jax.tree.map(jnp.asarray, make_replica_batches(ds, t, {dp}))
    st, params, ring, m = step(st, params, ring, batch, jnp.int32(t))
    losses.append(float(m["loss"]))
out["sim_async"] = {{"loss": losses,
                     "params": jax.tree.map(np.asarray, params)}}

# the launcher's default path (per-leaf), as a user runs it: a straight
# run, and a half run that writes its checkpoint for the port to resume
for proto in ("gossip", "gossip_async"):
    for steps, extra in (({steps}, []),
                         ({steps} // 2, ["--checkpoint",
                                         os.path.join(CKPT, proto)])):
        sys.argv = ["train", "--smoke", "--smoke-mesh", "1,{dp},1", "--steps",
                    str(steps), "--protocol", proto, "--staleness", "{k}",
                    "--drop-timeout", "{drop}", "--d-model", "{d}",
                    "--seq-len", "{seq}", "--global-batch", "{gb}",
                    "--log-every", "0"] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            L.main()
        out["launcher", proto, steps] = json.loads(
            [ln for ln in buf.getvalue().splitlines() if ln.startswith("{{")][-1])
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


def _cfg():
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=D_MODEL),
                               param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref")
    out = base / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(dp=DP, d=D_MODEL, lr=LR, every=EVERY, seq=SEQ,
                               gb=GLOBAL_B, steps=STEPS, k=K, drop=DROP,
                               protocols=tuple(PROTOCOLS))
    r = subprocess.run([sys.executable, "-c", script, str(out), str(base)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(out, "rb") as f:  # written by the subprocess above
        ref = pickle.load(f)
    ref["ckpt"] = base
    return ref


def _port_run(init_tree, protocol, *, packed=False, fused=None, dp=DP,
              steps=STEPS, opt=None):
    cfg = _cfg()
    opt = opt or sgd(step_decay(LR, 0.1, EVERY), momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=dp, protocol=protocol,
                                    staleness=K, drop_rate=DROP,
                                    gossip_packed=packed, fused_update=fused,
                                    device="cpu")
    params = params_from_numpy(init_tree, device="cpu")
    state = init_train_state(cfg, opt, dp=dp, packed=packed,
                             layout=bundle.layout, params=params,
                             device="cpu", inbox=bundle.protocol.staleness,
                             wire=bundle.wire)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=dp,
                             batch_per_shard=GLOBAL_B // dp, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(steps)
    return [h["loss"] for h in hist], tr.state, bundle


def _close(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_dp4_leaf_trajectory_matches_reference(reference, protocol):
    want = reference[protocol]
    losses, state, bundle = _port_run(reference["init"], protocol)
    assert bundle.layout is None and not bundle.fused
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    _close(state["params"], want["params"])
    _close(state["opt"]["mom"], want["mom"])
    if "valid" in want:
        np.testing.assert_array_equal(state["inbox"]["valid"], want["valid"])
        assert not want["valid"].all()   # the drops landed


def test_dp4_leaf_async_matches_the_async_simulator(reference):
    want = reference["sim_async"]
    losses, state, _ = _port_run(reference["init"], "gossip_async")
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    _close(state["params"], want["params"])


@pytest.fixture
def deterministic():
    """The CPU embedding gather's backward (``index_put_`` with accumulate)
    adds in parallel in no fixed order unless deterministic algorithms are
    on, so two runs of one program may differ in the last bit."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_leaf_async_equals_packed_unfused_bit_for_bit(reference,
                                                      deterministic):
    """The per-leaf ring and the packed unfused ring (fp32 wire) run the
    same arithmetic on the same values."""
    la, sa, _ = _port_run(reference["init"], "gossip_async")
    lb, sb, _ = _port_run(reference["init"], "gossip_async", packed=True,
                          fused=False)
    assert la == lb
    _same(sa["params"], jax.tree.map(np.asarray, tree_map(
        lambda x: x.detach(), sb["params"].unpack())))
    np.testing.assert_array_equal(sa["inbox"]["valid"], sb["inbox"]["valid"])


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "unfused"])
def test_packed_equals_leaf_at_dp1(reference, fused, deterministic):
    """dp = 1: the packed state must not change the math, losses and params
    bit for bit (tests/test_buckets.py:113 holds it to 2e-4; the port
    reaches equality)."""
    la, sa, bl = _port_run(reference["init"], "gossip", dp=1, steps=5)
    lp, sp, bp = _port_run(reference["init"], "gossip", packed=True,
                           fused=fused, dp=1, steps=5)
    assert bp.fused == (fused is None) and not bl.fused
    assert la == lp
    _same(sa["params"], jax.tree.map(np.asarray, tree_map(
        lambda x: x.detach(), sp["params"].unpack())))


@pytest.mark.parametrize("protocol", ["gossip", "gossip_async"])
def test_launcher_default_path_matches_reference_launcher(reference, capsys,
                                                          protocol):
    """The reference launcher's per-leaf run writes its state at step 2;
    the port's launcher, without ``--packed``, resumes it (per-leaf params,
    momenta and, for gossip_async, the ring) and runs to step 4: its last
    loss is the reference launcher's straight 4-step run's within 1e-4.
    (torch cannot replay jax.random, so the shared state is the
    reference's; the learning rate's decay period, ``--steps // 3``, is 1
    in both runs.)"""
    from repro_torch.launch.train import main
    half = STEPS // 2
    main(["--smoke", "--smoke-mesh", f"1,{DP},1", "--steps", str(half),
          "--protocol", protocol, "--staleness", str(K), "--drop-timeout",
          str(DROP), "--d-model", str(D_MODEL), "--seq-len", str(SEQ),
          "--global-batch", str(GLOBAL_B), "--log-every", "0", "--device",
          "cpu", "--checkpoint", str(reference["ckpt"] / protocol),
          "--resume"])
    out = capsys.readouterr().out
    assert f"at step {half}" in out
    got = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    want = reference["launcher", protocol, STEPS]
    assert got["packed"] is False and got["fused"] is False
    assert got["start_step"] == half
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-4, \
        (got["final_loss"], want["final_loss"])
    # the reference's half run saw the same first steps as its straight run
    assert reference["launcher", protocol, half]["first_loss"] == \
        want["first_loss"]


def test_refusals():
    cfg, opt = _cfg(), sgd(0.1)
    with pytest.raises(ValueError, match="gossip_packed"):
        make_train_step_bundle(cfg, opt, dp=DP, wire_dtype="int8",
                               device="cpu")
    with pytest.raises(ValueError, match="gossip_packed"):
        make_train_step_bundle(cfg, opt, dp=DP, gossip_subset=0.5,
                               protocol="gossip_async", device="cpu")
    with pytest.raises(ValueError, match="gossip_packed"):
        make_train_step_bundle(cfg, opt, dp=DP, fused_update=True,
                               device="cpu")
    with pytest.raises(ValueError, match="mix_impl"):
        make_train_step_bundle(cfg, opt, dp=DP, gossip_packed=True,
                               mix_impl=gossip_mix_1d, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        make_protocol("gossip", DP, wire_dtype="fp8")
    # fused_update=None means "on only when packed" (the reference's rule)
    assert not make_train_step_bundle(cfg, opt, dp=DP, device="cpu").fused
    assert make_train_step_bundle(cfg, opt, dp=DP, gossip_packed=True,
                                  device="cpu").fused
    # the compressed wire is refused by the launcher without --packed
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="gossip_packed"):
        main(["--smoke", "--smoke-mesh", "1,2,1", "--wire-dtype", "int8",
              "--device", "cpu"])


def test_step_rotates_the_batch_only_when_asked():
    """The step ring-shuffles the batch (replica j gets replica j-1's shard)
    unless ``rotate=False``; the Trainer, which draws every batch afresh,
    asks for no shuffle."""
    cfg, opt = _cfg(), sgd(0.1)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, device="cpu")
    state = init_train_state(cfg, opt, dp=DP, device="cpu")
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=DP,
                             batch_per_shard=GLOBAL_B // DP, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    batch = tr._batch(0)
    state, nb, _ = bundle.step(state, batch, 0)
    np.testing.assert_array_equal(nb["tokens"].numpy(),
                                  np.roll(batch["tokens"].numpy(), 1, 0))
    _, same, _ = bundle.step(state, batch, 1, rotate=False)
    assert same is batch
    seen = []
    step_fn = bundle.step_fn
    bundle.step_fn = lambda *a: seen.append(a[-1]) or step_fn(*a)
    tr.run(2)
    assert seen == [False, False]


# -------------------------------------------------------- checkpoints

def _state(init_tree, packed, protocol="gossip_async"):
    cfg, opt = _cfg(), sgd(0.1, momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, protocol=protocol,
                                    staleness=K, gossip_packed=packed,
                                    fused_update=False, device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=packed,
                             layout=bundle.layout,
                             params=params_from_numpy(init_tree,
                                                      device="cpu"),
                             device="cpu", inbox=bundle.protocol.staleness)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=DP,
                             batch_per_shard=GLOBAL_B // DP, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    tr.run(3)
    return tr.state, bundle


def _leafy(node):
    """Every tensor of a state as leaf-keyed numpy, ``PackedParams`` through
    its leaf view (the checkpoint's own keys)."""
    from repro_torch.checkpoint.io import _leaves
    from repro_torch.tree import keystr
    return {keystr(p): (v.detach().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v)) for p, v in _leaves(node, ())}


@pytest.mark.parametrize("src,dst", [("leaf", "packed"), ("packed", "leaf")])
def test_checkpoint_packed_and_leaf_cross_restore(reference, tmp_path, src,
                                                  dst):
    """A per-leaf async state (tree ring slots) and a packed one (fp32
    ring: ``PackedParams`` slots) write the same keys; each restores into
    the other's template bit for bit, autograd leaves kept."""
    state, _ = _state(reference["init"], src == "packed")
    template, _ = _state(reference["init"], dst == "packed")
    save_state(str(tmp_path / "ck"), state, step=3)
    restored, man = restore_state(str(tmp_path / "ck"), template)
    assert man["step"] == 3
    assert isinstance(restored["params"], PackedParams) == (dst == "packed")
    got, want = _leafy(restored), _leafy(state)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    leaves = (restored["params"].buckets if dst == "packed"
              else tree_flatten(restored["params"])[0])
    assert all(x.requires_grad for x in leaves)


_REF_CKPT = r"""
import os, pickle, sys
import repro
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import restore_state, save_state
from repro.core.async_gossip import init_inbox_ring
from repro.core.buckets import PackedParams, build_layout
mode, path, out = sys.argv[1], sys.argv[2], sys.argv[3]
tree = pickle.load(open(out + ".in", "rb"))
params = jax.tree.map(jnp.asarray, tree)
if mode == "packed":
    params = PackedParams.pack(params, build_layout(params, skip_leading=1))
state = {{"params": params, "opt": {{"step": jnp.int32(0),
          "mom": jax.tree.map(jnp.zeros_like, params)}},
          "inbox": init_inbox_ring(params, {k}, {dp})}}
if os.path.exists(os.path.join(path, "manifest.json")):
    state, man = restore_state(path, state)
    flat = {{jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda x: x, state["params"].unpack()
                             if mode == "packed" else state["params"]))[0]}}
    pickle.dump((flat, np.asarray(state["inbox"]["valid"]),
                 int(state["inbox"]["t"]), int(man["step"])),
                open(out, "wb"))
else:
    state["inbox"]["valid"] = jnp.ones(({dp}, {k}), jnp.float32)
    save_state(path, state, step=5)
"""


@pytest.mark.parametrize("ref_mode", ["leaf", "packed"])
def test_checkpoint_leaf_state_across_the_packages(reference, tmp_path,
                                                   ref_mode):
    """The port's per-leaf async state restores in the reference (per-leaf
    and packed templates) bit for bit, and the reference's file restores
    into the port's per-leaf template."""
    state, _ = _state(reference["init"], False)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REF_CKPT.format(k=K, dp=DP)
    out = tmp_path / "out.pkl"
    stacked = tree_map(lambda x: x.detach().numpy(), state["params"])
    (tmp_path / "out.pkl.in").write_bytes(pickle.dumps(stacked))
    # port -> reference
    save_state(str(tmp_path / "port"), state, step=3)
    r = subprocess.run([sys.executable, "-c", script, ref_mode,
                        str(tmp_path / "port"), str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    flat, valid, t, step = pickle.loads(out.read_bytes())
    want = _leafy(state["params"])
    assert sorted(flat) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(flat[key], want[key])
    np.testing.assert_array_equal(valid, state["inbox"]["valid"])
    assert (t, step) == (state["inbox"]["t"], 3)
    # reference -> port
    r = subprocess.run([sys.executable, "-c", script, ref_mode,
                        str(tmp_path / "ref"), str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    template, _ = _state(reference["init"], False)
    restored, man = restore_state(str(tmp_path / "ref"), template)
    assert man["step"] == 5 and restored["inbox"]["valid"].all()
    for key, v in _leafy(restored["params"]).items():
        np.testing.assert_array_equal(v, want[key])
    for slot in restored["inbox"]["slots"]:
        for key, v in _leafy(slot).items():
            np.testing.assert_array_equal(v, want[key])


@pytest.mark.parametrize("name", ["sgd", "adamw", "lars"])
def test_tree_optimizers_match_packed_and_reference(name):
    """The tree-level updates on a per-leaf state: bit-equal to the same
    update on the packed state (tests/test_buckets.py's lars case, for all
    three), and to the reference's per-leaf update within 2e-6 (LARS's
    norm spans the stacked leaf, replica axis included, in both
    packages)."""
    from repro import optim as ref_optim
    from repro_torch import optim
    kw = {"sgd": dict(momentum=0.9, weight_decay=1e-4),
          "adamw": dict(weight_decay=0.02),
          "lars": dict(momentum=0.9, weight_decay=1e-4)}[name]
    opt, ref = getattr(optim, name)(0.1, **kw), getattr(ref_optim, name)(
        0.1, **kw)
    rng = np.random.default_rng(9)
    tree = _tree(rng, DP)
    grads = {k: (0.1 * v + 0.01).astype(np.float32) for k, v in tree.items()}
    layout = build_layout(tree, skip_leading=1)
    leaf, packed = tree_map(_t, tree), PackedParams.pack(tree_map(_t, tree),
                                                         layout)
    g_leaf = tree_map(_t, grads)
    g_packed = PackedParams.pack(tree_map(_t, grads), layout)
    rp, rg = jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, grads)
    st_l, st_p, st_r = opt.init(leaf), opt.init(packed), ref.init(rp)
    for _ in range(3):
        leaf, st_l = opt.update(leaf, g_leaf, st_l)
        packed, st_p = opt.update(packed, g_packed, st_p)
        rp, st_r = ref.update(rp, rg, st_r)
    _same(leaf, jax.tree.map(np.asarray, tree_map(lambda x: x.detach(),
                                                  packed.unpack())))
    for k in tree:
        np.testing.assert_allclose(leaf[k].numpy(), np.asarray(rp[k]),
                                   rtol=2e-6, atol=1e-7)
