"""The port's bounded-delay ``gossip_async`` ring against the reference.

* Unfused engine (``make_packed_async_gossip_mix``) against the oracles
  ``gossip_mix_sim_quantized_k`` (int8 / fp8 / bf16 wires) and
  ``gossip_mix_sim_delayed_k`` (the default wire); fused engine
  (``make_packed_fused_async_update``) against the reference's encode +
  exchange + ``fused_sgd_ref`` composed per bucket. Every phase of the dp=4
  schedule (the wire's lcm period included) plus the k bootstrap steps,
  k in {1, 2}, drops 0 and 0.3, subsets 1 and 1/3, on 5 buckets. Each step
  starts from the reference's state, so one step's rounding never feeds
  the next; fp32 within 2 ulp of the largest operand, codes and scales of
  the dispatched payloads, landed flags and counters bit-exact.
* The slice as a whole: dp=4 ``gossip_async`` (k 2, drop 0.2) trajectories
  of the port's ``Trainer`` against the reference's trainer (a subprocess
  with four forced host devices) for fp32, int8 with subset 0.5 and fp8
  wires, fused and unfused, 4 steps, both packages forced to 5 buckets by
  wrapping their layout builder. Losses within rtol = atol = 2e-4 (the
  reference's end-to-end tolerance, tests/test_hier_packed.py:417); bucket
  elements too, except where they differ by at most alpha times one code
  step of their tile (a 1-ulp difference in the scaled value can flip one
  stochastic-rounding or round-to-nearest code), and those must be at most
  0.1% of the elements.
"""
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.async_gossip import init_inbox_ring as ref_init_ring  # noqa: E402
from repro.core.async_gossip import \
    init_wire_inbox_ring as ref_init_wire_ring  # noqa: E402
from repro.core.simulate import (gossip_mix_sim_delayed_k,  # noqa: E402
                                 gossip_mix_sim_quantized_k)
from repro.core.topology import build_schedule as ref_build_schedule  # noqa: E402
from repro.core.topology import build_subset_schedule as ref_subset  # noqa: E402
from repro.kernels import quantize as RQ  # noqa: E402
from repro.kernels.fused_update import fused_sgd_ref  # noqa: E402
from repro_torch.checkpoint import array_to_torch, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PackedParams, build_layout,  # noqa: E402
                              build_schedule, make_packed_async_gossip_mix,
                              make_packed_fused_async_update, make_protocol)
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.kernels import quantize as Q  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import sgd, step_decay  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)

ROOT = Path(__file__).resolve().parents[1]
DP, ALPHA, LR, WD = 4, 0.5, np.float32(0.1), 1e-4
TOL = dict(rtol=2e-4, atol=2e-4)
WIRES = [("int8", 1.0), ("int8", 1 / 3), ("fp8", 1.0), ("bf16", 1 / 3),
         ("fp32", 1.0), ("fp32", 1 / 3)]
WIRE_IDS = ["int8", "int8_sub3", "fp8", "bf16_sub3", "fp32", "fp32_sub3"]


def _t(x):
    return array_to_torch(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, operands=()):
    """|got - want| <= 2 ulp of the largest of got, want and the operands."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = np.maximum(np.abs(got), np.abs(want))
    for x in operands:
        scale = np.maximum(scale, np.abs(_f32(x)))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 2 * np.spacing(scale)).all(), \
        float((err / np.spacing(scale)).max())


def _payload_t(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return _t(x)


def _ring_t(ring):
    return {"slots": tuple([_payload_t(p) for p in slot]
                           for slot in ring["slots"]),
            "valid": np.array(ring["valid"], np.float32),
            "t": int(ring["t"])}


def _payload_equal(got, want, sent: bool):
    """The newest ring slot: a payload bit-equal to the reference's, in
    shape and dtype too; an unsent one is the zero payload in both."""
    if not sent:
        for v in jax.tree.leaves(want):
            assert not np.asarray(jnp.asarray(v).astype(jnp.float32)).any()
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert str(g.dtype).rsplit(".", 1)[-1] == str(w.dtype)
    if isinstance(want, dict):
        np.testing.assert_array_equal(_f32(got["q"]), _f32(want["q"]))
        np.testing.assert_array_equal(_f32(got["s"]), _f32(want["s"]))
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _layout():
    tree = {f"w{i}": torch.zeros(n) for i, n in
            enumerate((700, 520, 400, 390, 260, 250, 130, 100))}
    layout = build_layout(tree, target_bucket_bytes=3000)
    assert layout.num_buckets == 5
    return layout


def _rand(rng, layout):
    return [jnp.asarray(rng.normal(size=(DP, n)).astype(np.float32))
            for n in layout.bucket_sizes]


def _setup(wire_dtype, subset, k):
    layout = _layout()
    wire = Q.WireFormat(wire_dtype, subset, seed=2)
    sub = ref_subset(layout.num_buckets, subset)
    eff = 4 if sub is None else 4 * sub.period // np.gcd(4, sub.period)
    return layout, wire, sub, eff, ref_build_schedule(DP)


def _masks(sub, nb, ph, k):
    if sub is None:
        return np.ones(nb, bool), np.ones(nb, bool)
    return sub.selected(ph - k), sub.selected(ph)


# ----------------------------------------------------------- unfused engine

@pytest.mark.parametrize("wire_dtype,subset", WIRES, ids=WIRE_IDS)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_async_mix_matches_oracle_every_phase(wire_dtype, subset, k, drop):
    layout, wire, sub, eff, ref_sched = _setup(wire_dtype, subset, k)
    mix = make_packed_async_gossip_mix(build_schedule(DP), layout, alpha=ALPHA,
                                       staleness=k, drop_rate=drop,
                                       drop_seed=5, wire=wire)
    rng = np.random.default_rng(k)
    xs = _rand(rng, layout)
    ring = (ref_init_ring(xs, k, DP) if wire.is_default else
            ref_init_wire_ring(SimpleNamespace(buckets=xs), k, DP,
                               RQ.WireFormat(wire_dtype, subset, seed=2)))
    for step in range(eff + k):
        ph = step % eff
        recv = jnp.asarray(ref_sched.recv_from(ph))
        ok = ref_exchange_ok(ring["t"], jnp.arange(DP), 5, drop)
        if wire.is_default:
            want, want_ring = gossip_mix_sim_delayed_k(xs, ring, recv,
                                                       alpha=ALPHA, ok=ok)
        else:
            want, want_ring = gossip_mix_sim_quantized_k(
                xs, ring, recv, wire=RQ.WireFormat(wire_dtype, subset, seed=2),
                alpha=ALPHA, ok=ok)
        got, got_ring = mix(PackedParams([_t(x) for x in xs], layout),
                            _ring_t(ring), ph)
        for g, w, x in zip(got.buckets, want, xs):
            _close(g, w, (x,))
        _, sent = _masks(sub, layout.num_buckets, ph, k)
        for i in range(layout.num_buckets):
            _payload_equal(got_ring["slots"][-1][i],
                           want_ring["slots"][-1][i], sent[i])
        np.testing.assert_array_equal(got_ring["valid"],
                                      np.asarray(want_ring["valid"]))
        assert got_ring["t"] == int(want_ring["t"]) == step + 1
        # next step: the reference's state, perturbed as an update would
        xs = [w + jnp.asarray(rng.normal(size=w.shape).astype(np.float32))
              * 0.1 for w in want]
        ring = want_ring


# ----------------------------------------------------------- fused engine

def _fused_reference(ps, gs, ms, ring, recv, ph, k, wire_dtype, sub, ok):
    """Per bucket: the RAW bucket encoded on the ring counter and
    exchanged; the fused SGD sweep against the oldest slot at the masked
    alpha (per row), or the local update outside the consumed subset."""
    a = (ALPHA * ring["valid"][:, 0])[:, None]
    cons, sent = _masks(sub, len(ps), ph, k)
    new_p, new_m, outbox = [], [], []
    for i, (p, g, m) in enumerate(zip(ps, gs, ms)):
        if wire_dtype is None:
            outbox.append(p[recv])
        elif sent[i]:
            enc = RQ.encode_wire(p, wire_dtype, keys=RQ.wire_key(
                ring["t"], jnp.arange(DP), i, 2))
            outbox.append(jax.tree.map(lambda e: e[recv], enc))
        else:
            outbox.append(RQ.zero_payload_like(p, wire_dtype))
        partner = RQ.decode_wire(ring["slots"][0][i]) if cons[i] else None
        np_, nm = fused_sgd_ref(p, g, partner, m, lr=jnp.float32(LR),
                                alpha=a if cons[i] else 0.0, momentum=0.9,
                                weight_decay=WD)
        new_p.append(np_)
        new_m.append(nm)
    ring = {"slots": tuple(ring["slots"][1:]) + (tuple(outbox),),
            "valid": jnp.concatenate([ring["valid"][:, 1:], ok[:, None]], 1),
            "t": ring["t"] + 1}
    return new_p, new_m, ring


@pytest.mark.parametrize("wire_dtype,subset", WIRES, ids=WIRE_IDS)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_fused_async_matches_composed_reference(wire_dtype, subset, k, drop):
    layout, wire, sub, eff, ref_sched = _setup(wire_dtype, subset, k)
    update = make_packed_fused_async_update(
        build_schedule(DP), layout, sgd(float(LR), momentum=0.9,
                                        weight_decay=WD),
        alpha=ALPHA, staleness=k, drop_rate=drop, drop_seed=5, wire=wire)
    rng = np.random.default_rng(10 + k)
    ps = _rand(rng, layout)
    ring = (ref_init_ring(ps, k, DP) if wire.is_default else
            ref_init_wire_ring(SimpleNamespace(buckets=ps), k, DP,
                               RQ.WireFormat(wire_dtype, subset, seed=2)))
    ms = [x * 0.1 for x in _rand(rng, layout)]
    for step in range(eff + k):
        ph = step % eff
        gs = _rand(rng, layout)
        recv = jnp.asarray(ref_sched.recv_from(ph))
        ok = ref_exchange_ok(ring["t"], jnp.arange(DP), 5, drop)
        want_p, want_m, want_ring = _fused_reference(
            ps, gs, ms, ring, recv, ph, k,
            None if wire.is_default else wire_dtype, sub, ok)
        params = PackedParams([_t(p) for p in ps], layout)
        state = {"step": 0, "mom": PackedParams([_t(m) for m in ms], layout)}
        got_p, got_s, got_ring = update(
            params, PackedParams([_t(g) for g in gs], layout), _ring_t(ring),
            state, ph)
        for i in range(layout.num_buckets):
            ops = (ps[i], gs[i], ms[i])
            _close(got_p.buckets[i], want_p[i], ops)
            _close(got_s["mom"].buckets[i], want_m[i], ops)
        _, sent = _masks(sub, layout.num_buckets, ph, k)
        for i in range(layout.num_buckets):
            _payload_equal(got_ring["slots"][-1][i],
                           want_ring["slots"][-1][i],
                           sent[i] or wire.is_default)
        np.testing.assert_array_equal(got_ring["valid"],
                                      np.asarray(want_ring["valid"]))
        assert got_ring["t"] == step + 1 and got_s["step"] == 1
        ps, ms, ring = want_p, want_m, want_ring


def test_protocol_async_period_and_refusals():
    layout = _layout()
    p = make_protocol("gossip_async", DP, staleness=2, packed_layout=layout,
                      wire_dtype="int8", gossip_subset=1 / 3)
    assert p.staleness == 2 and p.carries_inbox and p.period == 12
    assert p.wire.dtype == "int8"
    p1 = make_protocol("gossip_async", 1, packed_layout=layout)
    assert p1.staleness == 0 and p1.period == 1
    with pytest.raises(ValueError, match="staleness"):
        make_protocol("gossip_async", DP, staleness=0, packed_layout=layout)
    with pytest.raises(ValueError, match="inbox"):
        p.comm_params(None, 0)
    leaf = make_protocol("gossip_async", DP, staleness=2)  # per-leaf engine
    assert leaf.staleness == 2 and leaf.period == leaf.schedule.period
    with pytest.raises(ValueError, match="packed"):
        make_protocol("gossip_async", DP, wire_dtype="int8")


# ------------------------------------------------------- the slice as a whole

D_MODEL, SEQ, GLOBAL_B, STEPS, LR_T, EVERY = 64, 16, 8, 4, 0.3, 2
K, DROP, BUCKET_BYTES = 2, 0.2, 96 << 10
CASES = [("fp32", 1.0), ("int8", 0.5), ("fp8", 1.0)]

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={dp}"
import repro
import dataclasses, functools
import jax, numpy as np
import repro.train.step as S
from repro.configs import get_config
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

S.build_layout = functools.partial(S.build_layout,
                                   target_bucket_bytes={bucket_bytes})
cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh({dp}, 1), "replica")
opt = sgd(step_decay({lr}, 0.1, {every}), momentum=0.9)
ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}}
for wire, subset in {cases}:
    for fused in (True, False):
        bundle = make_train_step_bundle(
            cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
            protocol="gossip_async", staleness={k}, drop_rate={drop},
            wire_dtype=wire, gossip_subset=subset, remat=False,
            gossip_packed=True, fused_update=fused)
        assert bundle.fused == fused and bundle.layout.num_buckets == 5
        state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                    packed=True, layout=bundle.layout,
                                    inbox=bundle.protocol.staleness,
                                    wire=bundle.wire)
        ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq},
                                 n_shards={dp}, batch_per_shard={gb} // {dp},
                                 seed=0)
        tr = Trainer(bundle, state, ds, log_every=0)
        hist = tr.run({steps})
        out[(wire, fused)] = {{
            "loss": [h["loss"] for h in hist],
            "buckets": [np.asarray(b) for b in tr.state["params"].buckets],
            "valid": np.asarray(tr.state["inbox"]["valid"]),
        }}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_async(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(dp=DP, d=D_MODEL, lr=LR_T, every=EVERY,
                               seq=SEQ, gb=GLOBAL_B, steps=STEPS, k=K,
                               drop=DROP, cases=CASES,
                               bucket_bytes=BUCKET_BYTES)
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(out, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


def _port_run(monkeypatch, init_tree, wire, subset, fused):
    import repro_torch.train.step as step_mod
    monkeypatch.setattr(step_mod, "build_layout", functools.partial(
        step_mod.build_layout, target_bucket_bytes=BUCKET_BYTES))
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                      d_model=D_MODEL),
                              param_dtype="float32", compute_dtype="float32")
    opt = sgd(step_decay(LR_T, 0.1, EVERY), momentum=0.9)
    bundle = make_train_step_bundle(
        cfg, opt, dp=DP, protocol="gossip_async", staleness=K,
        drop_rate=DROP, wire_dtype=wire, gossip_subset=subset,
        gossip_packed=True, fused_update=fused, device="cpu")
    assert bundle.fused == fused and bundle.layout.num_buckets == 5
    params = params_from_numpy(init_tree, layout=bundle.layout, lead=(DP,),
                               device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=True,
                             layout=bundle.layout, params=params,
                             device="cpu", inbox=bundle.protocol.staleness,
                             wire=bundle.wire)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=DP,
                             batch_per_shard=GLOBAL_B // DP, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(STEPS)
    return [h["loss"] for h in hist], tr.state


def _code_step(ref: np.ndarray, wire: str) -> np.ndarray:
    """alpha times one code step of each element's tile: the most that a
    flipped code moves a mixed element."""
    tiles = ref.reshape(ref.shape[:-1] + (-1, 128))
    amax = np.abs(tiles).max(-1, keepdims=True)
    if wire == "int8":
        step = amax / 127.0 + 0 * tiles
    else:  # e4m3: 3 mantissa bits, so a step is 2^(e-3) in code units
        scale = amax / 448.0
        y = np.abs(tiles) / np.where(scale > 0, scale, 1.0)
        e = np.floor(np.log2(np.maximum(y, 2.0 ** -6)))
        step = scale * 2.0 ** (e - 3)
    return (ALPHA * step).reshape(ref.shape)


@pytest.mark.parametrize("wire,subset", CASES, ids=["fp32", "int8_sub50",
                                                    "fp8"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dp4_async_trajectory_matches_reference(reference_async, monkeypatch,
                                                wire, subset, fused):
    want = reference_async[(wire, fused)]
    losses, state = _port_run(monkeypatch, reference_async["init"], wire,
                              subset, fused)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    np.testing.assert_array_equal(state["inbox"]["valid"], want["valid"])
    assert state["inbox"]["t"] == STEPS
    flips = total = 0
    for got, ref in zip(state["params"].buckets, want["buckets"]):
        got = got.detach().numpy()
        bad = ~np.isclose(got, ref, **TOL)
        if wire != "fp32":
            step = _code_step(ref, wire)
            assert (np.abs(got - ref)[bad] <= step[bad] * (1 + 1e-3)
                    + TOL["atol"]).all()
        flips += int(bad.sum())
        total += got.size
    print(f"{wire} fused={fused}: {flips} of {total} elements differ by a "
          f"code step")
    assert flips <= 1e-3 * total, (flips, total)


def test_step_rotates_batches_under_gossip_async():
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=32),
                              param_dtype="float32", compute_dtype="float32")
    opt = sgd(0.1)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, protocol="gossip_async",
                                    gossip_packed=True, device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=True,
                             layout=bundle.layout, device="cpu",
                             inbox=bundle.protocol.staleness)
    assert len(state["inbox"]["slots"]) == 1
    toks = torch.arange(DP * 2 * 9).reshape(DP, 2, 9) % cfg.vocab
    state, nxt, _ = bundle.step(state, {"tokens": toks}, 0)
    assert torch.equal(nxt["tokens"], torch.roll(toks, 1, 0))
    assert state["inbox"]["t"] == 1


def _launch_ranks(argv, world: int) -> dict:
    """The launcher's final JSON line from ``world`` processes of
    ``python -m repro_torch.launch.train argv`` joined as ``torchrun``
    joins them (gloo on localhost); every wait has a time limit."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_launcher_runs_gossip_async_wire(capsys, monkeypatch):
    from repro_torch.launch.train import main
    main(["--smoke", "--packed", "--smoke-mesh", "1,4,1", "--steps", "2",
          "--seq-len", "8", "--global-batch", "8", "--d-model", "32",
          "--log-every", "0", "--device", "cpu", "--protocol", "gossip_async",
          "--staleness", "2", "--drop-timeout", "0.2", "--wire-dtype", "int8",
          "--gossip-subset", "0.5", "--no-fused-update"])
    out = capsys.readouterr().out
    assert '"staleness": 2' in out and '"fused": false' in out
    # under WORLD_SIZE > 1 the ranks are the mesh's positions (4 here); the
    # per-leaf ring runs on each rank's pieces of its replica's leaves, as
    # the stacked per-leaf ring runs on the whole leaves
    leaf = ["--smoke", "--multi-pod", "--smoke-mesh", "1,2,2", "--steps",
            "2", "--seq-len", "8", "--global-batch", "4", "--d-model", "32",
            "--log-every", "0", "--device", "cpu", "--protocol",
            "gossip_async", "--staleness", "2", "--drop-timeout", "0.2"]
    main(leaf)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = _launch_ranks(leaf, 4)
    assert (got["dp"], got["num_shards"], got["staleness"]) == (2, 2, 2)
    for key in ("first_loss", "final_loss"):
        assert abs(got[key] - want[key]) <= 2e-4 * abs(want[key]), key
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        main(["--smoke", "--packed", "--multi-pod", "--smoke-mesh", "1,2,2",
              "--device", "cpu"])
