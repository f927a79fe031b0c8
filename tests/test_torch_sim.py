"""The port's replica simulator (``repro_torch.core.simulate``) against the
reference's ``repro.core.simulate``, on the same seeded numpy inputs.

* The mixing oracles bit for bit in fp32: ``gossip_mix_sim``,
  ``_delayed``, ``_delayed_k`` (k in {1, 2, 4}, drops from ``exchange_ok``
  on and off, several steps carried), ``_masked``, ``_quantized`` and
  ``_quantized_k`` (int8, fp8 and bf16 wires at subset 0.5), and
  ``allreduce_mean_sim`` at p 3, 4 and 6 (``jnp.mean``'s arithmetic, the
  fp32 sum times the fp32 reciprocal of p).
* The nine tests of ``tests/test_protocols_sim.py`` (the paper's
  convergence claims at laptop scale) run on the port.
* ``make_sim_train_step`` (all five protocols, ``drop_prob=0``) and
  ``make_async_sim_train_step`` (fp32 wire, and int8 at subset 0.5) follow
  the reference's trajectories on a quadratic loss within rtol = atol =
  2e-4 (XLA contracts FMAs in the jitted step; the ring's mask and counter
  bit for bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simulate as R  # noqa: E402
from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.async_gossip import init_inbox_ring as ref_init_ring  # noqa: E402
from repro.core.async_gossip import \
    init_wire_inbox_ring as ref_init_wire_ring  # noqa: E402
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.core.topology import build_schedule as ref_build_schedule  # noqa: E402
from repro.kernels.quantize import WireFormat as RefWire  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.core import build_schedule  # noqa: E402
from repro_torch.core import mixing_matrix  # noqa: E402
from repro_torch.core import simulate as S  # noqa: E402
from repro_torch.core.async_gossip import (exchange_ok,  # noqa: E402
                                           init_inbox_ring)
from repro_torch.kernels.quantize import WireFormat  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

P = 8


def _t(x):
    return array_to_torch(np.asarray(x), "cpu")


_TINT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NINT = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or array, for bit equality."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(_TINT[x.element_size()]).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(_NINT[a.dtype.itemsize])


def _close(got, want):
    """Within the reference's end-to-end tolerance (rtol = atol = 2e-4,
    tests/test_hier_packed.py:417)."""
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), rtol=2e-4,
                                   atol=2e-4)


def _same(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _tree(rng, p=P, dtype=np.float32):
    return {"w1": rng.normal(size=(p, 5, 3)).astype(dtype),
            "w2": rng.normal(size=(p, 130)).astype(dtype),
            "w3": rng.normal(size=(p, 2, 7, 11)).astype(dtype)}


def _both(tree):
    return tree_map(_t, tree), jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------- the mixing oracles

def test_replicate_and_gossip_mix_sim():
    rng = np.random.default_rng(0)
    one = {k: v[0] for k, v in _tree(rng).items()}
    got = S.replicate(tree_map(_t, one), P)
    want = R.replicate(jax.tree.map(jnp.asarray, one), P)
    _same(got, want)
    sched = build_schedule(P, num_rotations=2, seed=11)
    got, want = _both(_tree(rng))
    for t in range(sched.period + 2):
        got = S.gossip_mix_sim(got, sched.recv_from(t))
        want = R.gossip_mix_sim(want, jnp.asarray(sched.recv_from(t)))
        _same(got, want)


@pytest.mark.parametrize("alpha", [0.5, 0.25])
def test_gossip_mix_sim_delayed(alpha):
    rng = np.random.default_rng(1)
    sched = build_schedule(P, seed=3)
    got, want = _both(_tree(rng))
    gin, win = _both(_tree(rng))
    for t in range(sched.period):
        rf = sched.recv_from(t)
        got, gin = S.gossip_mix_sim_delayed(got, gin, rf, alpha)
        want, win = R.gossip_mix_sim_delayed(want, win, jnp.asarray(rf),
                                             alpha)
        _same(got, want)
        _same(gin, win)


@pytest.mark.parametrize("drop", [0.0, 0.3], ids=["nodrop", "drop30"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_gossip_mix_sim_delayed_k(k, drop):
    """Params, every slot and the landed mask, bit for bit, over a period
    and the bootstrap, drops from ``exchange_ok`` (port == reference)."""
    rng = np.random.default_rng(k)
    sched = build_schedule(P, seed=5)
    got, want = _both(_tree(rng))
    gring = init_inbox_ring(got, k, P)
    wring = ref_init_ring(want, k, P)
    for t in range(sched.period + k):
        ok = exchange_ok(gring["t"], np.arange(P), 7, drop)
        wok = ref_exchange_ok(wring["t"], jnp.arange(P), 7, drop)
        np.testing.assert_array_equal(ok, np.asarray(wok))
        rf = sched.recv_from(t)
        got, gring = S.gossip_mix_sim_delayed_k(got, gring, rf, 0.5, ok)
        want, wring = R.gossip_mix_sim_delayed_k(want, wring, jnp.asarray(rf),
                                                 0.5, wok)
        _same(got, want)
        for gs, ws in zip(gring["slots"], wring["slots"]):
            _same(gs, ws)
        np.testing.assert_array_equal(gring["valid"], np.asarray(wring["valid"]))
        assert gring["t"] == int(wring["t"]) == t + 1
    if drop:
        assert not gring["valid"].all()


def test_gossip_mix_sim_masked():
    rng = np.random.default_rng(2)
    sched = build_schedule(P, seed=1)
    for dtype in (np.float32,):
        got, want = _both(_tree(rng, dtype=dtype))
        for t in range(sched.period):
            ok = rng.random(P) >= 0.3
            rf = sched.recv_from(t)
            got = S.gossip_mix_sim_masked(got, rf, ok)
            want = R.gossip_mix_sim_masked(want, jnp.asarray(rf),
                                           jnp.asarray(ok))
            _same(got, want)


def _buckets(rng, dtype=np.float32):
    layout = ref_build_layout({f"w{i}": jnp.zeros(n) for i, n in enumerate(
        (700, 520, 400, 390, 260, 250, 130, 100))}, target_bucket_bytes=3000)
    assert layout.num_buckets == 5
    return layout, [(rng.normal(size=(P, n)) * 3).astype(dtype)
                    for n in layout.bucket_sizes]


WIRES = ["int8", "fp8", "bf16"]


@pytest.mark.parametrize("wire", WIRES)
def test_gossip_mix_sim_quantized(wire):
    rng = np.random.default_rng(3)
    _, xs = _buckets(rng)
    sched = build_schedule(P, seed=2)
    got, want = [_t(x) for x in xs], [jnp.asarray(x) for x in xs]
    pw, rw = WireFormat(wire, 0.5, seed=4), RefWire(wire, 0.5, seed=4)
    for t in range(sched.period + 2):
        rf = sched.recv_from(t)
        got = S.gossip_mix_sim_quantized(got, rf, t, wire=pw)
        want = R.gossip_mix_sim_quantized(want, jnp.asarray(rf), t, wire=rw)
        _same(got, want)


def _payloads(slot):
    out = []
    for p in slot:
        out += [p["q"], p["s"]] if isinstance(p, dict) else [p]
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_gossip_mix_sim_quantized_k(wire):
    rng = np.random.default_rng(4)
    layout, xs = _buckets(rng)
    sched = build_schedule(P, seed=6)
    k, drop = 2, 0.3
    got, want = [_t(x) for x in xs], [jnp.asarray(x) for x in xs]
    pw, rw = WireFormat(wire, 0.5, seed=9), RefWire(wire, 0.5, seed=9)
    wring = ref_init_wire_ring(RefPacked(want, layout), k, P, rw)
    gring = {"slots": tuple([tree_map(_t, jax.tree.map(np.asarray, p))
                             for p in slot] for slot in wring["slots"]),
             "valid": np.zeros((P, k), np.float32), "t": 0}
    for t in range(sched.period + k):
        rf = sched.recv_from(t)
        ok = exchange_ok(gring["t"], np.arange(P), 1, drop)
        got, gring = S.gossip_mix_sim_quantized_k(got, gring, rf, wire=pw,
                                                  ok=ok)
        want, wring = R.gossip_mix_sim_quantized_k(
            want, wring, jnp.asarray(rf), wire=rw, ok=jnp.asarray(ok))
        _same(got, want)
        _same(_payloads(gring["slots"][-1]), _payloads(wring["slots"][-1]))
        np.testing.assert_array_equal(gring["valid"], np.asarray(wring["valid"]))


@pytest.mark.parametrize("p", [3, 4, 6])
def test_allreduce_mean_sim(p):
    """``jnp.mean``'s arithmetic, signed zeros and all, and a replica
    variance of zero after it."""
    rng = np.random.default_rng(p)
    tree = {"a": (rng.normal(size=(p, 384))
                  * 10.0 ** rng.integers(-3, 4, size=(p, 384))
                  ).astype(np.float32),
            "b": rng.normal(size=(p, 3, 5)).astype(np.float32)}
    tree["a"][:, :5] = -0.0
    got, want = _both(tree)
    got, want = S.allreduce_mean_sim(got), R.allreduce_mean_sim(want)
    _same(got, want)
    # the mean of equal replicas is not always exactly their value (p = 3,
    # 6), in neither package: the variances agree, both near zero
    np.testing.assert_allclose(float(S.replica_variance(got)),
                               float(R.replica_variance(want)), rtol=1e-5,
                               atol=1e-12)


def test_replica_variance():
    got, want = _both(_tree(np.random.default_rng(5)))
    np.testing.assert_allclose(float(S.replica_variance(got)),
                               float(R.replica_variance(want)), rtol=1e-6)


# ------------------------------- tests/test_protocols_sim.py, on the port

def _quadratic_loss(target):
    def loss(params, batch):
        # per-replica quadratic bowl; batch = per-replica noise
        return ((params["w"] - target - batch) ** 2).sum(-1)
    return loss


def _make(p, protocol, steps=60, lr=0.05, seed=0, num_rotations=2,
          shard_bias=0.0):
    sched = build_schedule(p, num_rotations=num_rotations, seed=seed)
    target = torch.arange(4.0)
    opt = sgd(lr, momentum=0.0)
    step = S.make_sim_train_step(_quadratic_loss(target), opt, sched,
                                 protocol=protocol)
    params = S.replicate({"w": torch.zeros(4)}, p)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seed)
    bias = rng.normal(scale=shard_bias, size=(p, 4)) if shard_bias else 0.0
    hist = []
    for t in range(steps):
        batch = torch.as_tensor(bias + rng.normal(scale=0.1, size=(p, 4)),
                                dtype=torch.float32)
        opt_state, params, m = step(opt_state, params, batch, t)
        hist.append({k: float(v) for k, v in m.items()})
    return params, hist, target


def test_gossip_reaches_optimum_and_consensus():
    params, hist, target = _make(8, "gossip", steps=120)
    assert np.allclose(params["w"].numpy(), target.numpy()[None], atol=0.15)
    assert hist[-1]["replica_variance"] < 1e-3


def test_gossip_tracks_agd():
    _, h_g, _ = _make(8, "gossip", steps=120)
    _, h_a, _ = _make(8, "agd", steps=120)
    assert abs(h_g[-1]["loss"] - h_a[-1]["loss"]) < 0.1


def test_none_protocol_keeps_replicas_apart():
    _, h_none, _ = _make(8, "none", steps=80, seed=3, shard_bias=1.0)
    _, h_goss, _ = _make(8, "gossip", steps=80, seed=3, shard_bias=1.0)
    assert h_none[-1]["replica_variance"] > 10 * h_goss[-1]["replica_variance"]


def test_every_logp_converges():
    _, hist, _ = _make(8, "every_logp", steps=120)
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.2


def test_gossip_mix_sim_matches_matrix():
    p = 8
    sched = build_schedule(p, num_rotations=2, seed=11)
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(p, 5)),
                        dtype=torch.float32)
    for t in range(sched.period):
        got = S.gossip_mix_sim({"w": w}, sched.recv_from(t))["w"]
        want = mixing_matrix(sched.recv_from(t)) @ w.numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_gossip_preserves_replica_mean():
    p = 16
    sched = build_schedule(p, num_rotations=3, seed=2)
    params = {"a": torch.as_tensor(np.random.default_rng(4).normal(
        size=(p, 3, 2)), dtype=torch.float32)}
    mean0 = params["a"].numpy().mean(0)
    for t in range(10):
        params = S.gossip_mix_sim(params, sched.recv_from(t))
    np.testing.assert_allclose(params["a"].numpy().mean(0), mean0,
                               rtol=1e-5, atol=1e-6)


def test_allreduce_sim_equalizes():
    params = {"a": torch.as_tensor(np.random.default_rng(0).normal(
        size=(4, 3)), dtype=torch.float32)}
    a = S.allreduce_mean_sim(params)["a"].numpy()
    assert np.allclose(a, a[0:1])
    assert float(S.replica_variance({"a": torch.as_tensor(a)})) < 1e-12


def test_gossip_grad_variant_diverges_more():
    _, h_model, _ = _make(8, "gossip", steps=100, seed=5, shard_bias=0.5)
    _, h_grad, _ = _make(8, "gossip_grad", steps=100, seed=5, shard_bias=0.5)
    assert h_grad[-1]["replica_variance"] > \
        5 * h_model[-1]["replica_variance"]


def test_gossip_tolerates_dropped_exchanges():
    sched = build_schedule(8, num_rotations=2, seed=9)
    target = torch.arange(4.0)
    opt = sgd(0.05, momentum=0.0)
    step = S.make_sim_train_step(_quadratic_loss(target), opt, sched,
                                 protocol="gossip", drop_prob=0.3, seed=9)
    params = S.replicate({"w": torch.zeros(4)}, 8)
    st = opt.init(params)
    rng = np.random.default_rng(9)
    for t in range(150):
        batch = torch.as_tensor(rng.normal(scale=0.1, size=(8, 4)),
                                dtype=torch.float32)
        st, params, m = step(st, params, batch, t)
    assert np.allclose(params["w"].numpy(), target.numpy()[None], atol=0.2)
    assert float(m["replica_variance"]) < 1e-2


# --------------------------------------- train steps against the reference

def _bowl(rng, p):
    target = {"w": rng.normal(size=(4,)), "b": rng.normal(size=(3, 2)),
              "c": rng.normal(size=(130,))}
    return {k: v.astype(np.float32) for k, v in target.items()}


def _port_bowl(target):
    tg = tree_map(_t, target)

    def loss(params, batch):
        return sum(((params[k] - tg[k] - batch[k]) ** 2).flatten(1).sum(1)
                   for k in sorted(tg))
    return loss


def _ref_bowl(target):
    def loss(params, batch):
        return sum(jnp.sum((params[k] - target[k] - batch[k]) ** 2)
                   for k in sorted(target))
    return loss


def _batches(rng, target, p, steps):
    return [{k: (rng.normal(scale=0.1, size=(p,) + v.shape) + 0.3
                 * rng.normal(size=(p,) + v.shape)).astype(np.float32)
             for k, v in target.items()} for _ in range(steps)]


@pytest.mark.parametrize("protocol", ["gossip", "gossip_grad", "agd",
                                      "every_logp", "none"])
def test_sim_train_step_matches_reference(protocol):
    """``drop_prob=0``, 2 periods of the p=8 schedule: params, momenta and
    losses within rtol = atol = 2e-4. XLA compiles the reference's whole
    step as one program and contracts the momentum update's products and
    sums into FMAs, so even ``none`` parts from the port by an ulp."""
    p, rng = P, np.random.default_rng(7)
    target = _bowl(rng, p)
    sched = build_schedule(p, seed=4)
    rsched = ref_build_schedule(p, seed=4)
    step = S.make_sim_train_step(_port_bowl(target), sgd(0.05, 0.9), sched,
                                 protocol=protocol)
    rstep = R.make_sim_train_step(_ref_bowl(target), ref_sgd(0.05, 0.9),
                                  rsched, protocol=protocol)
    init = {k: np.zeros((p,) + v.shape, np.float32) for k, v in
            target.items()}
    params, rparams = _both(init)
    st, rst = sgd(0.05, 0.9).init(params), ref_sgd(0.05, 0.9).init(rparams)
    for t, b in enumerate(_batches(rng, target, p, 2 * sched.period)):
        st, params, m = step(st, params, tree_map(_t, b), t)
        rst, rparams, rm = rstep(rst, rparams, jax.tree.map(jnp.asarray, b),
                                 jnp.int32(t))
        _close(params, rparams)
        _close(st["mom"], rst["mom"])
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("wire,subset", [("fp32", 1.0), ("int8", 0.5)],
                         ids=["fp32", "int8_sub0.5"])
def test_async_sim_train_step_matches_reference(wire, subset):
    """k 2, drop 0.2: the ring's mask and counter bit for bit; params,
    slots and losses within rtol = atol = 2e-4, as the synchronous steps
    (the reference's fused step contracts FMAs; its mix alone is bit-equal
    to the port's, the oracle tests above)."""
    p, k, rng = P, 2, np.random.default_rng(8)
    target = _bowl(rng, p)
    sched = build_schedule(p, seed=1)
    kw = dict(alpha=0.5, staleness=k, drop_rate=0.2, drop_seed=3,
              wire_dtype=wire, gossip_subset=subset, wire_seed=5)
    step = S.make_async_sim_train_step(_port_bowl(target), sgd(0.05, 0.9),
                                       sched, **kw)
    rstep = R.make_async_sim_train_step(
        _ref_bowl(target), ref_sgd(0.05, 0.9), ref_build_schedule(p, seed=1),
        **kw)
    init = {k_: (0.1 * rng.normal(size=(p,) + v.shape)).astype(np.float32)
            for k_, v in target.items()}
    params, rparams = _both(init)
    ring, rring = init_inbox_ring(params, k, p), ref_init_ring(rparams, k, p)
    st, rst = sgd(0.05, 0.9).init(params), ref_sgd(0.05, 0.9).init(rparams)
    for t, b in enumerate(_batches(rng, target, p, sched.period + k)):
        st, params, ring, m = step(st, params, ring, tree_map(_t, b), t)
        rst, rparams, rring, rm = rstep(rst, rparams, rring,
                                        jax.tree.map(jnp.asarray, b),
                                        jnp.int32(t))
        _close(params, rparams)
        for gs, ws in zip(ring["slots"], rring["slots"]):
            _close(gs, ws)
        np.testing.assert_array_equal(ring["valid"], np.asarray(rring["valid"]))
        assert ring["t"] == int(rring["t"]) == t + 1
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=2e-4, atol=2e-4)


def test_drop_mask_is_a_function_of_seed_and_step():
    """The by-design difference: the port's masks come from a torch
    generator keyed on (seed + 7919, step), reproducible step by step."""
    a = [S.drop_mask(9, t, 8, 0.3) for t in range(20)]
    b = [S.drop_mask(9, t, 8, 0.3) for t in reversed(range(20))][::-1]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    frac = 1.0 - np.mean(a)
    assert 0.1 < frac < 0.5
    assert S.drop_mask(9, 3, 8, 0.0).all()
