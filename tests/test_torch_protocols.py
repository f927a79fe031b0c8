"""The paper's baselines and their host logic in the port, against the
reference.

* ``agd`` (gradients averaged every step) and ``every_logp`` (params
  averaged after every ``substeps``-th step) at dp=4, fused and
  ``fused_update=False``, 8 steps: the reference runs at mesh (1, 4, 1) in a
  subprocess with four forced host devices, the port stacks the replicas on
  the CPU from the bridged init. Losses, buckets and momenta agree within
  the reference's end-to-end tolerance (rtol = atol = 2e-4,
  tests/test_hier_packed.py:417), and the replicas are bit-identical after
  exactly the steps on which the reference's are.
* The replica mean equals ``jnp.mean`` over the replica axis bit for bit.
* ``cosine_warmup`` within 2 ulp (numpy's and XLA's float32 ``cos``), and
  the launcher's agd learning rate is the reference's
  ``scale_lr_sqrt_p(step_decay(...), p)`` in float32.
* ``core/mixing.py``, ``reachability``, ``diffusion_steps`` and the ring
  topology equal the reference's (numpy in both).
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build_schedule as ref_build_schedule  # noqa: E402
from repro.core import mixing as ref_mixing  # noqa: E402
from repro.core import topology as ref_topology  # noqa: E402
from repro.optim import cosine_warmup as ref_cosine_warmup  # noqa: E402
from repro.optim import scale_lr_sqrt_p as ref_scale_lr_sqrt_p  # noqa: E402
from repro.optim import step_decay as ref_step_decay  # noqa: E402
from repro_torch.checkpoint import array_to_torch, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PackedParams, build_layout, make_protocol  # noqa: E402
from repro_torch.core import mixing, topology  # noqa: E402
from repro_torch.core.protocols import _replica_mean  # noqa: E402
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import cosine_warmup, sgd, step_decay  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)

ROOT = Path(__file__).resolve().parents[1]
DP, D_MODEL, SEQ, GLOBAL_B, STEPS, LR, EVERY, WD = 4, 64, 16, 8, 8, 0.3, 3, 1e-4
TOL = dict(rtol=2e-4, atol=2e-4)
CASES = [(proto, fused) for proto in ("agd", "every_logp")
         for fused in (True, False)]
CASE_IDS = [f"{p}-{'fused' if f else 'unfused'}" for p, f in CASES]

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={dp}"
import repro
import dataclasses
import jax, numpy as np
from repro.configs import get_config
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh({dp}, 1), "replica")
opt = sgd(step_decay({lr}, 0.1, {every}), momentum=0.9, weight_decay={wd})
ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}}
for proto, fused in {cases}:
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol=proto, remat=False, gossip_packed=True, fused_update=fused)
    assert bundle.fused == fused
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                packed=True, layout=bundle.layout)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards={dp},
                             batch_per_shard={gb} // {dp}, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    same = []
    for s in range({steps}):
        tr.run(1, start_step=s)
        same.append(all(bool((np.asarray(b) == np.asarray(b)[:1]).all())
                        for b in tr.state["params"].buckets))
    out[proto, fused] = {{
        "loss": [h["loss"] for h in tr.history], "same": same,
        "period": bundle.protocol.period,
        "buckets": [np.asarray(b) for b in tr.state["params"].buckets],
        "mom": [np.asarray(b) for b in tr.state["opt"]["mom"].buckets],
    }}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(dp=DP, d=D_MODEL, lr=LR, every=EVERY, wd=WD,
                               seq=SEQ, gb=GLOBAL_B, steps=STEPS, cases=CASES)
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


def _port_run(init_tree, protocol, fused):
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                      d_model=D_MODEL),
                              param_dtype="float32", compute_dtype="float32")
    opt = sgd(step_decay(LR, 0.1, EVERY), momentum=0.9, weight_decay=WD)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, protocol=protocol,
                                    gossip_packed=True, fused_update=fused,
                                    device="cpu")
    assert bundle.fused == fused
    params = params_from_numpy(init_tree, layout=bundle.layout, lead=(DP,),
                               device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=True,
                             layout=bundle.layout, params=params, device="cpu")
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=DP,
                             batch_per_shard=GLOBAL_B // DP, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    same = []
    for s in range(STEPS):
        tr.run(1, start_step=s)
        same.append(all(bool((b == b[:1]).all())
                        for b in tr.state["params"].buckets))
    return bundle, tr, same


@pytest.mark.parametrize("protocol,fused", CASES, ids=CASE_IDS)
def test_dp4_trajectory_matches_reference(reference, protocol, fused):
    want = reference[protocol, fused]
    bundle, tr, same = _port_run(reference["init"], protocol, fused)
    assert bundle.protocol.period == want["period"]
    losses = [h["loss"] for h in tr.history]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    for got, ref in zip(tr.state["params"].buckets, want["buckets"]):
        np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    for got, ref in zip(tr.state["opt"]["mom"].buckets, want["mom"]):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the averages land on the reference's steps: agd keeps the replicas
    # identical, every_logp makes them so after every second step
    assert same == want["same"]
    if protocol == "agd":
        assert all(same)
    else:
        assert same == [(s + 1) % 2 == 0 for s in range(STEPS)]


def test_protocols_build_with_their_periods():
    layout = build_layout({"w": torch.zeros(300)})
    for dp in (2, 4, 8):
        agd = make_protocol("agd", dp, packed_layout=layout)
        assert agd.schedule is None and agd.period == 1
        ev = make_protocol("every_logp", dp, packed_layout=layout)
        ref = ref_build_schedule(dp)
        assert ev.period == ref.period == ev.schedule.period
        assert ev.schedule.substeps == ref.substeps
        np.testing.assert_array_equal(ev.schedule.perms, ref.perms)
    one = make_protocol("every_logp", 1)
    assert one.schedule is None and one.period == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dp", [3, 4, 6])
def test_replica_mean_matches_jnp_mean(dtype, dp):
    """fp32 sums from a zero, one product with the fp32 reciprocal of dp
    (XLA's rewrite of the division), one rounding: the bits of
    ``jnp.mean(x, axis=0)`` broadcast back, signed zeros included."""
    rng = np.random.default_rng(dp)
    xs = [rng.normal(size=(dp, n)) * 10.0 ** rng.integers(-3, 4, size=(dp, n))
          for n in (384, 128)]
    xs[1][:, :5] = -0.0
    ref = [jnp.asarray(x, jnp.float32).astype(dtype) for x in xs]
    want = [jnp.broadcast_to(r.mean(axis=0, keepdims=True), r.shape)
            for r in ref]
    layout = build_layout({"a": torch.zeros(384), "b": torch.zeros(128)})
    packed = PackedParams([array_to_torch(np.asarray(r), "cpu") for r in ref],
                          layout)
    got = _replica_mean(packed)
    assert got is packed
    for g, w in zip(got.buckets, want):
        bits = np.int16 if dtype == "bfloat16" else np.int32
        np.testing.assert_array_equal(
            g.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy(), np.asarray(w).view(bits))


# ------------------------------------------------------------ schedules

def _ulps(got: float, want) -> float:
    want = np.float32(want)
    return abs(np.float32(got) - want) / np.spacing(np.abs(want))


@pytest.mark.parametrize("lr,warmup,total,final", [
    (1.0, 10, 100, 0.1), (0.1, 5, 50, 0.1), (3e-4, 100, 1000, 0.0),
    (0.05, 0, 40, 0.25)])
def test_cosine_warmup_within_2_ulp(lr, warmup, total, final):
    """The warmup is bit-equal. In the decay, numpy's float32 ``cos`` is
    within 2 ulp of XLA's, and ``1 + cos`` carries that error into the
    value: the bound is 2 ulp of the value plus 2 ulp of ``cos`` times its
    coefficient ``(1 - final) * lr / 2``."""
    ours = cosine_warmup(lr, warmup, total, final)
    ref = ref_cosine_warmup(lr, warmup, total, final)
    coef = np.float32((1 - final) * lr * 0.5)
    for step in range(0, total + 10, max(1, total // 200)):
        got, want = ours(step), float(ref(jnp.int32(step)))
        assert got == float(np.float32(got))
        if step < warmup:
            assert got == want, (step, got, want)
            continue
        t = jnp.clip((jnp.float32(step) - warmup) / max(total - warmup, 1),
                     0.0, 1.0)
        c_ref = np.float32(jnp.cos(math.pi * t))
        c_np = np.cos(np.float32(math.pi) * np.float32(t))
        assert _ulps(c_np, c_ref) <= 2
        tol = (2 * np.spacing(np.float32(abs(want)))
               + 2 * np.spacing(np.abs(c_ref)) * coef)
        assert abs(np.float32(got) - np.float32(want)) <= tol, (step, got,
                                                                 want)


def test_cosine_warmup_shape():
    f = cosine_warmup(1.0, warmup=10, total=100)
    assert f(0) == 0.0
    assert f(10) == pytest.approx(1.0, rel=1e-3)
    assert f(100) == pytest.approx(0.1, rel=1e-2)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_launcher_agd_lr_is_the_references(p):
    """``--protocol agd`` scales the step decay by sqrt(p), the factor
    rounded to float32 and the product taken in float32. Past the second
    decay, step_decay's own float32 ``pow`` may differ by 2 ulp (ROADMAP
    C); below it the two are bit-equal."""
    from repro_torch.launch.train import lr_schedule, parse_args
    args = parse_args(["--protocol", "agd", "--steps", "30", "--lr", "0.3",
                       "--device", "cpu"])
    ours = lr_schedule(args, p)
    ref = ref_scale_lr_sqrt_p(ref_step_decay(0.3, 0.1, 10), p)
    for step in range(40):
        got, want = ours(step), float(ref(jnp.int32(step)))
        if step < 20:
            assert got == want, (step, got, want)
        else:
            assert _ulps(got, want) <= 2, (step, got, want)
    if p == 8:  # sqrt(8) is not exact: a double product would differ
        assert ours(0) == float(np.float32(0.3) * np.float32(math.sqrt(8)))
    gossip = lr_schedule(parse_args(["--steps", "30", "--lr", "0.3"]), p)
    assert gossip(0) == float(np.float32(0.3))


# ------------------------------------------------------------- topology

PS = [2, 3, 4, 5, 8, 16]


def _topologies(p):
    return ["dissemination", "ring"] + (["hypercube"] if p & (p - 1) == 0
                                        else [])


@pytest.mark.parametrize("p", PS)
def test_mixing_and_diffusion_equal_the_references(p):
    for topo in _topologies(p):
        ours = topology.build_schedule(p, topo, num_rotations=2, seed=7)
        ref = ref_build_schedule(p, topo, num_rotations=2, seed=7)
        assert ours.substeps == ref.substeps
        np.testing.assert_array_equal(ours.perms, ref.perms)
        for t in range(ours.period + 1):
            m = mixing.mixing_matrix(ours.recv_from(t))
            mr = ref_mixing.mixing_matrix(ref.recv_from(t))
            np.testing.assert_array_equal(m, mr)
            assert mixing.is_doubly_stochastic(m)
            assert (mixing.consensus_contraction(m)
                    == ref_mixing.consensus_contraction(mr))
            assert mixing.spectral_gap(m) == ref_mixing.spectral_gap(mr)
            np.testing.assert_array_equal(topology.reachability(ours, t),
                                          ref_topology.reachability(ref, t))
        for start, steps in ((0, None), (1, 3)):
            np.testing.assert_array_equal(
                mixing.round_matrix(ours, start, steps),
                ref_mixing.round_matrix(ref, start, steps))
        assert (topology.diffusion_steps(ours)
                == ref_topology.diffusion_steps(ref))
        assert (topology.diffusion_steps(ours, max_steps=1)
                == ref_topology.diffusion_steps(ref, max_steps=1))


@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_dissemination_round_is_exact_average(p):
    """A power-of-two dissemination round (log2 p steps) is an all-reduce:
    contraction 0, and every rank reached in log2 p steps."""
    s = topology.build_schedule(p, num_rotations=1)
    m = mixing.round_matrix(s)
    assert mixing.consensus_contraction(m) < 1e-10
    np.testing.assert_allclose(m, np.ones((p, p)) / p, atol=1e-12)
    assert topology.diffusion_steps(s) == topology.log2_steps(p)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("rotations,seed", [(1, 0), (2, 3), (3, 11)])
def test_ring_schedule_equals_the_references(p, rotations, seed):
    ours = topology.build_schedule(p, "ring", num_rotations=rotations,
                                   seed=seed)
    ref = ref_build_schedule(p, "ring", num_rotations=rotations, seed=seed)
    assert ours.substeps == ref.substeps == 1
    assert ours.period == ref.period == rotations
    np.testing.assert_array_equal(ours.perms, ref.perms)
    np.testing.assert_array_equal(topology.ring_partner(p),
                                  ref_topology.ring_partner(p))
