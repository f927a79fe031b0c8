"""The port's checkpoints (npz + manifest) against the reference's.

* The reference's own checkpoint tests, against the port: the round trip
  and the structure mismatch (tests/test_optim_data_ckpt.py), the ring's
  round trip, cross-staleness restore and legacy inbox
  (tests/test_async_gossip.py), the compressed wire's ring round trip and
  the cross-wire-format reset (tests/test_wire.py).
* Cross-package parity: a state written by ``repro.checkpoint.save_state``
  restores in the port and a state the port wrote restores in the
  reference, every leaf bit for bit (bf16 as raw bits), for packed sync
  state and gossip_async with the fp32 ring and the int8 ring. Each side's
  state comes from its own init over the bridged weights.
* Resume determinism on the CPU: dp=4, straight 8 steps == 4 + save /
  restore into a fresh state + 4, bit for bit, for sync fused and async
  int8 subset 0.5 fused (the stacked-dp counterpart of
  ``test_async_train_checkpoint_resume_p8`` / ``_wire_..._p8``), with
  PyTorch's deterministic algorithms on.
* The launchers: the reference's writes at step 2 (four forced host
  devices, in a subprocess), the port's ``--resume --device cpu``
  continues to step 4, and its final loss is within rtol 2e-4 of the
  reference's straight 4-step run. The launchers' step decay period is
  ``--steps // 3``, so 2 + 2 and 4 steps share one schedule.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_state as ref_restore  # noqa: E402
from repro.checkpoint import save_state as ref_save  # noqa: E402
from repro.checkpoint.io import _unpack_view as ref_unpack_view  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import PackedParams as RPackedParams  # noqa: E402
from repro.core import build_layout as ref_build_layout  # noqa: E402
from repro.core import init_inbox_ring as ref_init_ring  # noqa: E402
from repro.core import init_wire_inbox_ring as ref_init_wire_ring  # noqa: E402
from repro.kernels import quantize as RQ  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402
from repro_torch.checkpoint import (checkpoint_exists,  # noqa: E402
                                    params_from_numpy, read_manifest,
                                    restore_state, save_state)
from repro_torch.checkpoint.io import _host, _leaves  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PackedParams, init_inbox_ring,  # noqa: E402
                              init_wire_inbox_ring)
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.kernels.quantize import (WireFormat, decode_wire,  # noqa: E402
                                          encode_wire, wire_key)
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import sgd, step_decay  # noqa: E402
from repro_torch.tree import keystr, tree_map  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)

ROOT = Path(__file__).resolve().parents[1]
DP = 4
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bits(x) -> np.ndarray:
    """Raw bit patterns of a tensor, an array or a host int."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
        return x.view(ints[x.element_size()]).numpy().view(
            _UINT[x.element_size()])
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.kind == "i" and a.ndim == 0 and a.dtype.itemsize == 8:
        a = a.astype(np.int32)
    return a.view(_UINT[a.dtype.itemsize])


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).rsplit(".", 1)[-1]
    return "int32" if isinstance(x, int) else str(np.asarray(x).dtype)


def _port_flat(state):
    return {keystr(p): (_dtype(v), _bits(v))
            for p, v in _leaves(_host(state), ())}


def _ref_flat(state):
    leaves, _ = jax.tree_util.tree_flatten_with_path(ref_unpack_view(state))
    return {jax.tree_util.keystr(p): (_dtype(v), _bits(v))
            for p, v in leaves}


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k][0] == want[k][0], (k, got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=k)


# ------------------------------------- the reference's tests, on the port

def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "b": torch.ones(4, dtype=torch.bfloat16)},
             "opt": {"step": 7, "mom": None}}
    path = str(tmp_path / "ckpt")
    save_state(path, state, metadata={"arch": "test"}, step=7)
    tmpl = tree_map(lambda x: torch.zeros_like(x)
                    if isinstance(x, torch.Tensor) else 0, state)
    restored, manifest = restore_state(path, tmpl)
    assert manifest["metadata"]["arch"] == "test"
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["opt"]["step"] == 7 and restored["opt"]["mom"] is None
    assert manifest["dtypes"]["['opt']['step']"] == "int32"
    assert manifest["dtypes"]["['params']['b']"] == "bfloat16"


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    save_state(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        restore_state(path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_state(path, {"a": torch.zeros(4)})


def _ring_state(k, dp=DP, seed=7, step=9):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    tree = {"w1": mk(dp, 5, 3), "w2": mk(dp, 130)}
    packed = PackedParams.pack(tree, skip_leading=1)
    ring = {"slots": tuple(PackedParams.pack(
                tree_map(lambda x, _i=i: x + 1.0 + _i, tree),
                packed.layout) for i in range(k)),
            "valid": rng.integers(0, 2, size=(dp, k)).astype(np.float32),
            "t": step}
    return {"params": packed, "opt": {"step": step}, "inbox": ring}, tree


def test_ring_checkpoint_roundtrip(tmp_path):
    state, tree = _ring_state(k=3)
    d = str(tmp_path / "ck")
    assert not checkpoint_exists(d)
    save_state(d, state, step=9, metadata={"protocol": "gossip_async",
                                           "staleness": 3})
    assert checkpoint_exists(d)
    man = read_manifest(d)
    assert man["step"] == 9 and man["metadata"]["staleness"] == 3
    rest, _ = restore_state(d, _ring_state(k=3, seed=13, step=0)[0])
    assert len(rest["inbox"]["slots"]) == 3
    np.testing.assert_array_equal(rest["inbox"]["valid"],
                                  state["inbox"]["valid"])
    assert rest["inbox"]["t"] == 9 and isinstance(rest["inbox"]["t"], int)
    for got, want in zip(rest["inbox"]["slots"], state["inbox"]["slots"]):
        assert isinstance(got, PackedParams)
        for a, b in zip(got.buckets, want.buckets):
            assert torch.equal(a, b)
    got = rest["params"].unpack()
    assert torch.equal(got["w1"], tree["w1"])
    # params and ring slots restore as distinct tensors
    ptrs = {b.data_ptr() for b in rest["params"].buckets}
    for slot in rest["inbox"]["slots"]:
        assert not ptrs & {b.data_ptr() for b in slot.buckets}


def test_ring_checkpoint_cross_staleness(tmp_path):
    state1, _ = _ring_state(k=1, step=5)
    d1 = str(tmp_path / "ck1")
    save_state(d1, state1, step=5, metadata={"staleness": 1})
    rest4, _ = restore_state(d1, _ring_state(k=4, seed=13, step=0)[0])
    assert len(rest4["inbox"]["slots"]) == 4
    for s in rest4["inbox"]["slots"]:   # the one slot, and its masked copies
        assert torch.equal(s.unpack()["w1"],
                           state1["inbox"]["slots"][0].unpack()["w1"])
    v = rest4["inbox"]["valid"]
    np.testing.assert_array_equal(v[:, 0], state1["inbox"]["valid"][:, 0])
    assert not v[:, 1:].any() and rest4["inbox"]["t"] == 5

    # ...and back: k=4 -> k=1 keeps the OLDEST slot
    state4, _ = _ring_state(k=4, step=11)
    d4 = str(tmp_path / "ck4")
    save_state(d4, state4, step=11, metadata={"staleness": 4})
    rest1, _ = restore_state(d4, _ring_state(k=1, seed=17, step=0)[0])
    assert len(rest1["inbox"]["slots"]) == 1
    assert torch.equal(rest1["inbox"]["slots"][0].unpack()["w2"],
                       state4["inbox"]["slots"][0].unpack()["w2"])
    np.testing.assert_array_equal(rest1["inbox"]["valid"],
                                  state4["inbox"]["valid"][:, :1])


def test_legacy_inbox_checkpoint_restores_as_ring(tmp_path):
    state, tree = _ring_state(k=1, step=9)
    inbox_tree = tree_map(lambda x: x + 1.0, tree)
    legacy = {"params": state["params"], "opt": {"step": 9},
              "inbox": PackedParams.pack(inbox_tree, skip_leading=1)}
    d = str(tmp_path / "ck")
    save_state(d, legacy, step=9, metadata={"protocol": "gossip_async"})
    rest, _ = restore_state(d, _ring_state(k=2, seed=13, step=0)[0])
    assert len(rest["inbox"]["slots"]) == 2
    got = rest["inbox"]["slots"][0].unpack()
    for k_ in tree:
        assert torch.equal(got[k_], inbox_tree[k_])
    v = rest["inbox"]["valid"]
    assert v[:, 0].all() and not v[:, 1:].any()
    assert rest["inbox"]["t"] == 9


def _wire_ring_state(wire, k=2, dp=DP, seed=7, step=9):
    state, tree = _ring_state(k=1, dp=dp, seed=seed, step=step)
    packed = state["params"]
    slots = tuple(
        [encode_wire(b + float(j + 1), wire.dtype,
                     keys=wire_key(j, np.arange(dp), i, 0))
         for i, b in enumerate(packed.buckets)] for j in range(k))
    rng = np.random.default_rng(seed + 1)
    ring = {"slots": slots,
            "valid": rng.integers(0, 2, (dp, k)).astype(np.float32),
            "t": step}
    return {"params": packed, "opt": {"step": step}, "inbox": ring}, tree


def _payload_bits_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8", "bf16"])
def test_wire_ring_checkpoint_roundtrip(tmp_path, wire_dtype):
    wire = WireFormat(dtype=wire_dtype)
    state, _ = _wire_ring_state(wire)
    d = str(tmp_path / "ck")
    save_state(d, state, step=9, metadata={"wire_dtype": wire_dtype})
    template = dict(state, inbox=init_wire_inbox_ring(state["params"], 2, DP,
                                                      wire))
    rest, man = restore_state(d, template)
    assert man["metadata"]["wire_dtype"] == wire_dtype
    assert len(rest["inbox"]["slots"]) == 2
    for sg, sw in zip(rest["inbox"]["slots"], state["inbox"]["slots"]):
        for pg, pw in zip(sg, sw):
            _payload_bits_equal(pg, pw)
    np.testing.assert_array_equal(rest["inbox"]["valid"],
                                  state["inbox"]["valid"])
    assert rest["inbox"]["t"] == 9


def test_cross_wire_format_restore_resets_ring(tmp_path):
    state8, tree = _wire_ring_state(WireFormat(dtype="int8"), step=9)
    d = str(tmp_path / "ck8")
    save_state(d, state8, step=9, metadata={"wire_dtype": "int8"})
    zero = PackedParams.pack(tree_map(lambda x: x * 0.0, tree),
                             skip_leading=1)
    # int8 ring -> fp32-wire (PackedParams slots) template
    tpl = {"params": zero, "opt": {"step": 0},
           "inbox": init_inbox_ring(state8["params"], 2, DP)}
    rest, _ = restore_state(d, tpl)
    got = rest["params"].unpack()
    for k_ in tree:
        assert torch.equal(got[k_], tree[k_])
    v = rest["inbox"]["valid"]
    assert v.shape == (DP, 2) and not v.any()
    assert rest["inbox"]["t"] == 9

    # ...and fp32-wire ring -> int8-wire template
    legacy = {"params": state8["params"], "opt": {"step": 11},
              "inbox": dict(init_inbox_ring(state8["params"], 2, DP), t=11)}
    d2 = str(tmp_path / "cklegacy")
    save_state(d2, legacy, step=11, metadata={"wire_dtype": "fp32"})
    tpl8 = {"params": zero, "opt": {"step": 0},
            "inbox": init_wire_inbox_ring(zero, 2, DP,
                                          WireFormat(dtype="int8"))}
    rest8, _ = restore_state(d2, tpl8)
    assert not rest8["inbox"]["valid"].any() and rest8["inbox"]["t"] == 11
    for slot in rest8["inbox"]["slots"]:
        for pay in slot:
            assert isinstance(pay, dict)
            assert not decode_wire(pay).any()


# ------------------------------------------------- cross-package parity

KINDS = {"sync": dict(protocol="gossip"),
         "fp32_ring": dict(protocol="gossip_async", staleness=2),
         "int8_ring": dict(protocol="gossip_async", staleness=2,
                           wire_dtype="int8", gossip_subset=0.5)}


def _cfgs():
    """A reduced qwen3-0.6b with bf16 params, in both packages."""
    port = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=32),
                               param_dtype="bfloat16",
                               compute_dtype="float32")
    ref = dataclasses.replace(ref_reduced(ref_get_config("qwen3-0.6b"),
                                          d_model=32),
                              param_dtype="bfloat16", compute_dtype="float32")
    return port, ref


@pytest.fixture(scope="module")
def bridged():
    """Four replicas of the reference's init, apart by a seeded nudge."""
    _, ref_cfg = _cfgs()
    init = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0),
                                                ref_cfg)[0])
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: np.stack([(a.astype(np.float32) + 0.01 * r
                             * rng.normal(size=a.shape).astype(np.float32))
                            .astype(a.dtype) for r in range(DP)]), init)


def _port_state(tree4, kind, steps=0):
    """The port's state from its own init over the bridged weights, after
    ``steps`` train steps."""
    cfg, _ = _cfgs()
    opt = sgd(0.1, momentum=0.9)
    b = make_train_step_bundle(cfg, opt, dp=DP, gossip_packed=True,
                               device="cpu", **KINDS[kind])
    params = params_from_numpy(tree4, layout=b.layout, lead=(DP,),
                               device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=True, layout=b.layout,
                             params=params, device="cpu",
                             inbox=b.protocol.staleness, wire=b.wire)
    if steps:
        ds = ShardedTokenDataset(cfg.vocab, 16, n_shards=DP,
                                 batch_per_shard=2)
        tr = Trainer(b, state, ds, log_every=0)
        tr.run(steps)
        state = tr.state
    return state


def _ref_state(tree4, kind, seed=1):
    """The reference's state from its own init (packing, sgd's init, the
    ring bootstraps) over the bridged weights, with random momenta and
    ring payloads (the int8 ring with zero payloads where a subset would
    not have sent)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(jnp.asarray, tree4)
    packed = RPackedParams.pack(tree, skip_leading=1)
    lay = packed.layout
    assert lay == ref_build_layout(tree, skip_leading=1)

    def noisy(b, scale=1.0):
        x = rng.normal(size=b.shape).astype(np.float32) * scale
        return jnp.asarray(x).astype(b.dtype)

    opt = ref_sgd(0.1, momentum=0.9).init(packed)
    opt = {"step": jnp.int32(5),
           "mom": RPackedParams([noisy(b) for b in opt["mom"].buckets], lay)}
    state = {"params": packed, "opt": opt}
    if kind == "fp32_ring":
        ring = ref_init_ring(packed, 2, DP)
        state["inbox"] = dict(
            ring, slots=tuple(RPackedParams([b + noisy(b) for b in
                                             packed.buckets], lay)
                              for _ in ring["slots"]),
            valid=jnp.asarray([[1, 0], [1, 1], [0, 1], [1, 1]], jnp.float32),
            t=jnp.int32(5))
    elif kind == "int8_ring":
        wire = RQ.WireFormat(dtype="int8", subset=0.5)
        ring = ref_init_wire_ring(packed, 2, DP, wire)
        slots = tuple(tuple(
            RQ.encode_wire(b + noisy(b), "int8",
                           keys=RQ.wire_key(j, jnp.arange(DP), i, 0))
            if (i + j) % 2 else RQ.zero_payload_like(b, "int8")
            for i, b in enumerate(packed.buckets)) for j in range(2))
        state["inbox"] = dict(ring, slots=slots, t=jnp.int32(5),
                              valid=jnp.asarray([[1, 1], [0, 1], [1, 0],
                                                 [1, 1]], jnp.float32))
    return state


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_checkpoint_restores_in_port(tmp_path, bridged, kind):
    ref_state = _ref_state(bridged, kind)
    d = str(tmp_path / "ck")
    ref_save(d, ref_state, metadata={"protocol": KINDS[kind]["protocol"]},
             step=5)
    port_tpl = _port_state(bridged, kind)
    rest, man = restore_state(d, port_tpl)
    assert man["step"] == 5 and rest["opt"]["step"] == 5
    for b in rest["params"].buckets:
        assert b.requires_grad and b.is_leaf
    _assert_same(_port_flat(rest), _ref_flat(ref_state))


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_checkpoint_restores_in_reference(tmp_path, bridged, kind):
    """A trained port state (2 steps: its ring holds real payloads and,
    under the subset, zero payloads of unsent buckets) restores in the
    reference bit for bit."""
    state = _port_state(bridged, kind, steps=2)
    d = str(tmp_path / "ck")
    save_state(d, state, metadata={"protocol": KINDS[kind]["protocol"]},
               step=2)
    rest, man = ref_restore(d, _ref_state(bridged, kind, seed=9))
    assert int(rest["opt"]["step"]) == 2
    _assert_same(_ref_flat(rest), _port_flat(state))


@pytest.mark.parametrize("arch", ["whisper-base", "jamba-v0.1-52b"])
def test_model_states_cross_the_packages_both_ways(tmp_path, arch):
    """The npz + manifest format on the encoder-decoder and MoE trees
    (``encoder.{layers,norm,pos}``, ``norm_x``, ``cross``; ``ff.{router,
    w_gate,w_in,w_out}`` beside Mamba layers): a reduced bf16 packed sync
    sgd state of the reference's restores in the port, and the port's,
    trained 2 steps, restores in the reference, bit for bit."""
    # bf16 compute too: whisper's encoder casts its frames to the compute
    # dtype, and the port's weight products take one dtype
    port_cfg = dataclasses.replace(reduced(get_config(arch), d_model=32),
                                   param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch),
                                              d_model=32),
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0),
                                                ref_cfg)[0])
    rng = np.random.default_rng(0)
    tree2 = jax.tree.map(lambda a: np.stack([a, (a.astype(np.float32) + 0.01
                                                 * rng.normal(size=a.shape)
                                                 .astype(np.float32))
                                             .astype(a.dtype)]), tree)
    opt = sgd(0.1, momentum=0.9)

    def port_state(steps):
        b = make_train_step_bundle(port_cfg, opt, dp=2, gossip_packed=True,
                                   remat=False, device="cpu")
        state = init_train_state(port_cfg, opt, dp=2, packed=True,
                                 layout=b.layout, device="cpu",
                                 params=params_from_numpy(
                                     tree2, layout=b.layout, lead=(2,),
                                     device="cpu"))
        for s in range(steps):
            batch = {"tokens": torch.from_numpy(np.random.default_rng(s)
                                                .integers(0, 512, (2, 2, 9)))}
            if port_cfg.encoder is not None:
                batch["audio_frames"] = torch.from_numpy(
                    np.random.default_rng(s).standard_normal(
                        (2, 2, 16, 32)).astype(np.float32) * 0.02)
            state, _, _ = b.step(state, batch, s, rotate=False)
        return state

    packed = RPackedParams.pack(jax.tree.map(jnp.asarray, tree2),
                                skip_leading=1)
    mom = RPackedParams([jnp.asarray(rng.normal(size=x.shape).astype(
        np.float32)).astype(x.dtype) for x in packed.buckets], packed.layout)
    ref_state = {"params": packed, "opt": {"step": jnp.int32(5), "mom": mom}}
    d = str(tmp_path / "ref")
    ref_save(d, ref_state, metadata={"protocol": "gossip"}, step=5)
    rest, man = restore_state(d, port_state(0))
    assert man["step"] == 5 and rest["opt"]["step"] == 5
    _assert_same(_port_flat(rest), _ref_flat(ref_state))
    trained = port_state(2)
    d = str(tmp_path / "port")
    save_state(d, trained, metadata={"protocol": "gossip"}, step=2)
    back, _ = ref_restore(d, ref_state)
    assert int(back["opt"]["step"]) == 2
    _assert_same(_ref_flat(back), _port_flat(trained))


# --------------------------------------------- resume determinism, dp=4

RESUME = {"sync": dict(protocol="gossip"),
          "async_int8_sub0.5": dict(protocol="gossip_async", staleness=2,
                                    drop_rate=0.2, wire_dtype="int8",
                                    gossip_subset=0.5)}


@pytest.fixture
def deterministic():
    """The CPU's ``index_put_(accumulate=True)`` (the embedding gather's
    backward) adds in parallel in no fixed order unless deterministic
    algorithms are on; the reference's XLA program is deterministic."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("case", list(RESUME))
def test_resume_is_bit_equal_to_straight_run(tmp_path, case, deterministic):
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                              param_dtype="float32", compute_dtype="float32")
    opt = sgd(step_decay(0.3, 0.1, 3), momentum=0.9, weight_decay=1e-4)
    bundle = make_train_step_bundle(cfg, opt, dp=DP, gossip_packed=True,
                                    device="cpu", **RESUME[case])
    assert bundle.fused
    ds = ShardedTokenDataset(cfg.vocab, 16, n_shards=DP, batch_per_shard=2)

    def fresh(seed):
        return init_train_state(cfg, opt, dp=DP, packed=True,
                                layout=bundle.layout, seed=seed,
                                device="cpu", inbox=bundle.protocol.staleness,
                                wire=bundle.wire)

    straight = Trainer(bundle, fresh(0), ds, log_every=0)
    want = [h["loss"] for h in straight.run(8)]
    first = Trainer(bundle, fresh(0), ds, log_every=0)
    got = [h["loss"] for h in first.run(4)]
    d = str(tmp_path / "ck")
    save_state(d, first.state, step=4)
    resumed, man = restore_state(d, fresh(1))
    second = Trainer(bundle, resumed, ds, log_every=0)
    got += [h["loss"] for h in second.run(4, start_step=man["step"])]
    assert got == want
    _assert_same(_port_flat(second.state), _port_flat(straight.state))


# ---------------------------------------------------------- the launchers

LAUNCH = ["--smoke", "--packed", "--smoke-mesh", "1,4,1", "--seq-len", "16",
          "--global-batch", "8", "--d-model", "32", "--log-every", "0",
          "--protocol", "gossip_async", "--staleness", "2",
          "--drop-timeout", "0.2", "--wire-dtype", "int8",
          "--gossip-subset", "0.5"]

_REF_LAUNCHER = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro
from repro.launch.train import main
for argv in json.loads(sys.argv[1]):
    sys.argv = ["train"] + argv
    main()
"""


def _json_lines(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_port_launcher_resumes_the_reference_launchers_checkpoint(tmp_path,
                                                                   capsys):
    from repro_torch.launch.train import main
    d = str(tmp_path / "ck")
    runs = [LAUNCH + ["--steps", "2", "--checkpoint", d],
            LAUNCH + ["--steps", "4"]]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_LAUNCHER, json.dumps(runs)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    written, straight = _json_lines(r.stdout)
    assert read_manifest(d)["step"] == 2
    refused = str(tmp_path / "refused")
    shutil.copytree(d, refused)

    main(LAUNCH + ["--steps", "2", "--checkpoint", d, "--resume",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"resumed {d} at step 2" in out
    (res,) = _json_lines(out)
    assert res["start_step"] == 2 and written["start_step"] == 0
    np.testing.assert_allclose(res["final_loss"], straight["final_loss"],
                               rtol=2e-4)
    man = read_manifest(d)
    assert man["step"] == 4 and man["metadata"]["protocol"] == "gossip_async"
    assert man["metadata"]["phase"] == 0 and man["metadata"]["staleness"] == 2

    with pytest.raises(SystemExit, match="refusing"):
        main([a if a != "gossip_async" else "gossip" for a in LAUNCH]
             + ["--steps", "2", "--checkpoint", refused, "--resume",
                "--device", "cpu"])
