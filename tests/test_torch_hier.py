"""Shard-local (hierarchical) bucket layouts and the distribution plan in
the port, against the reference.

* ``models.lm_axes`` equals the axes tree the reference's ``lm_init``
  returns, for reduced qwen3 and falcon-mamba.
* ``train.sharding.make_distribution`` over ``launch.mesh.make_smoke_mesh``
  equals the reference's plan over a ``jax.sharding.AbstractMesh`` of the
  same axes (dp, dp_axes, shard axes, batch specs and every leaf spec) for
  ``replica``, ``fsdp`` and ``pure_dp`` on meshes (1, 4, 2), (2, 2, 2) and
  (2, 1, 1).
* Slot tables and packed bucket bytes equal the reference's
  ``build_layout`` / ``PackedParams.pack`` bit for bit: on
  ``tests/test_hier_packed.py``'s tree (fp32 and bf16, with and without a
  leading replica axis), and on reduced qwen3 through the reference's
  ``_build_packed_layout``; unpack round-trips and gradients arrive packed.
* The port's stacked packed engines on a shard-local layout equal the
  reference's oracles bit for bit on ``tests/test_hier_packed.py``'s engine
  cases: ``gossip_mix_sim`` (sync), ``gossip_mix_sim_delayed_k`` (k 1, 2;
  drop 0, 0.4), and the fused composition (sync and async); the int8 ring
  equals ``gossip_mix_sim_quantized_k`` on the reference's shard-local
  buckets, and the whole-row wire encode equals the reference's per-shard
  encode at ``base_index = shard * stride``.
* Shard-local trajectories equal flat-layout ones bit for bit (fp32 wire;
  sgd and adamw; fused and unfused; sync and async); lars's fused backend
  is refused and its unfused trust ratios equal the flat layout's within
  rtol 2e-6.
* Checkpoints interchange shard-local, flat and per-leaf states, and the
  reference's one-device flat-packed state; a k = 1 ring mask-pads into
  k = 2.
* The launcher runs ``--packed --smoke-mesh 1,2,2``; one subprocess with 8
  forced host devices trains the reference's fsdp (2, 2, 2) packed runs,
  and the port's stacked runs from the same weights match within rtol =
  atol = 2e-4.
"""
import dataclasses
import functools
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
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.core import simulate as R  # noqa: E402
from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.async_gossip import init_inbox_ring as ref_init_ring  # noqa: E402
from repro.core.async_gossip import (  # noqa: E402
    init_wire_inbox_ring as ref_init_wire_ring)
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro_torch.checkpoint import (array_to_torch,  # noqa: E402
                                    params_from_numpy, restore_state,
                                    save_state)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (LANE, PackedParams, build_layout,  # noqa: E402
                              build_schedule, check_layout_mesh,
                              make_packed_async_gossip_mix,
                              make_packed_fused_async_update,
                              make_packed_fused_update,
                              make_packed_gossip_mix, packed_param_specs)
from repro_torch.core.async_gossip import (init_inbox_ring,  # noqa: E402
                                           init_wire_inbox_ring)
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.kernels.quantize import WireFormat, encode_wire  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.mesh_spec import MeshSpec  # noqa: E402
from repro_torch.mesh_spec import PartitionSpec as P  # noqa: E402
from repro_torch.models import lm_axes, lm_specs, reduced  # noqa: E402
from repro_torch.optim import adamw, lars, sgd, step_decay  # noqa: E402
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_distribution, make_train_step_bundle)
from repro_torch.train.step import _build_packed_layout  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHARD_AXES, SHARD_SIZES = ("data", "model"), (2, 2)
MESHES = [(1, 4, 2), (2, 2, 2), (2, 1, 1)]
MODES = ["replica", "fsdp", "pure_dp"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view({1: torch.uint8, 4: torch.int32}[x.element_size()]
                      ).numpy()
    a = np.asarray(x)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _same(got, want):
    """Two leaf lists (or trees) equal bit for bit."""
    g = got if isinstance(got, list) else tree_flatten(got)[0]
    w = want if isinstance(want, list) else jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(np.shape(a)) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _np_tree(dtype=np.float32, lead=()):
    """``tests/test_hier_packed.py``'s tree as numpy arrays."""
    rng = np.random.default_rng(3)
    mk = lambda *s: np.asarray(  # noqa: E731
        jnp.asarray(rng.normal(size=lead + s), jnp.float32).astype(dtype))
    return {"emb": mk(8, 6), "ffn": mk(4, 6, 11), "norm": mk(130,),
            "b": mk(1,)}


def _specs():
    return {"emb": P("data", None), "ffn": P("model", None, None),
            "norm": P(None), "b": P(None)}


def _ref_specs():
    return {"emb": JP("data", None), "ffn": JP("model", None, None),
            "norm": JP(None), "b": JP(None)}


def _layouts(np_tree, skip):
    tt = tree_map(lambda a: array_to_torch(a, "cpu"), np_tree)
    port = build_layout(tt, skip_leading=skip, shard_axes=SHARD_AXES,
                        shard_axis_sizes=SHARD_SIZES, shard_specs=_specs())
    ref = ref_build_layout(jax.tree.map(jnp.asarray, np_tree),
                           skip_leading=skip, shard_axes=SHARD_AXES,
                           shard_axis_sizes=SHARD_SIZES,
                           shard_specs=_ref_specs())
    return tt, port, ref


def _slot_table(layout):
    return [(s.index, s.bucket, s.offset, s.size, tuple(s.shape),
             str(s.dtype), s.shard, tuple(s.factors), tuple(s.block),
             s.chunk_start) for s in layout.slots]


def _same_layout(port, ref):
    assert _slot_table(port) == _slot_table(ref)
    assert port.bucket_sizes == ref.bucket_sizes
    assert port.strides == ref.strides
    assert port.bucket_dtypes == ref.bucket_dtypes
    assert (port.num_shards, port.shard_axes, port.shard_axis_sizes) == (
        ref.num_shards, ref.shard_axes, ref.shard_axis_sizes)


def _cfg(arch="qwen3-0.6b", d=32, **kw):
    return dataclasses.replace(reduced(get_config(arch), d_model=d),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


def _ref_cfg(arch="qwen3-0.6b", d=32, **kw):
    from repro.configs import get_config as rget
    from repro.models import reduced as rreduced
    return dataclasses.replace(rreduced(rget(arch), d_model=d),
                               param_dtype="float32",
                               compute_dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _ref_shapes_axes(arch="qwen3-0.6b", d=32):
    """The reference's ``lm_init`` params as shapes (traced, not run) and
    its axes tree."""
    from repro.models import lm_init as ref_lm_init
    box = {}

    def init():
        params, box["axes"] = ref_lm_init(jax.random.key(0),
                                          _ref_cfg(arch, d))
        return params

    return jax.eval_shape(init), box["axes"]


def _ref_mesh(mesh):
    return AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names))


@pytest.fixture(autouse=True)
def one_thread():
    """These tensors are tiny: one intra-op thread keeps a test from
    contending with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def deterministic():
    """The CPU embedding gather's backward (``index_put_`` with accumulate)
    adds in parallel in no fixed order unless deterministic algorithms are
    on; bit-for-bit trajectory tests need them."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


# ----------------------------------------------------------- axes and plan

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_lm_axes_equal_the_references(arch):
    shapes, want = _ref_shapes_axes(arch)
    assert lm_axes(_cfg(arch)) == want
    got = tree_map(lambda s: tuple(s.shape), lm_specs(_cfg(arch)))
    assert got == jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("mode", MODES)
def test_distribution_equals_the_references(mode, shape):
    from repro.train import make_distribution as ref_make_distribution
    pod, data, model = shape
    mesh = make_smoke_mesh(data, model, pod=pod)
    got = make_distribution(mesh, mode)
    want = ref_make_distribution(_ref_mesh(mesh), mode)
    for k in ("dp", "dp_axes", "shard_axes", "shard_axis_sizes",
              "batch_axes", "multi_pod", "axis_names"):
        assert getattr(got, k) == getattr(want, k), k
    for nd in (2, 3):
        assert tuple(got.replica_batch_spec(nd)) == tuple(
            want.replica_batch_spec(nd))
        assert tuple(got.batch_spec(nd)) == tuple(want.batch_spec(nd))
    # every leaf of the reduced model, with the replica axis, as the
    # reference's state carries it (vocab 256 and d 64 divide each axis)
    cfg = _cfg(d=64)
    rparams, raxes = _ref_shapes_axes(d=64)
    dp = max(want.dp, 1)
    rshapes = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((dp,) + s.shape, s.dtype), rparams)
    rspecs = want.param_specs(rshapes, jax.tree.map(lambda a: "," + a, raxes),
                              replica_axis=True)
    stacked = tree_map(lambda s: s.stacked(dp), lm_specs(cfg))
    gspecs = got.param_specs(stacked, tree_map(lambda s: s.axes, stacked),
                             replica_axis=True)
    g = tree_flatten(lm_specs(cfg))[1].flatten_up_to(gspecs)
    w = jax.tree.leaves(rspecs, is_leaf=lambda x: isinstance(x, JP))
    assert [tuple(s) for s in g] == [tuple(s) for s in w]


# --------------------------------------------------------------- layouts

@pytest.mark.parametrize("lead", [(), (2,)], ids=["nolead", "lead2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_tables_and_packed_bytes_equal_the_references(dtype, lead):
    np_tree = _np_tree(jnp.bfloat16 if dtype == "bfloat16" else np.float32,
                       lead)
    tt, port, ref = _layouts(np_tree, len(lead))
    _same_layout(port, ref)
    assert port.hierarchical and port.num_shards == 4
    got = PackedParams.pack(tt, port)
    want = RefPacked.pack(jax.tree.map(jnp.asarray, np_tree), ref)
    _same(list(got.buckets), list(want.buckets))
    # unpack round-trips every leaf
    _same(got.unpack(), jax.tree.map(jnp.asarray, np_tree))


def test_partition_invariants():
    """Pieces tile every leaf exactly once; offsets LANE-aligned within
    each shard's stride; bucket totals = shards * stride; no overlap."""
    _, layout, _ = _layouts(_np_tree(), 0)
    sizes = {}
    for s in layout.slots:
        assert s.offset % LANE == 0
        assert s.offset + s.size <= layout.strides[s.bucket]
        sizes[s.index] = sizes.get(s.index, 0) + s.size
    assert [sizes[i] for i in range(layout.num_leaves)] == [
        int(np.prod(sh)) for sh in layout.leaf_shapes]
    for total, stride in zip(layout.bucket_sizes, layout.strides):
        assert total == stride * layout.num_shards and stride % LANE == 0
    for b in range(layout.num_buckets):
        for sh in range(layout.num_shards):
            spans = sorted((x.offset, x.offset + x.size) for x in layout.slots
                           if x.bucket == b and x.shard == sh)
            assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))


def test_gradients_arrive_packed():
    np_tree = _np_tree(lead=(2,))
    tt, layout, _ = _layouts(np_tree, 1)
    packed = PackedParams.pack(tt, layout)
    for b in packed.buckets:
        b.requires_grad_(True)
    sum((x * x).sum() for x in tree_flatten(packed.unpack())[0]).backward()
    for b in packed.buckets:
        assert torch.equal(b.grad, 2 * b.detach())   # padding grads are 0
    grads = PackedParams([b.grad for b in packed.buckets], layout).unpack()
    for k in tt:
        assert torch.equal(grads[k], 2 * tt[k])


def test_flat_layout_is_the_no_shard_case_and_specs():
    tt, hier, _ = _layouts(_np_tree(), 0)
    flat = build_layout(tt)
    also = build_layout(tt, shard_axes=(), shard_axis_sizes=())
    assert _slot_table(flat) == _slot_table(also)
    assert flat.strides == flat.bucket_sizes and not flat.hierarchical
    specs = packed_param_specs(hier, ("pod",))
    assert all(s == P("pod", ("data", "model")) for s in specs.buckets)
    assert all(s == P(("pod", "data"), None)
               for s in packed_param_specs(flat, ("pod", "data")).buckets)
    with pytest.raises(ValueError, match="shard"):
        packed_param_specs(hier, ("data",))
    check_layout_mesh(hier, make_smoke_mesh(2, 2, pod=2))
    with pytest.raises(ValueError, match="rebuild"):
        check_layout_mesh(hier, make_smoke_mesh(4, 2, pod=2))
    with pytest.raises(ValueError, match="not in mesh"):
        check_layout_mesh(hier, MeshSpec(("pod", "x"), (2, 2)))


@pytest.mark.parametrize("mode,shape", [("replica", (1, 4, 2)),
                                        ("fsdp", (2, 2, 2))],
                         ids=["replica-1x4x2", "fsdp-2x2x2"])
def test_qwen3_layout_and_bytes_equal_the_references(mode, shape):
    """The reference's ``_build_packed_layout`` on reduced qwen3 (through
    ``train_input_specs``, as its launcher builds it) against the port's;
    the bridged init packs to the same bytes."""
    from repro.launch.specs import train_input_specs
    from repro.models import lm_init as ref_lm_init
    from repro.optim import sgd as ref_sgd
    from repro.train import make_distribution as ref_make_distribution
    from repro.train.step import _build_packed_layout as ref_build
    from repro.train.step import state_specs_of
    pod, data, model = shape
    mesh = make_smoke_mesh(data, model, pod=pod)
    dist = make_distribution(mesh, mode)
    rdist = ref_make_distribution(_ref_mesh(mesh), mode)
    rcfg = _ref_cfg(d=64, dist_mode=mode)
    ss, sa, _ = train_input_specs(rcfg, rdist, 8, 2 * rdist.dp, ref_sgd(0.1))
    ref = ref_build(rdist, ss["params"],
                    state_specs_of(rdist, ss, sa)["params"])
    port = _build_packed_layout(dist, _cfg(d=64, dist_mode=mode))
    _same_layout(port, ref)
    assert port.num_shards == int(np.prod(dist.shard_axis_sizes)) > 1
    init = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0), rcfg)[0])
    rep = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (dist.dp,)
                                                  + a.shape), init)
    want = RefPacked.pack(rep, ref)
    got = params_from_numpy(init, layout=port, lead=(dist.dp,), device="cpu")
    _same(list(got.buckets), list(want.buckets))


# ------------------------------------------------- engines vs the oracles

ENGINE_P = 2


def _engine_inputs():
    rng = np.random.default_rng(2)
    tree = {"emb": rng.normal(size=(ENGINE_P, 8, 6)).astype(np.float32),
            "ffn": rng.normal(size=(ENGINE_P, 4, 6, 11)).astype(np.float32),
            "norm": rng.normal(size=(ENGINE_P, 130)).astype(np.float32),
            "b": rng.normal(size=(ENGINE_P, 1)).astype(np.float32)}
    tt, layout, ref_layout = _layouts(tree, 1)
    sched = build_schedule(ENGINE_P, num_rotations=2, seed=11)
    return tree, tt, layout, ref_layout, sched


def _pack(tt, layout):
    return PackedParams.pack(tree_map(lambda x: x.clone(), tt), layout)


def test_sync_engine_equals_gossip_mix_sim():
    tree, tt, layout, _, sched = _engine_inputs()
    mix = make_packed_gossip_mix(sched, layout,
                                 mesh=make_smoke_mesh(2, 2, pod=2))
    got, want = _pack(tt, layout), jax.tree.map(jnp.asarray, tree)
    for t in range(sched.period):
        got = mix(got, t)
        want = R.gossip_mix_sim(want, jnp.asarray(sched.recv_from(t)))
        _same(got.unpack(), want)


@pytest.mark.parametrize("rate", [0.0, 0.4], ids=["nodrop", "drop40"])
@pytest.mark.parametrize("k", [1, 2])
def test_async_engine_equals_delayed_k(k, rate):
    tree, tt, layout, _, sched = _engine_inputs()
    mix = make_packed_async_gossip_mix(sched, layout, staleness=k,
                                       drop_rate=rate, drop_seed=5)
    got = _pack(tt, layout)
    ring = init_inbox_ring(got, k, ENGINE_P)
    want = jax.tree.map(jnp.asarray, tree)
    wring = ref_init_ring(want, k, ENGINE_P)
    for t in range(2 * sched.period):
        got, ring = mix(got, ring, t)
        ok = ref_exchange_ok(wring["t"], jnp.arange(ENGINE_P), 5, rate)
        want, wring = R.gossip_mix_sim_delayed_k(
            want, wring, jnp.asarray(sched.recv_from(t % sched.period)), 0.5,
            ok)
        _same(got.unpack(), want)
        _same(ring["slots"][-1].unpack(), wring["slots"][-1])
        np.testing.assert_array_equal(ring["valid"],
                                      np.asarray(wring["valid"]))


def _ref_sgd_step(params, grads, mom, lr=0.1, momentum=0.9):
    """The reference's sgd update (``repro.optim.sgd``) on leaf trees."""
    from repro.optim import sgd as ref_sgd
    opt = ref_sgd(lr, momentum=momentum)
    st = {"step": jnp.zeros((), jnp.int32), "mom": mom}
    new, st = opt.update(params, grads, st)
    return new, st["mom"]


def test_fused_sync_engine_equals_the_composition():
    """Mix with the partner's pre-update params, then sgd at the mixed
    point (the reference's fused algebra), every phase."""
    tree, tt, layout, _, sched = _engine_inputs()
    opt = sgd(0.1, momentum=0.9)
    grads = tree_map(lambda x: x * 0.1 + 0.01, tt)
    gp = PackedParams.pack(grads, layout)
    fup = make_packed_fused_update(sched, layout, opt, alpha=0.5)
    got = _pack(tt, layout)
    st = opt.init(got)
    want = jax.tree.map(jnp.asarray, tree)
    wgrads = jax.tree.map(lambda x: x * 0.1 + 0.01, want)
    wmom = jax.tree.map(jnp.zeros_like, want)
    for t in range(sched.period):
        got, st = fup(got, gp, st, t)
        rf = jnp.asarray(sched.recv_from(t))
        mixed = jax.tree.map(
            lambda a: (a.astype(jnp.float32) * 0.5
                       + a[rf].astype(jnp.float32) * 0.5).astype(a.dtype),
            want)
        want, wmom = _ref_sgd_step(mixed, wgrads, wmom)
        _same(got.unpack(), want)


@pytest.mark.parametrize("rate", [0.0, 0.4], ids=["nodrop", "drop40"])
@pytest.mark.parametrize("k", [1, 2])
def test_fused_async_engine_equals_the_composition(k, rate):
    tree, tt, layout, _, sched = _engine_inputs()
    opt = sgd(0.1, momentum=0.9)
    grads = tree_map(lambda x: x * 0.1 + 0.01, tt)
    fau = make_packed_fused_async_update(sched, layout, opt, alpha=0.5,
                                         staleness=k, drop_rate=rate,
                                         drop_seed=3)
    got = _pack(tt, layout)
    st = opt.init(got)
    ring = init_inbox_ring(got, k, ENGINE_P)
    want = jax.tree.map(jnp.asarray, tree)
    wgrads = jax.tree.map(lambda x: x * 0.1 + 0.01, want)
    wmom = jax.tree.map(jnp.zeros_like, want)
    wring = ref_init_ring(want, k, ENGINE_P)
    for t in range(2 * sched.period):
        got, st, ring = fau(got, PackedParams.pack(grads, layout), ring, st,
                            t)
        valid = wring["valid"]
        a = 0.5 * valid[:, 0]
        mix = jax.tree.map(
            lambda x, b: x * (1 - a.reshape((-1,) + (1,) * (x.ndim - 1)))
            + b * a.reshape((-1,) + (1,) * (x.ndim - 1)),
            want, wring["slots"][0])
        rf = jnp.asarray(sched.recv_from(t % sched.period))
        payload = jax.tree.map(lambda q: q[rf], want)
        ok = ref_exchange_ok(wring["t"], jnp.arange(ENGINE_P), 3, rate)
        wring = {"slots": tuple(wring["slots"][1:]) + (payload,),
                 "valid": jnp.concatenate([valid[:, 1:], ok[:, None]], 1),
                 "t": wring["t"] + 1}
        want, wmom = _ref_sgd_step(mix, wgrads, wmom)
        _same(got.unpack(), want)


def test_int8_ring_equals_quantized_k_on_the_references_buckets():
    """The port's packed async engine, int8 wire at subset 0.5 on the
    shard-local layout, against ``gossip_mix_sim_quantized_k`` over the
    reference's shard-local buckets: params, the newest slot's codes and
    scales, and ``valid``, every step."""
    from repro.kernels.quantize import WireFormat as RefWire
    tree, tt, layout, ref_layout, sched = _engine_inputs()
    k, rate = 2, 0.3
    wire = WireFormat("int8", 0.5, seed=3)
    mix = make_packed_async_gossip_mix(sched, layout, staleness=k,
                                       drop_rate=rate, drop_seed=1, wire=wire)
    got = _pack(tt, layout)
    ring = init_wire_inbox_ring(got, k, ENGINE_P, wire)
    want = list(RefPacked.pack(jax.tree.map(jnp.asarray, tree),
                               ref_layout).buckets)
    rwire = RefWire("int8", 0.5, seed=3)
    wring = ref_init_wire_ring(RefPacked(want, ref_layout), k, ENGINE_P,
                               rwire)
    wring = dict(wring, slots=tuple(tuple(s.buckets) if isinstance(
        s, RefPacked) else tuple(s) for s in wring["slots"]))
    for t in range(2 * sched.period + k):
        got, ring = mix(got, ring, t % sched.period)
        ok = ref_exchange_ok(wring["t"], jnp.arange(ENGINE_P), 1, rate)
        want, wring = R.gossip_mix_sim_quantized_k(
            want, wring, jnp.asarray(sched.recv_from(t % sched.period)),
            wire=rwire, ok=ok)
        _same(list(got.buckets), list(want))
        for g, w in zip(ring["slots"][-1], wring["slots"][-1]):
            g = [g["q"], g["s"]] if isinstance(g, dict) else [g]
            w = [w["q"], w["s"]] if isinstance(w, dict) else [w]
            _same(g, w)
        np.testing.assert_array_equal(ring["valid"],
                                      np.asarray(wring["valid"]))


def test_whole_row_wire_encode_is_the_per_shard_encode():
    """Encoding a shard-local bucket's whole row at base index 0 is the
    reference's per-shard encode at ``base_index = shard * stride``: the
    noise is keyed by the global element index and no 128-element scale
    tile crosses a shard boundary (``stride % 128 == 0``)."""
    from repro.kernels.quantize import encode_wire as ref_encode
    from repro.kernels.quantize import wire_key as ref_wire_key
    from repro_torch.kernels.quantize import wire_key
    _, tt, layout, _, _ = _engine_inputs()
    bucket = PackedParams.pack(tt, layout).buckets[0]
    stride = layout.strides[0]
    assert stride % LANE == 0 and bucket.shape[-1] == 4 * stride
    keys = wire_key(7, np.arange(ENGINE_P), 0, 5)
    got = encode_wire(bucket, "int8", keys=keys)
    rkeys = ref_wire_key(7, jnp.arange(ENGINE_P), 0, 5)
    x = jnp.asarray(bucket.numpy())
    parts = [ref_encode(x[:, s * stride:(s + 1) * stride], "int8",
                        keys=rkeys, base_index=s * stride)
             for s in range(layout.num_shards)]
    want_q = np.concatenate([np.asarray(p["q"]) for p in parts], -1)
    want_s = np.concatenate([np.asarray(p["s"]) for p in parts], -1)
    np.testing.assert_array_equal(got["q"].numpy(), want_q)
    np.testing.assert_array_equal(_bits(got["s"]), _bits(want_s))


# ---------------------------------------------- shard-local == flat runs

def _run(dist, opt_name, fused, protocol, steps=3, lr=0.1, **extra):
    cfg = _cfg()
    opt = {"sgd": lambda: sgd(step_decay(lr, 0.1, 2), momentum=0.9),
           "adamw": lambda: adamw(1e-3, weight_decay=0.02),
           "lars": lambda: lars(0.1, weight_decay=1e-4)}[opt_name]()
    kw = dict(staleness=2, drop_rate=0.3) if protocol == "gossip_async" \
        else {}
    bundle = make_train_step_bundle(cfg, opt, dist=dist, protocol=protocol,
                                    gossip_packed=True, fused_update=fused,
                                    device="cpu", **kw, **extra)
    from repro_torch.models import lm_init
    init = lm_init(cfg, seed=0, device="cpu")
    state = init_train_state(cfg, opt, dist=dist, packed=True,
                             layout=bundle.layout, params=init, device="cpu",
                             inbox=bundle.protocol.staleness,
                             wire=bundle.wire)
    ds = ShardedTokenDataset(cfg.vocab, 8, n_shards=dist.dp,
                             batch_per_shard=2)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(steps)
    return bundle, [h["loss"] for h in hist], tr.state


@pytest.mark.parametrize("protocol", ["gossip", "gossip_async"],
                         ids=["sync", "async"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_shard_local_trajectory_is_the_flat_one(opt_name, fused, protocol,
                                                deterministic):
    """dp 2 on mesh (1, 2, 2) (replica mode: model shards each replica in
    2) against the flat layout over dp 2, bit for bit: losses, params,
    moments and ring slots through the leaf view."""
    hier = make_distribution(make_smoke_mesh(2, 2), "replica")
    flat = make_distribution(make_smoke_mesh(2, 1), "replica")
    bh, lh, sh = _run(hier, opt_name, fused, protocol)
    bf, lf, sf = _run(flat, opt_name, fused, protocol)
    assert bh.layout.num_shards == 2 and bf.layout.num_shards == 1
    assert bh.fused == bf.fused == fused
    assert lh == lf
    for key in ("params", "opt", "inbox"):
        if key in sf:
            _same(_leaf_view(sh[key]), _leaf_view(sf[key]))


def _leaf_view(node):
    """Every tensor of a state subtree, a ``PackedParams`` by its leaves."""
    out = []
    if isinstance(node, PackedParams):
        return [x.detach() for x in tree_flatten(node.unpack())[0]]
    if isinstance(node, dict):
        for k in sorted(node):
            out += _leaf_view(node[k])
    elif isinstance(node, (list, tuple)):
        for v in node:
            out += _leaf_view(v)
    elif isinstance(node, torch.Tensor):
        out.append(node.detach())
    elif isinstance(node, np.ndarray):
        out.append(torch.from_numpy(node))
    return out


def test_fsdp_plan_runs_async_int8_and_lars_rules(deterministic):
    """fsdp on (2, 2, 2): dp 2 over pods, 4 shards; the int8 async ring
    runs fused and unfused; lars defaults to unfused there and refuses a
    fused request; a replica group with in-replica shards is refused."""
    dist = make_distribution(make_smoke_mesh(2, 2, pod=2), "fsdp")
    assert dist.dp == 2 and dist.shard_axes == ("data", "model")
    for fused in (True, False):
        b, losses, _ = _run(dist, "sgd", fused, "gossip_async", steps=2,
                            wire_dtype="int8", gossip_subset=0.5)
        assert b.layout.num_shards == 4 and all(np.isfinite(losses))
    b, losses, _ = _run(dist, "lars", None, "gossip", steps=2)
    assert not b.fused and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="shard-local"):
        _run(dist, "lars", True, "gossip")
    from repro_torch.core import ReplicaGroup
    with pytest.raises(NotImplementedError, match="ROADMAP A.12b"):
        make_train_step_bundle(_cfg(), sgd(0.1), dist=dist, device="cpu",
                               group=ReplicaGroup(0, 2, "gloo",
                                                  torch.device("cpu")))


def test_lars_fused_refused_and_unfused_trust_equals_flat(monkeypatch):
    """lars's fused backend raises on a shard-local bucket; its tree-level
    update takes each trust ratio over the whole leaf, equal to the flat
    layout's within rtol 2e-6, and writes the update back into the
    buckets."""
    import repro_torch.optim.optimizers as O
    tree, tt, layout, _, _ = _engine_inputs()
    opt = lars(0.1, weight_decay=1e-4)
    assert not opt.fused_shard_local and opt.packed_aware
    assert not opt.elementwise
    packed = _pack(tt, layout)
    grads = PackedParams.pack(tree_map(lambda x: x * 0.1, tt), layout)
    mom = PackedParams.pack(tree_map(torch.zeros_like, tt), layout)
    with pytest.raises(ValueError, match="shard-local"):
        opt.fused_update(0, packed.buckets[0], grads.buckets[0], None,
                         (mom.buckets[0],), step=0, alpha=0.0, layout=layout)
    trusts = []
    real = O._trust

    def spy(wn, gn, **kw):
        out = real(wn, gn, **kw)
        trusts[-1].append(float(out))
        return out

    monkeypatch.setattr(O, "_trust", spy)
    outs = []
    for lay in (layout, build_layout(tt, skip_leading=1)):
        p = _pack(tt, lay)
        g = PackedParams.pack(tree_map(lambda x: x * 0.1, tt), lay)
        trusts.append([])
        p, st = opt.update(p, g, opt.init(p))
        outs.append((p.unpack(), st["mom"].unpack()))
    np.testing.assert_allclose(trusts[0], trusts[1], rtol=2e-6)
    assert trusts[0] != [1.0] * len(trusts[0])
    for a, b in zip(tree_flatten(outs[0])[0], tree_flatten(outs[1])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6,
                                   atol=1e-7)
    assert not torch.equal(outs[0][0]["emb"], tt["emb"])


# ----------------------------------------------------------- checkpoints

def test_checkpoints_interchange_shard_local_flat_and_leaf(tmp_path):
    np_tree = _np_tree(lead=(2,))
    tt, hier, _ = _layouts(np_tree, 1)
    flat = build_layout(tt, skip_leading=1)
    states = {
        "hier": {"params": PackedParams.pack(tt, hier), "opt": {"step": 7}},
        "leaf": {"params": tree_map(lambda x: x.clone(), tt),
                 "opt": {"step": 7}},
        "flat": {"params": PackedParams.pack(tt, flat), "opt": {"step": 7}},
    }
    for src, state in states.items():
        d = str(tmp_path / src)
        save_state(d, state, step=7)
        for dst, tpl in states.items():
            rest, man = restore_state(d, tpl)
            assert man["step"] == 7 and rest["opt"]["step"] == 7
            got = rest["params"]
            if isinstance(got, PackedParams):
                assert got.layout is tpl["params"].layout
                got = got.unpack()
            _same(got, jax.tree.map(jnp.asarray, np_tree))


def test_shard_local_checkpoint_crosses_to_the_references_flat_state(
        tmp_path):
    """A port shard-local state restores into the reference's one-device
    flat-packed state, and back, bit for bit."""
    from repro.checkpoint import restore_state as ref_restore
    from repro.checkpoint import save_state as ref_save
    np_tree = _np_tree(lead=(2,))
    tt, hier, _ = _layouts(np_tree, 1)
    jt = jax.tree.map(jnp.asarray, np_tree)
    rstate = {"params": RefPacked.pack(jt, skip_leading=1),
              "opt": {"step": jnp.int32(3)}}
    pstate = {"params": PackedParams.pack(tt, hier), "opt": {"step": 3}}
    save_state(str(tmp_path / "port"), pstate, step=3)
    got, _ = ref_restore(str(tmp_path / "port"), rstate)
    _same(list(got["params"].buckets), list(rstate["params"].buckets))
    ref_save(str(tmp_path / "ref"), rstate, step=3)
    back, _ = restore_state(str(tmp_path / "ref"), pstate)
    _same(list(back["params"].buckets), list(pstate["params"].buckets))
    assert back["opt"]["step"] == 3


def test_ring_checkpoint_mask_pads_under_the_shard_local_layout(tmp_path):
    np_tree = _np_tree(lead=(2,))
    tt, hier, _ = _layouts(np_tree, 1)
    packed = PackedParams.pack(tt, hier)
    ring1 = dict(init_inbox_ring(packed, 1, 2),
                 valid=np.ones((2, 1), np.float32), t=9)
    save_state(str(tmp_path / "ck"), {"params": packed, "opt": {"step": 9},
                                      "inbox": ring1}, step=9)
    tpl = {"params": packed, "opt": {"step": 0},
           "inbox": init_inbox_ring(packed, 2, 2)}
    rest, _ = restore_state(str(tmp_path / "ck"), tpl)
    ring2 = rest["inbox"]
    assert len(ring2["slots"]) == 2 and ring2["t"] == 9
    assert isinstance(ring2["slots"][0], PackedParams)
    _same(ring2["slots"][0].unpack(), jax.tree.map(jnp.asarray, np_tree))
    np.testing.assert_array_equal(ring2["valid"],
                                  np.asarray([[1.0, 0.0]] * 2, np.float32))


# ------------------------------------------------------------- launcher

def test_launcher_runs_the_shard_local_layout(capsys):
    """``--packed --smoke-mesh 1,2,2`` (replica mode: dp 2, model shards
    each replica in 2) prints the flat run's losses and ``num_shards`` 2;
    ``--multi-pod`` is ignored; the per-leaf engine takes MODEL > 1."""
    from repro_torch.launch.train import main
    small = ["--smoke", "--steps", "2", "--seq-len", "8", "--global-batch",
             "4", "--d-model", "32", "--log-every", "0", "--device", "cpu"]
    runs = {}
    for mesh, extra in (("1,2,2", ["--packed", "--multi-pod"]),
                        ("1,2,1", ["--packed"]), ("1,2,2", [])):
        main([*small, "--smoke-mesh", mesh, *extra])
        runs[(mesh, bool(extra))] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    hier, flat = runs[("1,2,2", True)], runs[("1,2,1", True)]
    assert hier["num_shards"] == 2 and flat["num_shards"] == 1
    assert hier["dp"] == flat["dp"] == 2
    assert hier["first_loss"] == flat["first_loss"]
    np.testing.assert_allclose(hier["final_loss"], flat["final_loss"],
                               rtol=1e-6)
    assert runs[("1,2,2", False)]["packed"] is False


# ------------------------------------------- the reference's fsdp trainer

_E2E = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import repro
import dataclasses
import jax, numpy as np
from repro.configs import get_config
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model=64),
                          param_dtype="float32", compute_dtype="float32",
                          dist_mode="fsdp")
dist = make_distribution(make_smoke_mesh(2, 2, pod=2), "fsdp")
assert dist.dp == 2 and dist.shard_axes == ("data", "model")
opt = sgd(0.3, momentum=0.9)
ss, sa, bs = train_input_specs(cfg, dist, 24, 4, opt)
out = {"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}
bundle = make_train_step_bundle(
    cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
    protocol="gossip", remat=False, gossip_packed=True)
assert bundle.layout.num_shards == 4 and bundle.fused
state, _ = init_train_state(jax.random.key(0), cfg, dist, opt, packed=True,
                            layout=bundle.layout)
ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=24, n_shards=2,
                         batch_per_shard=2, seed=0)
out["losses"] = [h["loss"] for h in
                 Trainer(bundle, state, ds, log_every=0).run(6)]
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.mark.slow
def test_fsdp_training_matches_the_references_sharded_trainer(tmp_path,
                                                              deterministic):
    """The reference trains fsdp (2, 2, 2) packed on 8 forced host devices
    (its ``_E2E_SCRIPT``'s sync packed run, fused, the default); the port's
    stacked shard-local run from the same weights matches its losses within
    rtol = atol = 2e-4."""
    out = tmp_path / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _E2E, str(out)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:  # written by the subprocess above
        ref = pickle.load(f)
    cfg = _cfg(d=64, dist_mode="fsdp")
    dist = make_distribution(make_smoke_mesh(2, 2, pod=2), cfg.dist_mode)
    opt = sgd(0.3, momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dist=dist, gossip_packed=True,
                                    device="cpu")
    assert bundle.layout.num_shards == 4 and bundle.fused
    params = params_from_numpy(ref["init"], layout=bundle.layout,
                               lead=(dist.dp,), device="cpu")
    state = init_train_state(cfg, opt, dist=dist, packed=True,
                             layout=bundle.layout, params=params,
                             device="cpu")
    ds = ShardedTokenDataset(cfg.vocab, 24, n_shards=2, batch_per_shard=2,
                             seed=0)
    got = [h["loss"] for h in Trainer(bundle, state, ds, log_every=0).run(6)]
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, ref["losses"], **TOL)
