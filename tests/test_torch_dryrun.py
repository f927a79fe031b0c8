"""The port's launch tooling against the reference, on the CPU.

* ``core.gossip.gossip_bytes_per_step`` and ``wire_bytes_per_step`` equal
  the reference's dicts key for key and value for value: flat and (1, 4, 2)
  shard-local layouts of full-width qwen3-0.6b, a flat fp32 layout of a
  reduced one and ``tests/test_wire.py``'s tree, every wire dtype, subsets
  1 and 0.5; dp 1, 8 and 512 at 1 and 16 shards. The checks of
  ``tests/test_wire.py:303-323`` and ``tests/test_system.py:81-90`` run on
  the port. ``sent_bytes_at`` summed over a subset period is what the
  engines send, which the averaged ``total_bytes`` is not when the window
  wraps.
* ``kernels.ops.gossip_mix_flat`` / ``gossip_mix_tree`` equal the
  reference's (Pallas in interpret mode) in fp32 and bf16 on ragged
  lengths (``tests/test_kernels.py:20-45``'s cases), out of place: bit for
  bit at alpha 0, 0.5 and 1; elsewhere within the FMA gap of XLA:CPU
  (``_assert_mix_equal``).
* ``launch.specs``: ``param_count`` / ``active_param_count`` of all ten
  archs at full size, ``resolve_config`` and every input spec's shapes and
  dtypes for ten archs x four shapes, against the reference's
  ``jax.eval_shape`` trees (nothing allocated on either side).
* ``launch.counting``: FLOPs and op bytes of a reduced qwen3 train step and
  a reduced falcon-mamba decode step equal on ``meta`` and on the CPU.
* ``launch.dryrun.run_one`` on falcon-mamba-7b long_500k (the reference's
  ``tests/test_dryrun_integration.py`` record checks) and its pure-dp
  protocol invariant on qwen3-0.6b train_4k; ``launch.report`` renders
  the port's records.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.core import gossip as ref_gossip  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.kernels import gossip_mix_flat as ref_mix_flat  # noqa: E402
from repro.kernels import gossip_mix_tree as ref_mix_tree  # noqa: E402
from repro.kernels.quantize import WireFormat as RefWire  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core import (LANE, build_layout,  # noqa: E402
                              build_subset_schedule, gossip_bytes_per_step,
                              sent_bytes_at, wire_bytes_per_step)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import (gossip_mix, gossip_mix_1d,  # noqa: E402
                                 gossip_mix_flat, gossip_mix_tree)
from repro_torch.kernels.quantize import WireFormat  # noqa: E402
from repro_torch.launch import dryrun, report, specs  # noqa: E402
from repro_torch.launch.counting import CountingMode  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.launch.roofline import (H100, exchange_bytes,  # noqa: E402
                                         roofline_terms)
from repro_torch.models import lm_specs, reduced  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import make_distribution  # noqa: E402
from repro_torch.train.step import _build_packed_layout  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

WIRES = ["fp32", "bf16", "int8", "fp8"]


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread keeps a test from contending with
    the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ------------------------------------------------------------ accounting

def _ref_shapes(cfg_ref):
    from repro.models import lm_init as ref_lm_init
    return jax.eval_shape(lambda: ref_lm_init(jax.random.key(0), cfg_ref)[0])


def _ref_cfg(arch, **kw):
    from repro.configs import get_config as rget
    from repro.models import reduced as rreduced
    cfg = rget(arch)
    return dataclasses.replace(rreduced(cfg, **kw), param_dtype="float32",
                               compute_dtype="float32") if kw else cfg


def _port_cfg(arch, **kw):
    cfg = get_config(arch)
    return dataclasses.replace(reduced(cfg, **kw), param_dtype="float32",
                               compute_dtype="float32") if kw else cfg


def _wire_tree_layouts():
    """``tests/test_wire.py``'s tree (``_global_buckets``) in both
    packages."""
    rng = np.random.default_rng(2)
    p = 8
    tree = {"w1": rng.normal(size=(p, 5, 3)).astype(np.float32),
            "w2": rng.normal(size=(p, 130)).astype(np.float32),
            "w3": rng.normal(size=(p, 2, 7, 11)).astype(np.float32),
            "w4": rng.normal(size=(p, 200)).astype(np.float32)}
    ref = ref_build_layout(jax.tree.map(jnp.asarray, tree), skip_leading=1,
                           target_bucket_bytes=520)
    port = build_layout({k: array_to_torch(v, "cpu") for k, v in
                         tree.items()}, skip_leading=1,
                        target_bucket_bytes=520)
    return port, ref


def _layouts():
    """(port, reference) layouts: full-width qwen3-0.6b flat (bf16) and on
    mesh (1, 4, 2) in replica mode (16-bit, 2 shards), a reduced fp32
    qwen3 flat, and the wire tests' tree."""
    from repro.optim import sgd as ref_sgd
    from repro.train import make_distribution as ref_make_distribution
    from repro.train.step import _build_packed_layout as ref_build
    from repro.train.step import state_specs_of
    out = {}
    for name, kw in (("qwen3_full", {}), ("qwen3_reduced_fp32",
                                          {"d_model": 64})):
        out[name] = (build_layout(lm_specs(_port_cfg("qwen3-0.6b", **kw))),
                     ref_build_layout(_ref_shapes(_ref_cfg("qwen3-0.6b",
                                                           **kw))))
    mesh = make_smoke_mesh(4, 2)
    dist = make_distribution(mesh, "replica")
    rdist = ref_make_distribution(
        AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names)),
        "replica")
    rcfg = _ref_cfg("qwen3-0.6b")
    ss, sa, _ = ref_specs.train_input_specs(rcfg, rdist, 8, 2 * rdist.dp,
                                            ref_sgd(0.1))
    out["qwen3_full_1x4x2"] = (
        _build_packed_layout(dist, _port_cfg("qwen3-0.6b")),
        ref_build(rdist, ss["params"],
                  state_specs_of(rdist, ss, sa)["params"]))
    out["wire_tree"] = _wire_tree_layouts()
    return out


@pytest.fixture(scope="module")
def layouts():
    return _layouts()


def test_layouts_are_the_references(layouts):
    for name, (port, ref) in layouts.items():
        assert port.strides == tuple(ref.strides), name
        assert port.bucket_dtypes == tuple(ref.bucket_dtypes), name
    assert layouts["qwen3_full_1x4x2"][0].num_shards == 2


@pytest.mark.parametrize("subset", [1.0, 0.5])
@pytest.mark.parametrize("wire", WIRES)
def test_wire_bytes_per_step_equal_the_references(layouts, wire, subset):
    for name, (port, ref) in layouts.items():
        got = wire_bytes_per_step(port, WireFormat(dtype=wire,
                                                   subset=subset))
        want = ref_gossip.wire_bytes_per_step(ref, RefWire(dtype=wire,
                                                           subset=subset))
        assert got == want, (name, got, want)
        assert list(got) == list(want)
    assert wire_bytes_per_step(layouts["wire_tree"][0]) == \
        ref_gossip.wire_bytes_per_step(layouts["wire_tree"][1])


@pytest.mark.parametrize("shards", [1, 16])
@pytest.mark.parametrize("dp", [1, 2, 8, 512])
def test_gossip_bytes_per_step_equal_the_references(dp, shards):
    for rb in (2 * 10**9, 1_192_099_840, 7):
        assert gossip_bytes_per_step(rb, dp, shards) == \
            ref_gossip.gossip_bytes_per_step(rb, dp, shards)


def test_wire_bytes_per_step_ratios(layouts):
    """``tests/test_wire.py:303-323`` on the port."""
    layout = layouts["wire_tree"][0]
    raw = wire_bytes_per_step(layout)
    assert raw["reduction_codes"] == 1.0 and raw["wire_dtype"] == "fp32"
    q = wire_bytes_per_step(layout, WireFormat(dtype="int8"))
    assert q["reduction_codes"] == 4.0
    assert q["code_bytes"] * 4 == raw["raw_bytes"]
    assert q["scale_bytes"] == sum(s // LANE for s in layout.strides) * 4
    assert q["reduction_total"] > 3.8
    sub = build_subset_schedule(layout.num_buckets, 0.5)
    qs = wire_bytes_per_step(layout, WireFormat(dtype="int8", subset=0.5))
    assert qs["subset_fraction"] == pytest.approx(sub.fraction)
    assert qs["reduction_codes"] == pytest.approx(4.0 / sub.fraction)
    assert qs["reduction_codes"] >= 8.0
    bf = wire_bytes_per_step(layout, WireFormat(dtype="bf16"))
    assert bf["reduction_codes"] == 2.0 and bf["scale_bytes"] == 0


def test_gossip_communication_is_O1_in_p():
    """``tests/test_system.py:81-90`` on the port."""
    rb = 2 * 10**9
    b8 = gossip_bytes_per_step(rb, dp=8, model_shards=16)
    b512 = gossip_bytes_per_step(rb, dp=512, model_shards=16)
    assert b8["gossip_bytes_per_chip"] == b512["gossip_bytes_per_chip"]
    assert b8["gossip_latency_steps"] == b512["gossip_latency_steps"] == 1
    assert b512["allreduce_latency_steps"] == 9
    assert (b512["allreduce_bytes_per_chip"]
            > 1.9 * b512["gossip_bytes_per_chip"])


@pytest.mark.parametrize("wire", WIRES)
def test_sent_bytes_at_sum_over_a_period(layouts, wire):
    """Over one subset period the exchanges send the sum of
    ``sent_bytes_at``; it equals ``period x total_bytes`` only where every
    bucket goes out equally often (13 buckets at 7 a window: the first is
    sent twice a period)."""
    for name, (port, _) in layouts.items():
        full = WireFormat(dtype=wire)
        assert sent_bytes_at(port, full, 3)["total_bytes"] == \
            wire_bytes_per_step(port, full)["total_bytes"], name
        w = WireFormat(dtype=wire, subset=0.5)
        sub = build_subset_schedule(port.num_buckets, 0.5)
        if sub is None:        # one bucket: a subset sends it every time
            continue
        per = sub.period
        got = sum(sent_bytes_at(port, w, t)["total_bytes"]
                  for t in range(per))
        sizes = sent_bytes_at(port, full, 0)["total_bytes"]
        times = np.zeros(port.num_buckets, int)
        for t in range(per):
            times += sub.selected(t)
        assert got >= sizes and (times >= 1).all(), name
        uniform = len(set(times.tolist())) == 1
        avg = per * wire_bytes_per_step(port, w)["total_bytes"]
        assert math.isclose(got, avg, rel_tol=1e-12) == uniform, name
    q = layouts["qwen3_full"][0]
    assert q.num_buckets == 13


def test_exchange_bytes_by_protocol():
    rb = 1_192_099_840
    g16 = exchange_bytes("gossip", 16, 16, rb, rb, 4097 * 4)
    g256 = exchange_bytes("gossip", 256, 16, rb, rb, 4097 * 4)
    a16 = exchange_bytes("agd", 16, 16, rb, rb, 0)
    a256 = exchange_bytes("agd", 256, 16, rb, rb, 0)
    assert g16["collective-permute_bytes"] == g256["collective-permute_bytes"]
    assert g16["collective-permute_bytes"] == rb / 16 + 4097 * 4
    assert g16["all-reduce_bytes"] == g16["all-gather_bytes"] == 0
    assert a16["all-gather_bytes"] == 15 * rb / 16
    assert a256["all-gather_bytes"] == 255 * rb / 16
    assert a256["allreduce_equivalent_bytes"] == 2 * (rb / 16) * 255 / 256
    assert a16["in_replica_collectives"].startswith("not modeled")
    one = exchange_bytes("gossip", 1, 1, rb, rb, 8)
    assert one["wire_bytes"] == 0 and "none" in one["in_replica_collectives"]
    lay = build_layout(lm_specs(get_config("qwen3-0.6b")))
    w = WireFormat(dtype="int8", subset=0.5)
    wired = exchange_bytes("gossip", 4, 1, rb, rb, 0, wire=w, layout=lay)
    assert wired["collective-permute_bytes"] == \
        wire_bytes_per_step(lay, w)["total_bytes"]
    with pytest.raises(ValueError):
        exchange_bytes("ring_allreduce", 4, 1, rb, rb, 0)
    t = roofline_terms(989e12, 3.35e12, 0.0)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert roofline_terms(1.0, 1.0, 50e9)["dominant"] == "collective"
    assert H100.net_bw == 50e9 and H100.nvlink_bw == 450e9


# ------------------------------------------------- gossip_mix_flat / tree

def _np_bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _port(a):
    return array_to_torch(np.asarray(a), "cpu")


def _assert_mix_equal(got, want, a, b, dtype, alpha):
    """Bit for bit where both products are exact (alpha 0, 0.5, 1: the
    paper's average and the engines' default); elsewhere XLA:CPU contracts
    the reference's ``a * (1 - alpha) + b * alpha`` into one FMA, which the
    port (and its CUDA kernel, ``-fmad=false``) rounds op by op: fp32 within
    2 ulp, bf16 within one bf16 ulp, of the largest operand or result
    (``tests/test_torch_kernels.py``'s rule: where the sum cancels, the gap
    is an ulp of the operands)."""
    if alpha in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(_np_bits(got), _np_bits(want))
        return
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want).astype(np.float32).astype(np.float64)
    top = np.maximum.reduce([np.abs(g), np.abs(w),
                             np.abs(np.asarray(a, np.float32)),
                             np.abs(np.asarray(b, np.float32))])
    if dtype == "float32":
        tol = 2 * np.spacing(top.astype(np.float32)).astype(np.float64)
    else:
        tol = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    assert (np.abs(g - w) <= tol).all()


@pytest.mark.parametrize("n,dtype,alpha", [
    (1, "float32", 0.5), (77, "bfloat16", 0.5), (128, "float32", 0.0),
    (1000, "bfloat16", 1.0), (1283, "float32", 0.5),
    (4999, "bfloat16", 0.5), (77, "bfloat16", 0.3),
    (1283, "float32", 0.25), (4999, "bfloat16", 0.7)])
def test_gossip_mix_flat_equals_the_references(n, dtype, alpha):
    key = jax.random.key(n)
    dt = jnp.dtype(dtype)
    a = jax.random.normal(key, (n,), jnp.float32).astype(dt)
    b = jax.random.normal(jax.random.fold_in(key, 1), (n,),
                          jnp.float32).astype(dt)
    want = ref_mix_flat(a, b, alpha=alpha)
    pa, pb = _port(a), _port(b)
    before = pa.clone()
    gossip_mix.launches.reset()
    got = gossip_mix_flat(pa, pb, alpha=alpha)
    assert got is not pa and got.dtype == pa.dtype
    _assert_mix_equal(got, want, a, b, dtype, alpha)
    assert torch.equal(pa, before)               # out of place
    assert gossip_mix.launches.count == 0        # CPU: the plain version


def test_gossip_mix_multidim_and_half_alpha():
    a = jax.random.normal(jax.random.key(0), (3, 7, 11))
    b = jax.random.normal(jax.random.key(1), (3, 7, 11))
    got = gossip_mix_flat(_port(a), _port(b))
    assert tuple(got.shape) == (3, 7, 11)
    np.testing.assert_array_equal(_np_bits(got),
                                  _np_bits(ref_mix_flat(a, b)))
    x = gossip_mix_flat(torch.full((256,), 2.0), torch.full((256,), 4.0))
    assert torch.equal(x, torch.full((256,), 3.0))


def test_gossip_mix_tree_equals_the_references():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(130,)).astype(jnp.bfloat16),
                  rng.normal(size=(2, 7, 11)).astype(np.float32)]}
    other = {"a": rng.normal(size=(5, 3)).astype(np.float32),
             "b": [rng.normal(size=(130,)).astype(jnp.bfloat16),
                   rng.normal(size=(2, 7, 11)).astype(np.float32)]}
    want = ref_mix_tree(jax.tree.map(jnp.asarray, tree),
                        jax.tree.map(jnp.asarray, other), alpha=0.5)
    pt = {"a": _port(tree["a"]), "b": [_port(x) for x in tree["b"]]}
    po = {"a": _port(other["a"]), "b": [_port(x) for x in other["b"]]}
    got = gossip_mix_tree(pt, po, alpha=0.5)
    for g, w in zip(tree_flatten(got)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(_np_bits(g), _np_bits(w))
    # the per-leaf engines' mix_impl signature (local, received, alpha)
    assert gossip_mix_tree(pt["a"], po["a"], 0.25).shape == (5, 3)


def test_kernel_wrappers_raise_on_meta():
    """The dry run must never reach a kernel: every wrapper raises on a
    device that is neither the CPU nor CUDA."""
    a = torch.empty(256, device="meta")
    with pytest.raises(ValueError):
        gossip_mix_flat(a, a)
    with pytest.raises(ValueError):
        gossip_mix_1d(a, a)
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("mps")


# ------------------------------------------------------------------ specs

@pytest.fixture(scope="module")
def ref_trees():
    from repro.models import lm_init as ref_lm_init
    return {a: jax.eval_shape(lambda a=a: ref_lm_init(
        jax.random.key(0), ref_specs.get_config(a))[0]) for a in list_archs()}


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_the_references(ref_trees, arch):
    cfg = get_config(arch)
    rcfg = ref_specs.get_config(arch)
    tree = lm_specs(cfg)
    assert specs.param_count(tree) == ref_specs.param_count(ref_trees[arch])
    assert specs.active_param_count(cfg, tree) == \
        ref_specs.active_param_count(rcfg, ref_trees[arch])
    # and on the meta tensors the dry run holds
    assert specs.param_count(specs.meta_params(cfg)) == \
        specs.param_count(tree)


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1])
            for x in tree_flatten(tree)[0]]


def _ref_shapes_of(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_the_references(arch):
    from repro.optim import sgd as ref_sgd
    from repro.train import make_distribution as ref_make_distribution
    mesh = make_production_mesh()
    amesh = AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names))
    for shape, (seq, batch, kind) in SHAPES.items():
        cfg, notes = specs.resolve_config(arch, shape)
        rcfg, rnotes = ref_specs.resolve_config(arch, shape)
        assert notes == rnotes and cfg.name == rcfg.name, shape
        dist = make_distribution(mesh, cfg.dist_mode)
        rdist = ref_make_distribution(amesh, rcfg.dist_mode)
        assert dist.dp == rdist.dp
        if kind == "train":
            st, sa, b = specs.train_input_specs(cfg, dist, seq, batch,
                                                sgd(0.1, momentum=0.9))
            rst, rsa, rb = ref_specs.train_input_specs(
                rcfg, rdist, seq, batch, ref_sgd(0.1, momentum=0.9))
            assert _shapes(st["params"]) == _ref_shapes_of(rst["params"])
            assert tree_flatten(sa)[0] == jax.tree.leaves(rsa)
            assert all(x.device.type == "meta"
                       for x in tree_flatten(st)[0]
                       if isinstance(x, torch.Tensor))
        else:
            b = specs.serve_input_specs(cfg, dist, seq, batch, kind)
            rb = ref_specs.serve_input_specs(rcfg, rdist, seq, batch, kind)
            assert _shapes(b["params"]) == _ref_shapes_of(rb["params"])
            assert _shapes(b.pop("cache")) == _ref_shapes_of(rb.pop("cache"))
            assert tree_flatten(b.pop("params_axes"))[0] == \
                jax.tree.leaves(rb.pop("params_axes"))
            b.pop("params")
            rb.pop("params")
        assert sorted(b) == sorted(rb), shape
        for k in b:
            assert _shapes(b[k]) == _ref_shapes_of(rb[k]), (shape, k)


# ---------------------------------------------------------------- counting

def test_counts_equal_on_meta_and_cpu():
    cfg = _port_cfg("qwen3-0.6b", d_model=64)
    mamba = _port_cfg("falcon-mamba-7b", d_model=64)
    cases = {
        "train": lambda d: dryrun.trace_train(cfg, 2, 16, 2, d, remat=True),
        "decode": lambda d: dryrun.trace_serve(mamba, "decode", 32, 2, d),
    }
    for name, make in cases.items():
        meta, cpu = make("meta").counts, make("cpu").counts
        assert meta.flops == cpu.flops > 0, name
        assert meta.op_bytes == cpu.op_bytes > 0, name
        assert meta.peak_bytes == cpu.peak_bytes, name
        # a traced CPU step also holds the host scalars it makes (a
        # ``torch.tensor(c)`` read back), which meta leaves on the host
        assert 0 < meta.entry_bytes <= cpu.entry_bytes, name


def test_counting_mode_rules():
    a = torch.randn(64, 128, dtype=torch.bfloat16, device="meta")
    b = torch.randn(128, 32, dtype=torch.bfloat16, device="meta")
    with CountingMode((a, b)) as m:
        c = a @ b
        v = c.view(-1)          # a view moves nothing
        del v
    assert m.counts.flops == 2 * 64 * 128 * 32 == 524_288
    assert m.counts.op_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 2
    assert m.counts.entry_bytes == (64 * 128 + 128 * 32) * 2
    assert m.counts.peak_bytes == m.counts.entry_bytes + 64 * 32 * 2
    cache = torch.zeros(8, 1024)
    src = torch.ones(8, 1)
    idx = torch.tensor([3])
    with CountingMode((cache, src, idx)) as m:
        cache.index_copy_(1, idx, src)   # an indexed write: the source moves
        cache.add_(1.0)                  # elementwise in place: read + write
    # index_copy_: the index (8 bytes) and the source (32) read, 32 written
    assert m.counts.op_bytes == (8 + 32 + 32) + 2 * 8 * 1024 * 4


# ------------------------------------------------------------------ dryrun

_REF_KEYS = {"arch", "shape", "kind", "mesh", "chips", "protocol",
             "dist_mode", "dp", "notes", "seq_len", "global_batch", "params",
             "active_params", "tokens_per_step", "memory_analysis",
             "cost_analysis", "collectives", "roofline", "model_flops",
             "hlo_flops_total", "useful_flop_ratio"}


def test_run_one_record():
    """The reference's ``tests/test_dryrun_integration.py`` record checks
    on the port's meta dry run."""
    rec = dryrun.run_one("falcon-mamba-7b", "long_500k", multi_pod=False,
                         protocol="gossip", verbose=False)
    assert _REF_KEYS <= set(rec) and "trace_s" in rec
    assert rec["hardware"] == "h100-sxm5-80gb (datasheet)"
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["kind"] == "decode"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["wire_bytes"] >= 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["params"] > 7e9
    json.dumps(rec)


def test_run_one_pure_dp_protocols():
    """Gossip's data-parallel exchange is collective-permutes and no
    all-reduce, under 0.75x agd's wire bytes; its per-chip bytes do not
    grow with dp (16 against 256)."""
    g = dryrun.run_one("qwen3-0.6b", "train_4k", multi_pod=False,
                       protocol="gossip", dist_mode="pure_dp", verbose=False)
    a = dryrun.run_one("qwen3-0.6b", "train_4k", multi_pod=False,
                       protocol="agd", dist_mode="pure_dp", verbose=False)
    cg, ca = g["collectives"], a["collectives"]
    assert g["dp"] == 256 and cg["collective-permute_count"] > 0
    assert cg["collective-permute_bytes"] > 0
    assert cg["all-reduce_bytes"] == 0
    assert cg["wire_bytes"] < 0.75 * ca["wire_bytes"]
    # the same program: only the exchange differs
    assert g["cost_analysis"]["flops"] == a["cost_analysis"]["flops"]
    rb = dryrun._replica_bytes(get_config("qwen3-0.6b"))
    assert [exchange_bytes("gossip", dp, 1, rb, rb, 0)[
        "collective-permute_bytes"] for dp in (16, 256)] == [rb, rb]
    assert g["useful_flop_ratio"] > 0.2


def test_sweep_and_report(tmp_path, capsys):
    out = str(tmp_path / "dr")
    argv = ["--arch", "qwen3-0.6b,falcon-mamba-7b", "--shape",
            "decode_32k,long_500k", "--mesh", "single", "--out", out]
    dryrun.main(argv)
    assert "all dry-runs passed" in capsys.readouterr().out
    dryrun.main(argv)                     # incremental: every record kept
    assert capsys.readouterr().out.count("[skip]") == 4
    recs = report.load_records(out, mesh="16x16")
    assert [(r["shape"], r["arch"]) for r in recs] == [
        ("decode_32k", "falcon-mamba-7b"), ("decode_32k", "qwen3-0.6b"),
        ("long_500k", "falcon-mamba-7b"), ("long_500k", "qwen3-0.6b")]
    table = report.roofline_table(recs, with_lever=True)
    assert table.count("\n") == 1 + len(recs)
    assert "Pallas" not in table and "VMEM" not in table
    assert report.collectives_table(recs).count("| 16x16 |") == 4
    assert sum(len(v) for v in report.summary(recs).values()) == 4
    t = report.effective_terms(recs[0])
    assert t["compute_analytic_s"] == pytest.approx(
        2 * recs[0]["active_params"] * recs[0]["tokens_per_step"] / 256
        / 989e12)
    report.main(["--dir", out, "--collectives", "--lever"])
    assert "4 records" in capsys.readouterr().out
