"""The port's compressed wire against the reference, on the CPU.

* Bit-exact: ``wire_key``, ``wire_uniform`` and ``exchange_ok`` over
  t in [-8, 16) and ranks 0..7; ``BucketSubsetSchedule.selected`` and
  ``wire_period``; int8 / fp8 / bf16 ``encode_wire`` codes and scales on
  fp32 and bf16 buckets; ``zero_payload_like``.
* The kernels' plain versions (``gossip_mix_q_plain``, ``fused_sgd_plain``
  with ``partner_scales``, and a bf16 partner on an fp32 bucket) against
  the reference's ``gossip_mix_q2d`` / ``fused_sgd_1d`` in interpret mode:
  static alpha 0.5 and 0, a traced alpha, and a per-row alpha compared row
  by row with the reference's traced scalar. fp32 within 2 ulp of the
  largest operand (XLA:CPU may contract a multiply-add into one FMA where
  the port rounds each op, tests/test_torch_kernels.py), bf16 exact.
* The sync wire engines against ``gossip_mix_sim_quantized`` (unfused) and
  the reference's encode + exchange + ``fused_sgd_ref`` (fused), at every
  phase of the dp=4 schedule, int8 / fp8 / bf16 / fp32 wires, subsets 1
  and 1/3, on a layout of 5 buckets.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.gossip import wire_period as ref_wire_period  # noqa: E402
from repro.core.simulate import gossip_mix_sim_quantized  # noqa: E402
from repro.core.topology import build_schedule as ref_build_schedule  # noqa: E402
from repro.core.topology import build_subset_schedule as ref_subset  # noqa: E402
from repro.kernels import quantize as RQ  # noqa: E402
from repro.kernels.fused_update import fused_sgd_1d as ref_sgd_1d  # noqa: E402
from repro.kernels.fused_update import fused_sgd_ref  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_2d as ref_mix_2d  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_q2d as ref_mix_q2d  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.core import (PackedParams, build_layout,  # noqa: E402
                              build_schedule, build_subset_schedule,
                              exchange_ok, make_packed_fused_update,
                              make_packed_gossip_mix, wire_period)
from repro_torch.kernels import (fused_sgd_1d, fused_sgd_plain,  # noqa: E402
                                 gossip_mix, gossip_mix_1d, gossip_mix_q2d,
                                 gossip_mix_bucket, gossip_mix_q_plain)
from repro_torch.kernels import quantize as Q  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

DP, LR = 4, np.float32(0.1)
CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
BUCKETS = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _t(x):
    """A jax array as a torch tensor with the same bits."""
    return array_to_torch(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, operands=()):
    """fp32: |got - want| <= 2 ulp of the largest of got, want and the
    operands, elementwise; otherwise equal."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype != "float32":
        np.testing.assert_array_equal(got, want)
        return
    scale = np.maximum(np.abs(got), np.abs(want))
    for x in operands:
        if x is not None:
            scale = np.maximum(scale, np.abs(_f32(x)))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 2 * np.spacing(scale)).all(), \
        float((err / np.spacing(scale)).max())


def _payload_equal(got, want):
    if isinstance(want, dict):
        np.testing.assert_array_equal(_f32(got["q"]), _f32(want["q"]))
        assert got["q"].dtype == Q.CODE_DTYPES[
            "int8" if want["q"].dtype == jnp.int8 else "fp8"]
        np.testing.assert_array_equal(_f32(got["s"]), _f32(want["s"]))
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


def _bucket(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    x[..., :128] = 0.0           # an all-zero tile: scale 0
    x[..., 128] = 3e4            # a tile whose amax dwarfs the rest
    return jnp.asarray(x).astype(BUCKETS[dtype])


# ------------------------------------------------------------ host hashes

def test_wire_key_uniform_and_exchange_ok_bit_exact():
    t = np.arange(-8, 16, dtype=np.int32)[:, None]
    r = np.arange(8)[None, :]
    for b, seed in ((0, 0), (3, 7), (12, 0xFFFFFFFF)):
        want = np.asarray(RQ.wire_key(jnp.asarray(t), jnp.asarray(r), b, seed))
        got = Q.wire_key(t, r, b, seed)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    keys = Q.wire_key(t, r, 5, 1)[::5, ::3]
    for base in (0, 1 << 20):
        want = np.asarray(RQ.wire_uniform(jnp.asarray(keys), 1000, base))
        got = Q.wire_uniform(keys, 1000, base).numpy()
        np.testing.assert_array_equal(got, want)
    for seed, rate in ((0, 0.0), (0, 0.3), (11, 0.5), (2, 0.999)):
        want = np.asarray(ref_exchange_ok(jnp.asarray(t), jnp.asarray(r),
                                          seed, rate))
        got = exchange_ok(t, r, seed, rate)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb,frac", [(4, 0.5), (5, 1 / 3), (13, 0.5),
                                     (7, 0.2), (3, 1.0)])
def test_subset_schedule_and_wire_period_bit_exact(nb, frac):
    want, got = ref_subset(nb, frac), build_subset_schedule(nb, frac)
    if want is None:
        assert got is None
    else:
        assert (got.n_send, got.period) == (want.n_send, want.period)
        for t in range(-8, 16):
            np.testing.assert_array_equal(got.selected(t), want.selected(t))
    for p in (2, 4, 8):
        assert wire_period(build_schedule(p), got) == \
            ref_wire_period(ref_build_schedule(p), want)


# ------------------------------------------------------------ encode

@pytest.mark.parametrize("dtype", list(BUCKETS))
@pytest.mark.parametrize("wire", ["int8", "fp8", "bf16", "fp32"])
@pytest.mark.parametrize("base", [0, 4096])
def test_encode_wire_bit_exact(dtype, wire, base):
    rng = np.random.default_rng(len(wire) + base)
    x = _bucket(rng, (DP, 128 * 24), dtype)
    keys_ref = RQ.wire_key(9, jnp.arange(DP), 2, 5)
    want = RQ.encode_wire(x, wire, keys=keys_ref, base_index=base)
    got = Q.encode_wire(_t(x), wire, keys=Q.wire_key(9, np.arange(DP), 2, 5),
                        base_index=base)
    _payload_equal(got, want)
    if wire in CODES:
        assert np.isfinite(_f32(got["q"])).all()
        np.testing.assert_array_equal(
            _f32(Q.decode_wire(got)), _f32(RQ.decode_wire(want)))


def test_encode_chunks_agree_with_one_pass(monkeypatch):
    """Column chunks (a LANE multiple) give the bits of one pass."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 128 * 10)).astype(np.float32))
    keys = Q.wire_key(3, np.arange(2), 0, 0)
    whole = Q.encode_wire(x, "int8", keys=keys)
    monkeypatch.setattr(Q, "CHUNK", 3 * 128)
    _payload_equal(Q.encode_wire(x, "int8", keys=keys),
                   {"q": whole["q"].numpy().astype(np.int8),
                    "s": whole["s"].numpy()})
    with pytest.raises(ValueError, match="keys"):
        Q.encode_wire(x, "int8")


@pytest.mark.parametrize("dtype", list(BUCKETS))
@pytest.mark.parametrize("wire", ["int8", "fp8", "bf16", "fp32"])
def test_zero_payload_like_bit_exact(dtype, wire):
    x = jnp.ones((DP, 512), BUCKETS[dtype])
    want = RQ.zero_payload_like(x, wire)
    got = Q.zero_payload_like(_t(x), wire)
    _payload_equal(got, want)
    if not isinstance(want, dict):
        assert got.dtype == _t(want).dtype
    assert Q.wire_itemsize(wire, _t(x).dtype) == \
        RQ.wire_itemsize(wire, x.dtype)


# ------------------------------------------------------------ kernels

def _alphas():
    """(name, reference alpha, port alpha) for the whole-buffer cases."""
    return [("static 0.5", 0.5, 0.5), ("static 0", 0.0, 0.0),
            ("traced 0.25", jnp.float32(0.25), torch.tensor(0.25))]


@pytest.mark.parametrize("dtype", list(BUCKETS))
@pytest.mark.parametrize("code", list(CODES))
def test_gossip_mix_q_matches_reference(dtype, code):
    rng = np.random.default_rng(7)
    a = _bucket(rng, (DP, 128 * 6), dtype)
    enc = RQ.encode_wire(_bucket(rng, (DP, 128 * 6), "float32"), code,
                         keys=RQ.wire_key(1, jnp.arange(DP), 0))
    q, s = enc["q"], enc["s"]
    rows = lambda x: x.reshape(-1, 128)  # noqa: E731
    for name, ja, ta in _alphas():
        want = ref_mix_q2d(rows(a), rows(q), s.reshape(-1), alpha=ja,
                           interpret=True).reshape(a.shape)
        got = gossip_mix_q2d(_t(a), _t(q), _t(s), ta)
        _close(got, want, dtype, (a, RQ.decode_wire(enc)))
        np.testing.assert_array_equal(
            _f32(got), _f32(gossip_mix_q_plain(_t(a), _t(q), _t(s), ta)))
    # one alpha per replica row, row by row against the traced scalar
    per_row = np.float32([0.5, 0.0, 0.25, 0.5])
    got = gossip_mix_q2d(_t(a), _t(q), _t(s), torch.from_numpy(per_row))
    for j in range(DP):
        want = ref_mix_q2d(rows(a[j]), rows(q[j]), s[j],
                           alpha=jnp.float32(per_row[j]), interpret=True)
        _close(got[j], want.reshape(-1), dtype, (a[j],))
    # through the bucket wrapper, which takes the payload dict
    b = _t(a)
    gossip_mix_bucket(b, {"q": _t(q), "s": _t(s)},
                           torch.from_numpy(per_row))
    np.testing.assert_array_equal(_f32(b), _f32(got))


def test_gossip_mix_mixed_dtype_partner_matches_reference():
    """A bf16 wire payload mixes into an fp32 bucket (promoted)."""
    rng = np.random.default_rng(3)
    a = _bucket(rng, (DP, 128 * 4), "float32")
    b = _bucket(rng, (DP, 128 * 4), "bfloat16")
    for name, ja, ta in _alphas() + [
            ("per row", None, torch.tensor([0.5, 0.0, 0.25, 0.125]))]:
        got = gossip_mix_1d(_t(a), _t(b), ta)
        if ja is None:
            for j in range(DP):
                want = ref_mix_2d(a[j].reshape(-1, 128), b[j].reshape(-1, 128),
                                  alpha=jnp.float32(float(ta[j])),
                                  interpret=True).reshape(-1)
                _close(got[j], want, "float32", (a[j], b[j]))
            continue
        want = ref_mix_2d(a.reshape(-1, 128), b.reshape(-1, 128), alpha=ja,
                          interpret=True).reshape(a.shape)
        _close(got, want, "float32", (a, b))


def test_alpha_must_be_one_per_row_and_counts_no_launch_on_cpu():
    gossip_mix.q_launches.reset()
    a = torch.ones(DP, 256)
    q = torch.zeros(DP, 256, dtype=torch.int8)
    s = torch.ones(DP, 2)
    gossip_mix_q2d(a, q, s, torch.full((DP,), 0.5))
    assert gossip_mix.q_launches.count == 0
    assert torch.equal(a, torch.full((DP, 256), 0.5))
    with pytest.raises(ValueError):
        gossip_mix.kernel_alpha(torch.ones(3), a)
    with pytest.raises(ValueError, match="scales"):
        gossip_mix_q2d(a, q, torch.ones(DP, 3))


@pytest.mark.parametrize("dtype", list(BUCKETS))
@pytest.mark.parametrize("partner", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("has_mom,wd", [(True, 1e-4), (False, 0.0)])
def test_fused_sgd_wire_partner_matches_reference(dtype, partner, has_mom,
                                                  wd):
    rng = np.random.default_rng(11)
    shape = (DP, 128 * 5)
    p, g, m = (_bucket(rng, shape, dtype) for _ in range(3))
    m = m if has_mom else None
    src = _bucket(rng, shape, "float32")
    if partner in CODES:
        enc = RQ.encode_wire(src, partner,
                             keys=RQ.wire_key(2, jnp.arange(DP), 1))
        jb, js = enc["q"], enc["s"]
        tb, ts = _t(jb), _t(js)
    else:
        jb, js = src.astype(jnp.bfloat16), None
        tb, ts = _t(jb), None
    kw = dict(momentum=0.9, weight_decay=wd)
    tm = _t(m) if has_mom else None
    ops = (p, g, m, RQ.dequant_flat(jb, js) if js is not None else jb)
    for name, ja, ta in _alphas():
        want_p, want_m = ref_sgd_1d(p, g, jb, m, lr=jnp.float32(LR), alpha=ja,
                                    partner_scales=js, interpret=True, **kw)
        gp, gm = _t(p), (tm.clone() if has_mom else None)
        fused_sgd_1d(gp, _t(g), tb, gm, lr=float(LR), alpha=ta,
                     partner_scales=ts, **kw)
        _close(gp, want_p, dtype, ops)
        pp, pm = fused_sgd_plain(_t(p), _t(g), tb, tm, lr=float(LR), alpha=ta,
                                 partner_scales=ts, **kw)
        np.testing.assert_array_equal(_f32(pp), _f32(gp))
        if has_mom:
            _close(gm, want_m, dtype, ops)
            np.testing.assert_array_equal(_f32(pm), _f32(gm))
    per_row = np.float32([0.5, 0.25, 0.0, 0.5])
    gp, gm = _t(p), (tm.clone() if has_mom else None)
    fused_sgd_1d(gp, _t(g), tb, gm, lr=float(LR),
                 alpha=torch.from_numpy(per_row), partner_scales=ts, **kw)
    for j in range(DP):
        want_p, want_m = ref_sgd_1d(
            p[j], g[j], jb[j], m[j] if has_mom else None, lr=jnp.float32(LR),
            alpha=jnp.float32(per_row[j]),
            partner_scales=js[j] if js is not None else None, interpret=True,
            **kw)
        _close(gp[j], want_p, dtype, (p[j], g[j]))
        if has_mom:
            _close(gm[j], want_m, dtype, (p[j], g[j], m[j]))


# ------------------------------------------------------------ sync engines

def _layout():
    """A port layout of 5 fp32 buckets over a synthetic tree."""
    tree = {f"w{i}": torch.zeros(n) for i, n in
            enumerate((700, 520, 400, 390, 260, 250, 130, 100))}
    layout = build_layout(tree, target_bucket_bytes=3000)
    assert layout.num_buckets == 5
    return layout


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8", "bf16", "fp32"])
@pytest.mark.parametrize("subset", [1.0, 1 / 3], ids=["full", "third"])
def test_sync_wire_mix_matches_oracle_every_phase(wire_dtype, subset):
    layout = _layout()
    sched, ref_sched = build_schedule(DP), ref_build_schedule(DP)
    wire = Q.WireFormat(wire_dtype, subset, seed=3)
    ref_wire = RQ.WireFormat(wire_dtype, subset, seed=3)
    mix = make_packed_gossip_mix(sched, layout, alpha=0.5, wire=wire)
    eff = wire_period(sched, build_subset_schedule(layout.num_buckets, subset))
    assert eff == (12 if subset < 1 else 4)
    rng = np.random.default_rng(5)
    for ph in range(eff):
        xs = [_bucket(rng, (DP, n), "float32") for n in layout.bucket_sizes]
        want = gossip_mix_sim_quantized(
            xs, jnp.asarray(ref_sched.recv_from(ph)), ph, wire=ref_wire,
            alpha=0.5)
        got = mix(PackedParams([_t(x) for x in xs], layout), ph + 7 * eff)
        for g, w, x in zip(got.buckets, want, xs):
            _close(g, w, "float32", (x,))


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("subset", [1.0, 1 / 3], ids=["full", "third"])
def test_sync_fused_wire_matches_composed_reference(wire_dtype, subset):
    """The fused engine encodes each sent bucket's pre-update rows (keyed
    on the folded phase and the sender's rank), exchanges codes and scales,
    and sweeps; unsent buckets take the pure local update."""
    layout = _layout()
    sched, ref_sched = build_schedule(DP), ref_build_schedule(DP)
    wire = Q.WireFormat(wire_dtype, subset, seed=1)
    sub = ref_subset(layout.num_buckets, subset)
    opt = sgd(float(LR), momentum=0.9, weight_decay=1e-4)
    update = make_packed_fused_update(sched, layout, opt, alpha=0.5,
                                      wire=wire)
    eff = wire_period(sched, build_subset_schedule(layout.num_buckets,
                                                   subset))
    rng = np.random.default_rng(9)
    for ph in range(eff):
        ps, gs, ms = ([_bucket(rng, (DP, n), "float32")
                       for n in layout.bucket_sizes] for _ in range(3))
        recv = jnp.asarray(ref_sched.recv_from(ph))
        sel = sub.selected(ph) if sub is not None else [True] * len(ps)
        want = []
        for i, (p, g, m) in enumerate(zip(ps, gs, ms)):
            partner, alpha = None, 0.0
            if sel[i]:
                enc = RQ.encode_wire(p, wire_dtype,
                                     keys=RQ.wire_key(ph, jnp.arange(DP), i,
                                                      1))
                partner = RQ.decode_wire(jax.tree.map(lambda e: e[recv], enc))
                alpha = 0.5
            want.append(fused_sgd_ref(p, g, partner, m, lr=jnp.float32(LR),
                                      alpha=alpha, momentum=0.9,
                                      weight_decay=1e-4))
        params = PackedParams([_t(p) for p in ps], layout)
        state = {"step": 0, "mom": PackedParams([_t(m) for m in ms], layout)}
        params, state = update(params, PackedParams([_t(g) for g in gs],
                                                    layout), state, ph)
        for i, (wp, wm) in enumerate(want):
            ops = (ps[i], gs[i], ms[i])
            _close(params.buckets[i], wp, "float32", ops)
            _close(state["mom"].buckets[i], wm, "float32", ops)
