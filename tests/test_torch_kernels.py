"""Port kernels against the reference's Pallas kernels (interpret mode) and
jnp twins: ``gossip_mix`` and ``fused_sgd``.

The same seeded numpy inputs go through ``repro.kernels`` and
``repro_torch.kernels`` (on CPU the port's wrappers run their plain PyTorch
versions). Tolerances: fp32 within 2 ulp of the largest operand —
XLA:CPU may contract a multiply-add into one FMA where the port rounds each
op, the same 1-2 ulp gap the reference notes between its own jnp and
Pallas-interpret paths (tests/test_fused_update.py:167-178); where the sum
cancels, that gap is an ulp of the operands, not of the small result. bf16
bit-exact, since the rounding to bf16 absorbs the gap on these inputs.

The CUDA kernels are held against their plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_update import fused_sgd_1d as ref_sgd_1d  # noqa: E402
from repro.kernels.fused_update import fused_sgd_ref  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_1d as ref_mix_1d  # noqa: E402
from repro.kernels.gossip_mix import gossip_mix_2d as ref_mix_2d  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.kernels import (fused_sgd_1d, fused_sgd_bucket,  # noqa: E402
                                 fused_sgd_plain, fused_update, gossip_mix,
                                 gossip_mix_1d, gossip_mix_2d,
                                 gossip_mix_bucket, gossip_mix_plain)
from repro_torch.kernels.gossip_mix import mix_weights  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ALPHAS = [("static", 0.5), ("static", 0.0), ("traced", 0.25)]
LR = np.float32(0.1)


def _pair(rng, n, dtype):
    """The same values as a jax array and a torch tensor (bit-identical)."""
    x = jnp.asarray(rng.normal(size=(n,)).astype(np.float32)).astype(dtype)
    return x, array_to_torch(np.asarray(x), "cpu")


def _alpha(kind, value):
    if kind == "traced":
        return jnp.float32(value), torch.tensor(value, dtype=torch.float32)
    return value, value


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, operands=()):
    """fp32: |got - want| <= 2 ulp of the largest of got, want and the
    operands, elementwise; bf16: equal."""
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


# ---------------------------------------------------------------- gossip_mix

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,alpha", ALPHAS)
@pytest.mark.parametrize("n", [6 * 128, 5 * 128 + 37])
def test_gossip_mix_matches_reference(dtype, kind, alpha, n):
    rng = np.random.default_rng(n)
    ja, ta = _pair(rng, n, DTYPES[dtype])
    jb, tb = _pair(rng, n, DTYPES[dtype])
    j_al, t_al = _alpha(kind, alpha)
    if n % 128 == 0:
        want = ref_mix_2d(ja.reshape(-1, 128), jb.reshape(-1, 128), alpha=j_al,
                          interpret=True).reshape(-1)
        got = gossip_mix_2d(ta.view(-1, 128), tb.view(-1, 128), t_al).view(-1)
    else:
        want = ref_mix_1d(ja, jb, alpha=j_al, interpret=True)
        got = gossip_mix_1d(ta, tb, t_al)
    assert got.data_ptr() == ta.data_ptr()  # in place over a
    _close(got, want, dtype, (ja, jb))
    plain = gossip_mix_plain(array_to_torch(np.asarray(ja), "cpu"), tb, t_al)
    np.testing.assert_array_equal(_f32(plain), _f32(got))


def test_mix_weights_follow_the_reference():
    """A static alpha rounds 1 - alpha from a double; a traced one subtracts
    in fp32. Both give the fp32 values the reference multiplies by."""
    al = 0.3
    assert mix_weights(al) == (float(np.float32(1.0 - al)), float(np.float32(al)))
    t = mix_weights(torch.tensor(al))
    assert t == (float(np.float32(1.0) - np.float32(al)), float(np.float32(al)))
    assert np.float32(jax.jit(lambda a: 1.0 - a)(jnp.float32(al))) == \
        np.float32(t[0])


# ---------------------------------------------------------------- fused_sgd

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,alpha", ALPHAS)
@pytest.mark.parametrize("has_mom", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("n", [4 * 128, 3 * 128 + 45])
def test_fused_sgd_matches_reference(dtype, kind, alpha, has_mom, wd, n):
    rng = np.random.default_rng(17 + n)
    jp, tp = _pair(rng, n, DTYPES[dtype])
    jg, tg = _pair(rng, n, DTYPES[dtype])
    jb, tb = _pair(rng, n, DTYPES[dtype])
    jm, tm = _pair(rng, n, DTYPES[dtype])
    if not has_mom:
        jm, tm = None, None
    j_al, t_al = _alpha(kind, alpha)
    kw = dict(momentum=0.9, weight_decay=wd)
    want_p, want_m = ref_sgd_1d(jp, jg, jb, jm, lr=jnp.float32(LR), alpha=j_al,
                                interpret=True, **kw)
    twin_p, twin_m = jax.jit(
        lambda p, g, b, m, a: fused_sgd_ref(p, g, b, m, lr=jnp.float32(LR),
                                            alpha=a, **kw),
        static_argnums=(4,) if kind == "static" else ())(jp, jg, jb, jm, j_al)
    plain_p, plain_m = fused_sgd_plain(tp, tg, tb, tm, lr=float(LR),
                                       alpha=t_al, **kw)
    got_p, got_m = fused_sgd_1d(tp, tg, tb, tm, lr=float(LR), alpha=t_al, **kw)
    assert got_p is tp and got_m is tm  # in place over p and mom
    ops = (jp, jg, jb, jm)
    for got, want in ((got_p, want_p), (got_p, twin_p)):
        _close(got, want, dtype, ops)
    np.testing.assert_array_equal(_f32(plain_p), _f32(got_p))
    if has_mom:
        _close(got_m, want_m, dtype, ops)
        _close(got_m, twin_m, dtype, ops)
        np.testing.assert_array_equal(_f32(plain_m), _f32(got_m))
    else:
        assert want_m is None and got_m is None


def test_static_zero_alpha_drops_the_partner():
    """Static alpha 0 reads no partner (a NaN partner leaves no trace); a
    traced 0 still mixes (0 * NaN = NaN), as in the reference."""
    p = torch.ones(256)
    g = torch.full((256,), 0.5)
    bad = torch.full((256,), float("nan"))
    new_p, _ = fused_sgd_plain(p, g, bad, None, lr=0.1, alpha=0.0)
    assert torch.isfinite(new_p).all()
    new_p, _ = fused_sgd_plain(p, g, bad, None, lr=0.1,
                               alpha=torch.tensor(0.0))
    assert torch.isnan(new_p).all()


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no kernel, no
    launch counted."""
    gossip_mix.launches.reset()
    fused_update.launches.reset()
    a, b = torch.ones(2, 256), torch.zeros(2, 256)
    gossip_mix_bucket(a, b, 0.5)
    fused_sgd_bucket(a, b, b.clone(), torch.zeros_like(a), lr=0.1)
    assert gossip_mix.launches.count == 0
    assert fused_update.launches.count == 0
    # mix with zeros halves a, the fused sweep halves it again (zero grad)
    assert torch.equal(a, torch.full((2, 256), 0.25))


def test_bucket_wrappers_reject_unaligned_buckets():
    a = torch.ones(2, 100)
    with pytest.raises(ValueError, match="LANE"):
        gossip_mix_bucket(a, a.clone())
    with pytest.raises(ValueError, match="LANE"):
        fused_sgd_bucket(a, a.clone(), None, None, lr=0.1)
