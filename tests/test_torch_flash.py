"""The port's ``flash_mha`` (on the CPU its plain version, dense
``attention_ref``) against the reference's ``repro.kernels.flash_mha``
(Pallas, interpret mode) and ``attention_ref``, on the cases of
tests/test_kernels.py:78-116, from the same seeded numpy inputs.

Tolerances are the reference's own: 2e-5 (fp32) and 3e-2 (bf16) for the
windowed cases, 3e-5 for the sweep and the cross-shaped case. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_mha as ref_flash_mha  # noqa: E402
from repro.kernels.ref import attention_ref as ref_attention  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import flash_mha  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, B, H, S, T, d, dtype=jnp.float32, qk_scale=0.2):
    """q, k, v as jax arrays and bit-identical torch tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for n, sc in ((S, qk_scale), (T, qk_scale), (T, 1.0)):
        x = jnp.asarray((rng.normal(size=(B, H, n, d)) * sc)
                        .astype(np.float32)).astype(dtype)
        out.append((x, array_to_torch(np.asarray(x), "cpu")))
    return out


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(seed, B, H, S, T, d, *, causal, window=None, bq, bk, dtype, tol):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(seed, B, H, S, T, d, dtype,
                                        qk_scale=0.3 if window else 0.2)
    got = flash_mha(qt, kt, vt, causal=causal, window=window, block_q=bq,
                    block_k=bk)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    for want in (ref_flash_mha(qj, kj, vj, causal=causal, window=window,
                               block_q=bq, block_k=bk),
                 ref_attention(qj, kj, vj, causal=causal, window=window)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_basic_matches_reference(window, dtype):
    _check(0, 1, 2, 128, 128, 32, causal=True, window=window, bq=32, bk=32,
           dtype=DTYPES[dtype], tol=2e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("bq", [32, 64])
@pytest.mark.parametrize("S", [32, 128])
def test_flash_sweep_matches_reference(S, bq, d, causal):
    _check(S + d, 1, 1, S, S, d, causal=causal, bq=bq, bk=bq,
           dtype=jnp.float32, tol=3e-5)


def test_flash_cross_shaped_kv_matches_reference():
    """T != S (scoring a prompt against a longer memory)."""
    _check(1, 1, 2, 64, 128, 32, causal=False, bq=32, bk=32,
           dtype=jnp.float32, tol=3e-5)


def test_flash_scale_reaches_both_paths():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 1, 1, 64, 64, 16)
    from repro.kernels.flash_attention import flash_attention as ref_fa
    from repro_torch.kernels.flash_attention import flash_attention
    got = flash_attention(qt, kt, vt, scale=0.5, block_q=32, block_k=32)
    want = ref_fa(qj, kj, vj, scale=0.5, block_q=32, block_k=32,
                  interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-5, atol=3e-5)


def test_flash_shape_errors_raise():
    q = torch.zeros((1, 1, 64, 16))
    with pytest.raises(ValueError):
        flash_mha(q, q, q, block_q=48)            # 48 does not divide 64
    with pytest.raises(ValueError):
        flash_mha(q, q, q, block_k=24)
    with pytest.raises(ValueError):
        flash_mha(q, torch.zeros((1, 1, 64, 8)), q)
    with pytest.raises(ValueError):
        flash_mha(q, q, torch.zeros((1, 2, 64, 16)))
    with pytest.raises(ValueError):
        flash_mha(q[0], q[0], q[0])


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    (_, qt), (_, kt), (_, vt) = _qkv(3, 1, 2, 64, 64, 16)
    before = flash_mod.launches.count
    got = flash_mha(qt, kt, vt, window=8, block_q=32, block_k=32)
    assert flash_mod.launches.count == before
    assert torch.equal(got, attention_ref(qt, kt, vt, window=8))
