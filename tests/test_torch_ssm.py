"""The port's ``ssm_scan`` and ``ssm_scan_chunked`` (on the CPU their plain
version, the sequential loop ``kernels.ref.ssm_scan_ref``) against the
reference's ``repro.kernels.ssm_scan`` (Pallas, interpret mode, which pads
S and D) and ``ssm_scan_ref``, on the ragged sweep of
tests/test_kernels.py:48-72, from the same seeded numpy inputs.

Tolerance: rtol = atol = 2e-5, the reference's own; XLA:CPU may contract
the multiply-add into an FMA, where the port rounds the product. The CUDA
kernel equals the plain loop bit for bit on the card
(tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ssm_scan as ref_ssm_scan  # noqa: E402
from repro.kernels.ref import ssm_scan_ref as ref_scan_ref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_chunked as ref_chunked  # noqa: E402
from repro_torch.kernels import ssm_scan, ssm_scan_chunked  # noqa: E402
from repro_torch.kernels.ref import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan_kernel import launches  # noqa: E402


def _inputs(seed, shape, lo=0.2, hi=1.0, sd=1.0):
    rng = np.random.default_rng(seed)
    dA = rng.uniform(lo, hi, size=shape).astype(np.float32)
    dBx = (rng.normal(size=shape) * sd).astype(np.float32)
    return dA, dBx


# (B, S, D, N, chunk, block_d): S and D mostly not multiples of the chunk
# and the block, so the reference pads and crops
SWEEP = [(1, 1, 1, 1, 16, 8), (2, 7, 5, 4, 16, 8), (1, 33, 20, 8, 32, 16),
         (2, 80, 3, 1, 32, 8), (1, 17, 16, 2, 16, 16), (2, 64, 9, 8, 16, 8),
         (1, 45, 12, 5, 32, 8), (2, 32, 8, 3, 32, 16)]


@pytest.mark.parametrize("B,S,D,N,chunk,block_d", SWEEP)
def test_ssm_scan_sweep_matches_reference(B, S, D, N, chunk, block_d):
    dA, dBx = _inputs(S * 131 + D, (B, S, D, N))
    got = ssm_scan(torch.from_numpy(dA), torch.from_numpy(dBx), chunk=chunk,
                   block_d=block_d).numpy()
    assert got.shape == (B, S, D, N)
    for want in (ref_ssm_scan(jnp.asarray(dA), jnp.asarray(dBx), chunk=chunk,
                              block_d=block_d),
                 ref_scan_ref(jnp.asarray(dA), jnp.asarray(dBx))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_ssm_scan_chunk_boundaries():
    """A run whose S spans several of the reference's chunks, with dA near
    one so the state carries far: the reference's own rtol 1e-4."""
    dA, dBx = _inputs(0, (1, 256, 8, 4), lo=0.9, sd=0.1)
    got = ssm_scan_chunked(torch.from_numpy(dA), torch.from_numpy(dBx),
                           chunk=64, block_d=8).numpy()
    want = ref_chunked(jnp.asarray(dA), jnp.asarray(dBx), chunk=64,
                       block_d=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,chunk,block_d", [((2, 64, 16, 4), 16, 8),
                                                 ((1, 12, 6, 3), 128, 256)])
def test_ssm_scan_chunked_matches_reference(shape, chunk, block_d):
    dA, dBx = _inputs(1, shape)
    got = ssm_scan_chunked(torch.from_numpy(dA), torch.from_numpy(dBx),
                           chunk=chunk, block_d=block_d).numpy()
    want = ref_chunked(jnp.asarray(dA), jnp.asarray(dBx), chunk=chunk,
                       block_d=block_d, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_ssm_scan_refuses_what_the_kernel_does_not_take():
    x = torch.rand((1, 24, 6, 2))
    with pytest.raises(ValueError):      # the reference's divisibility
        ssm_scan_chunked(x, x, chunk=16)
    with pytest.raises(ValueError):
        ssm_scan_chunked(x, x, block_d=4)
    with pytest.raises(ValueError):
        ssm_scan(x, x[:, :12])
    with pytest.raises(ValueError):
        ssm_scan(x[0], x[0])
    with pytest.raises(TypeError):
        ssm_scan(x.double(), x.double())


def test_cpu_path_is_the_plain_loop_and_launches_nothing():
    dA, dBx = (torch.from_numpy(a) for a in _inputs(2, (2, 9, 3, 4)))
    before = launches.count
    got = ssm_scan(dA, dBx)
    assert launches.count == before
    assert torch.equal(got, ssm_scan_ref(dA, dBx))
    h0 = torch.from_numpy(_inputs(3, (2, 3, 4))[1])
    with_h0 = ssm_scan_ref(dA, dBx, h0)
    assert torch.equal(with_h0[:, 0], dA[:, 0] * h0 + dBx[:, 0])
