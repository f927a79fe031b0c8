"""The port's CUDA kernels against their plain PyTorch versions on the card,
bit for bit, including lengths that exercise the masked scalar edge and
misaligned views that exercise the scalar path.

Marked ``cuda``; they skip on a machine without a card. This file imports
neither JAX nor the reference, so on a machine with a card and no JAX it
runs without the repo's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (fused_sgd_1d, fused_sgd_plain,  # noqa: E402
                                 fused_update, gossip_mix, gossip_mix_1d,
                                 gossip_mix_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _alphas():
    return (0.5, 0.0, torch.tensor(0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (128 * 1000 + 3, 0),
                                      (4096, 1)])
def test_kernels_match_plain_bitwise(cuda_device, dtype, n, offset):
    gen = torch.Generator(device=cuda_device).manual_seed(n)

    def mk():  # offset > 0: a view that is not 16-byte aligned
        t = torch.randn(n + offset, generator=gen, device=cuda_device)
        return t.to(dtype)[offset:]

    p, g, b, m = mk(), mk(), mk(), mk()
    for alpha in _alphas():
        for mom in (m, None):
            before = fused_update.launches.count
            wp, wm = fused_sgd_plain(p, g, b, mom, lr=0.01, alpha=alpha,
                                     weight_decay=1e-4)
            gp = p.clone()
            gm = mom.clone() if mom is not None else None
            fused_sgd_1d(gp, g, b, gm, lr=0.01, alpha=alpha, weight_decay=1e-4)
            torch.cuda.synchronize()
            assert fused_update.launches.count == before + 1
            assert torch.equal(gp, wp)
            if mom is not None:
                assert torch.equal(gm, wm)
        before = gossip_mix.launches.count
        got = gossip_mix_1d(p.clone(), b, alpha)
        torch.cuda.synchronize()
        assert gossip_mix.launches.count == before + 1
        assert torch.equal(got, gossip_mix_plain(p, b, alpha))


@pytest.mark.cuda
def test_kernel_rejects_mismatched_buffers(cuda_device):
    p = torch.zeros(256, device=cuda_device)
    with pytest.raises(ValueError):
        fused_sgd_1d(p, torch.zeros(256, device=cuda_device,
                                    dtype=torch.bfloat16), None, None, lr=0.1)
    with pytest.raises(ValueError, match="aliases"):
        fused_sgd_1d(p, p.clone(), p, None, lr=0.1)
