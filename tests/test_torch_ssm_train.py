"""The port's differentiable scan ``kernels.ssm_scan_train`` on the CPU,
where it runs its plain versions (forward ``ssm_scan_ref``, backward
``kernels.ref.ssm_scan_bwd_ref``, the adjoint loop in the CUDA kernels'
order): its forward and gradients against autograd through
``ssm_scan_ref`` (bit for bit), its gradients against ``jax.grad`` through
the reference's ``ssm_scan_chunked_jnp``, and a reduced falcon-mamba's
``make_loss_fn`` with it as the scan, remat off, on and "dots", against the
reference's. The CUDA kernels equal these plain versions bit for bit on the
card (tests/test_torch_cuda.py, ``chip_smoke.py``).

Tolerances are ``tests/test_torch_remat.py``'s: gradients within 1e-4 of
their largest magnitude, losses rtol 1e-4 (XLA contracts and reorders what
the port rounds step by step).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.mamba import ssm_scan_chunked_jnp  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssm_scan_kernel, ssm_scan_train  # noqa: E402
from repro_torch.kernels.ref import ssm_scan_bwd_ref, ssm_scan_ref  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.models.mamba import ssm_scan_chunked_torch  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402
from test_torch_ssm import SWEEP  # noqa: E402

REMATS = {"off": dict(remat=False), "on": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread keeps a test from contending
    with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.2, 1.0, size=shape).astype(np.float32)
    dBx = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)
    return dA, dBx, w


def _grads(scan, dA, dBx, w):
    a = torch.from_numpy(dA).requires_grad_(True)
    b = torch.from_numpy(dBx).requires_grad_(True)
    h = scan(a, b)
    (h * torch.from_numpy(w)).sum().backward()
    return h.detach(), a.grad, b.grad


@pytest.mark.parametrize("B,S,D,N", [c[:4] for c in SWEEP])
def test_forward_and_gradients_equal_autograd_through_the_plain_loop(B, S, D,
                                                                     N):
    """S = 1, S below, above and not a multiple of the kernels' unroll of
    8: the forward, ddA and ddBx bit for bit (the adjoint multiplies and
    adds what autograd's mul and add backwards do, in an order that fp32
    addition's commutativity makes the same)."""
    dA, dBx, w = _inputs((B, S, D, N), S * 131 + D)
    got = _grads(ssm_scan_train, dA, dBx, w)
    want = _grads(ssm_scan_ref, dA, dBx, w)
    for g, x in zip(got, want):
        assert g.shape == (B, S, D, N)
        assert torch.equal(g, x)


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16), (12, 16), (1, 16)])
def test_gradients_match_the_references_chunked_scan(S, chunk):
    dA, dBx, w = _inputs((2, S, 5, 4), seed=S)

    def ref_obj(a, b):
        return jnp.sum(ssm_scan_chunked_jnp(a, b, chunk=chunk) * w)
    want_h = np.asarray(jax.jit(functools.partial(
        ssm_scan_chunked_jnp, chunk=chunk))(dA, dBx))
    want = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(dA, dBx)
    h, ga, gb = _grads(ssm_scan_train, dA, dBx, w)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=1e-5, atol=1e-5)
    for got, ref in zip((ga, gb), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_the_plain_adjoint_walks_from_a_zero_state():
    """``ssm_scan_bwd_ref`` written out at S = 3 for one element."""
    a = torch.tensor([0.5, 0.25, 2.0]).view(1, 3, 1, 1)
    h = torch.tensor([1.0, 3.0, -2.0]).view(1, 3, 1, 1)
    dh = torch.tensor([1.0, -1.0, 4.0]).view(1, 3, 1, 1)
    ddA, ddBx = ssm_scan_bwd_ref(a, h, dh)
    g2 = 4.0
    g1 = 2.0 * g2 - 1.0
    g0 = 0.25 * g1 + 1.0
    assert ddBx.flatten().tolist() == [g0, g1, g2]
    assert ddA.flatten().tolist() == [0.0, g1 * 1.0, g2 * 3.0]


def test_cpu_path_launches_nothing_and_refuses_what_the_kernels_do_not_take():
    counters = (ssm_scan_kernel.launches, ssm_scan_kernel.train_launches,
                ssm_scan_kernel.bwd_launches)
    before = [c.count for c in counters]
    dA, dBx, w = _inputs((2, 9, 3, 4), seed=2)
    _grads(ssm_scan_train, dA, dBx, w)
    with torch.no_grad():
        ssm_scan_train(torch.from_numpy(dA), torch.from_numpy(dBx))
    assert [c.count for c in counters] == before
    x = torch.rand((1, 6, 3, 2))
    with pytest.raises(TypeError):
        ssm_scan_train(x.double(), x.double())
    with pytest.raises(ValueError):
        ssm_scan_train(x, x[:, :3])
    with pytest.raises(ValueError):
        ssm_scan_train(x[0], x[0])
    with pytest.raises(ValueError):
        ssm_scan_train(x.to("meta"), x.to("meta"))
    assert [c.count for c in counters] == before


def test_chunked_train_scan_off_the_card_is_the_chunk_loop(monkeypatch):
    """Off the card ``ssm_scan_chunked_torch`` never reaches
    ``ssm_scan_train``: it stays the reference's chunk loop over the
    associative scan (tests/test_torch_remat.py holds it against the
    reference; tests/test_torch_cuda.py counts the kernels on the card)."""
    import repro_torch.models.mamba as mamba

    def refuse(*a, **kw):
        raise AssertionError("ssm_scan_train on a CPU tensor")
    monkeypatch.setattr(mamba, "ssm_scan_train", refuse)
    dA, dBx, _ = (torch.from_numpy(x) for x in _inputs((1, 6, 3, 2), 4))
    torch.testing.assert_close(ssm_scan_chunked_torch(dA, dBx, chunk=2),
                               ssm_scan_ref(dA, dBx), rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    arch = "falcon-mamba-7b"
    ref = dataclasses.replace(ref_reduced(ref_get_config(arch), **kw),
                              param_dtype="float32", compute_dtype="float32")
    port = dataclasses.replace(reduced(get_config(arch), **kw),
                               param_dtype="float32", compute_dtype="float32")
    return ref, port


@pytest.fixture(scope="module")
def mamba_reference():
    """The reference's reduced falcon-mamba: its weights, tokens, and its
    remat loss and gradients through its chunked scan (chunk 8 under 16
    tokens, two chunks)."""
    ref_cfg, cfg = _cfgs(d_model=64)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 17)).astype(np.int32)
    tree = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    loss_fn = ref_make_loss_fn(
        ref_cfg, remat=True,
        ssm_scan_impl=functools.partial(ssm_scan_chunked_jnp, chunk=8))
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, t: loss_fn(p, {"tokens": t})[0]))(tree, jnp.asarray(tokens))
    return (cfg, jax.tree.map(np.asarray, tree), tokens, float(want),
            [np.asarray(g) for g in jax.tree.leaves(want_g)])


def _port_loss_and_grads(cfg, tree, tokens, **kw):
    p = params_from_numpy(jax.tree.map(lambda x: x[None], tree),
                          device="cpu")
    leaves, _ = tree_flatten(p)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = make_loss_fn(cfg, ssm_scan_impl=ssm_scan_train, **kw)(
        p, {"tokens": torch.from_numpy(tokens)[None]})
    loss.sum().backward()
    return loss.detach(), [w.grad[0] for w in leaves]


@pytest.mark.parametrize("name", list(REMATS))
def test_mamba_loss_with_the_train_scan_matches_reference(mamba_reference,
                                                          name):
    """``make_loss_fn(cfg, ssm_scan_impl=ssm_scan_train, ...)`` with remat
    off, on (non-reentrant checkpointing recomputes the Function's
    forward) and "dots" (selective checkpointing) against the reference's
    loss and every gradient."""
    cfg, tree, tokens, want, want_g = mamba_reference
    loss, grads = _port_loss_and_grads(cfg, tree, tokens, **REMATS[name])
    np.testing.assert_allclose(float(loss[0]), want, rtol=1e-4)
    assert len(grads) == len(want_g)
    for got, g in zip(grads, want_g):
        np.testing.assert_allclose(got.numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30))


def test_remat_with_the_train_scan_is_bit_equal(mamba_reference):
    """Remat recomputes the same scan: loss and gradients with remat on
    and "dots" bit-equal to remat off (deterministic algorithms: the CPU
    embedding gather's backward adds in no fixed order otherwise)."""
    cfg, tree, tokens, _, _ = mamba_reference
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = {name: _port_loss_and_grads(cfg, tree, tokens, **kw)
                for name, kw in REMATS.items()}
    finally:
        torch.use_deterministic_algorithms(was)
    want_loss, want = runs["off"]
    for name, (loss, grads) in runs.items():
        assert torch.equal(loss, want_loss), name
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), name
