"""The port's model, loss and packed gradients against the reference's
``make_loss_fn`` on the reduced qwen3 (2 layers, d=128) in fp32, with the
reference's ``lm_init`` weights bridged in (``checkpoint.bridge``).

Two replicas with different weights and batches run stacked in one forward,
so the test also shows that nothing leaks between replicas. Tolerances: loss
rtol 1e-5, gradients atol 1e-5 * max|g| — the two frameworks sum matmuls in
different orders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build_layout  # noqa: E402
from repro_torch.models import lm_specs, reduced  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402

SEQ, B = 24, 2


def _cfgs(**kw):
    ref = dataclasses.replace(ref_reduced(ref_get_config("qwen3-0.6b"), **kw),
                              param_dtype="float32", compute_dtype="float32")
    port = dataclasses.replace(reduced(get_config("qwen3-0.6b"), **kw),
                               param_dtype="float32", compute_dtype="float32")
    return ref, port


def _reference(ref_cfg, keys, tokens):
    loss_fn = ref_make_loss_fn(ref_cfg)
    vg = jax.jit(jax.value_and_grad(lambda p, t: loss_fn(p, {"tokens": t})[0]))
    params, losses, grads = [], [], []
    for key, tok in zip(keys, tokens):
        p = ref_lm_init(jax.random.key(key), ref_cfg)[0]
        loss, g = vg(p, jnp.asarray(tok))
        params.append(p)
        losses.append(float(loss))
        grads.append(g)
    stack = lambda trees: jax.tree.map(lambda *x: np.stack(x), *trees)
    return stack(params), np.asarray(losses), stack(grads)


@pytest.mark.parametrize("n_layers,d_model", [(2, 128), (1, 64)])
def test_loss_and_packed_grads_match_reference(n_layers, d_model):
    ref_cfg, cfg = _cfgs(n_layers=n_layers, d_model=d_model)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(2, B, SEQ + 1)).astype(np.int32)
    params, want_loss, want_grads = _reference(ref_cfg, [0, 1], tokens)

    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(params, layout=layout, device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    loss, metrics = make_loss_fn(cfg)(packed.unpack(),
                                      {"tokens": torch.from_numpy(tokens)})
    loss.sum().backward()

    assert loss.shape == (2,)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"].detach().mean()),
                               want_loss.mean(), rtol=1e-5)
    ref_layout = ref_build_layout(want_grads, skip_leading=1)
    want_packed = RefPacked.pack(want_grads, ref_layout).buckets
    for got, want in zip(packed.buckets, want_packed):
        want = np.asarray(want)
        got = got.grad.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_forward_is_per_replica():
    """Changing replica 1's weights leaves replica 0's loss unchanged."""
    ref_cfg, cfg = _cfgs(d_model=64)
    tree = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0), ref_cfg)[0])
    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(tree, layout=layout, lead=(2,), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, B, SEQ + 1)).astype(np.int32))
    loss_fn = make_loss_fn(cfg)
    before = loss_fn(packed.unpack(), {"tokens": tokens})[0]
    with torch.no_grad():
        for b in packed.buckets:
            b[1].mul_(1.5)
    after = loss_fn(packed.unpack(), {"tokens": tokens})[0]
    assert float(after[0]) == float(before[0])
    assert float(after[1]) != float(before[1])
