"""The port's Mamba-1 family against the reference: ``mamba_apply``, the
reduced falcon-mamba forward (``lm_apply`` logits, ``make_loss_fn`` loss),
its packed gradients through the default associative scan, a dp=1 fused
train run, and the param tree of the full-size config.

The reference's weights cross through the bridge (``params_from_numpy``);
inputs come from numpy with a seed. Everything is fp32. Tolerances: rtol
1e-4 on mixer outputs, logits and losses, since the two associative scans
combine in another order than XLA's fused one; gradients atol 1e-4 of their
largest magnitude; the train run at the reference's end-to-end rtol = atol
= 2e-4 (tests/test_hier_packed.py:417).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.kernels import ssm_scan as ref_ssm_scan  # noqa: E402
from repro.models import lm_apply as ref_lm_apply  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.config import SSMSpec as RefSSMSpec  # noqa: E402
from repro.models.mamba import mamba_apply as ref_mamba_apply  # noqa: E402
from repro.models.mamba import mamba_init as ref_mamba_init  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build_layout  # noqa: E402
from repro_torch.kernels import flash_mha, ssm_scan  # noqa: E402
from repro_torch.models import SSMSpec, lm_apply, lm_init, lm_specs  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.models.layers import draw  # noqa: E402
from repro_torch.models.mamba import (mamba_apply, mamba_init,  # noqa: E402
                                      ssm_assoc_scan, ssm_scan_ref)
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map, tree_paths  # noqa: E402

SEQ, B = 24, 2
SCANS = {"assoc": (None, None), "kernel": (ref_ssm_scan, ssm_scan)}


def _cfgs(**kw):
    ref = dataclasses.replace(ref_reduced(ref_get_config("falcon-mamba-7b"), **kw),
                              param_dtype="float32", compute_dtype="float32")
    port = dataclasses.replace(reduced(get_config("falcon-mamba-7b"), **kw),
                               param_dtype="float32", compute_dtype="float32")
    return ref, port


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(trees):
    return jax.tree.map(lambda *x: np.stack(x), *trees)


def test_reduced_config_matches_reference():
    ref, port = _cfgs()
    # the port's one field beyond the reference's, off: no norms on dt,
    # B and C
    assert all(b.ssm.bcdt_norm is None for b in port.blocks)
    assert [dict(dataclasses.asdict(b.ssm), bcdt_norm=None)
            for b in port.blocks] == \
        [dict(dataclasses.asdict(b.ssm), bcdt_norm=None) for b in ref.blocks]
    full = get_config("falcon-mamba-7b")
    assert full.n_layers == 64 and full.d_model == 4096 and full.vocab == 65024
    assert not full.tie_embeddings and full.param_dtype == "bfloat16"


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_mamba_apply_matches_reference(scan):
    d_model, spec = 32, dict(d_state=8, d_conv=4, expand=2)
    ref_scan, port_scan = SCANS[scan]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, B, 17, d_model)).astype(np.float32)
    weights = [_np_tree(ref_mamba_init(jax.random.key(i), d_model,
                                       RefSSMSpec(**spec))[0]) for i in (0, 1)]
    apply = jax.jit(lambda w, xr: ref_mamba_apply(
        w, RefSSMSpec(**spec), d_model, xr, scan_impl=ref_scan))
    want = np.stack([apply(w, jnp.asarray(xr)) for w, xr in zip(weights, x)])
    p = params_from_numpy(_stack(weights), device="cpu")
    got = mamba_apply(p, SSMSpec(**spec), d_model, torch.from_numpy(x),
                      scan_impl=port_scan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_mamba_init_specs_match_reference():
    d_model, spec = 32, dict(d_state=8, d_conv=4, expand=2)
    want = _np_tree(ref_mamba_init(jax.random.key(0), d_model,
                                   RefSSMSpec(**spec))[0])
    specs = mamba_init(d_model, SSMSpec(**spec))
    assert sorted(specs) == sorted(want)
    gen = torch.Generator().manual_seed(0)
    for k, s in specs.items():
        assert s.shape == want[k].shape, k
        got = draw(s, gen, "cpu")
        if k in ("D", "conv_b"):
            np.testing.assert_array_equal(got.numpy(), want[k])
        if k == "A_log":  # deterministic, but torch's and XLA's fp32 log
            # may differ by one ulp
            np.testing.assert_allclose(got.numpy(), want[k], rtol=2.5e-7)
    dt = torch.nn.functional.softplus(draw(specs["dt_bias"], gen, "cpu"))
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001


def test_assoc_scan_matches_sequential():
    rng = np.random.default_rng(1)
    for S in (1, 2, 7, 33, 64):
        dA = torch.from_numpy(rng.uniform(0.3, 0.99, (2, S, 5, 4)).astype(np.float32))
        dBx = torch.from_numpy(rng.normal(size=(2, S, 5, 4)).astype(np.float32))
        h0 = torch.from_numpy(rng.normal(size=(2, 5, 4)).astype(np.float32))
        np.testing.assert_allclose(ssm_assoc_scan(dA, dBx).numpy(),
                                   ssm_scan_ref(dA, dBx).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ssm_assoc_scan(dA, dBx, h0).numpy(),
                                   ssm_scan_ref(dA, dBx, h0).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_reduced_forward_and_loss_match_reference(scan):
    ref_cfg, cfg = _cfgs()
    ref_scan, port_scan = SCANS[scan]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, size=(2, B, SEQ + 1)).astype(np.int32)
    trees = [_np_tree(ref_lm_init(jax.random.key(i), ref_cfg)[0]) for i in (0, 1)]
    apply = jax.jit(lambda t, tok: ref_lm_apply(t, ref_cfg, tok,
                                                ssm_scan_impl=ref_scan)[0])
    want_logits = np.stack([apply(t, jnp.asarray(tok[:, :-1]))
                            for t, tok in zip(trees, tokens)])
    loss_fn = jax.jit(lambda t, tok: ref_make_loss_fn(
        ref_cfg, ssm_scan_impl=ref_scan)(t, {"tokens": tok})[0])
    want_loss = np.array([float(loss_fn(t, jnp.asarray(tok)))
                          for t, tok in zip(trees, tokens)])
    p = params_from_numpy(_stack(trees), device="cpu")
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, _ = lm_apply(p, cfg, tok[..., :-1], ssm_scan_impl=port_scan)
        loss, metrics = make_loss_fn(cfg, ssm_scan_impl=port_scan)(
            p, {"tokens": tok})
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(want_logits).max())
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-4)
    np.testing.assert_allclose(metrics["ce"].numpy(), want_loss, rtol=1e-4)


def test_loss_and_packed_grads_match_reference():
    """The train path's gradient: the default associative scan under
    autograd, two replicas stacked with different weights and batches."""
    ref_cfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, size=(2, B, SEQ + 1)).astype(np.int32)
    loss_fn = ref_make_loss_fn(ref_cfg)
    vg = jax.jit(jax.value_and_grad(lambda p, t: loss_fn(p, {"tokens": t})[0]))
    params, losses, grads = [], [], []
    for key, tok in zip((0, 1), tokens):
        p = ref_lm_init(jax.random.key(key), ref_cfg)[0]
        loss, g = vg(p, jnp.asarray(tok))
        params.append(_np_tree(p))
        losses.append(float(loss))
        grads.append(_np_tree(g))
    params, grads = _stack(params), _stack(grads)

    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(params, layout=layout, device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    loss, _ = make_loss_fn(cfg)(packed.unpack(),
                                {"tokens": torch.from_numpy(tokens)})
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), losses, rtol=1e-4)
    ref_layout = ref_build_layout(grads, skip_leading=1)
    for got, want in zip(packed.buckets,
                         RefPacked.pack(grads, ref_layout).buckets):
        want = np.asarray(want)
        assert got.grad.shape == want.shape
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_dp1_fused_train_run_matches_reference():
    """Two steps of the reduced falcon-mamba through both packages'
    packed fused sgd train step (dp=1, so alpha = 0), from one init."""
    from repro.data import ShardedTokenDataset as RefDataset
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.specs import train_input_specs
    from repro.optim import sgd as ref_sgd
    from repro.optim import step_decay as ref_step_decay
    from repro.train import Trainer as RefTrainer
    from repro.train import init_train_state as ref_init_state
    from repro.train import make_distribution
    from repro.train import make_train_step_bundle as ref_bundle
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    ref_cfg, cfg = _cfgs(d_model=64)
    seq, steps = 16, 2
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    opt = ref_sgd(ref_step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    ss, sa, bs = train_input_specs(ref_cfg, dist, seq, 2, opt)
    bundle = ref_bundle(ref_cfg, dist, opt, state_shapes=ss, state_axes=sa,
                        batch_shapes=bs, protocol="gossip", remat=False,
                        gossip_packed=True)
    state, _ = ref_init_state(jax.random.key(0), ref_cfg, dist, opt,
                              packed=True, layout=bundle.layout)
    tr = RefTrainer(bundle, state, RefDataset(vocab=ref_cfg.vocab, seq_len=seq,
                                              n_shards=1, batch_per_shard=2,
                                              seed=0), log_every=0)
    want = [h["loss"] for h in tr.run(steps)]
    init = _np_tree(ref_lm_init(jax.random.key(0), ref_cfg)[0])

    popt = sgd(step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    pb = make_train_step_bundle(cfg, popt, dp=1, gossip_packed=True,
                                device="cpu")
    assert pb.fused
    pstate = init_train_state(cfg, popt, dp=1, packed=True, layout=pb.layout,
                              params=params_from_numpy(init, layout=pb.layout,
                                                       lead=(1,), device="cpu"),
                              device="cpu")
    ptr = Trainer(pb, pstate, ShardedTokenDataset(vocab=cfg.vocab, seq_len=seq,
                                                  n_shards=1, batch_per_shard=2,
                                                  seed=0), log_every=0)
    got = [h["loss"] for h in ptr.run(steps)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for a, b in zip(ptr.state["params"].buckets, tr.state["params"].buckets):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


def test_forward_only_wrappers_refuse_grad():
    q = torch.randn((1, 1, 32, 8), requires_grad=True)
    dA = torch.rand((1, 8, 4, 2), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_mha(q, q, q, block_q=32, block_k=32)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssm_scan(dA, dA)
    _, cfg = _cfgs(d_model=32)
    p = lm_init(cfg, seed=0, device="cpu")
    p = tree_map(lambda t: t[None].requires_grad_(True), p)
    tok = torch.zeros((1, 1, 8), dtype=torch.long)
    with pytest.raises(RuntimeError, match="forward-only"):
        make_loss_fn(cfg, ssm_scan_impl=ssm_scan)(p, {"tokens": tok})
    with torch.no_grad():
        flash_mha(q, q, q, block_q=32, block_k=32)
        ssm_scan(dA, dA)
        make_loss_fn(cfg, ssm_scan_impl=ssm_scan)(p, {"tokens": tok})


@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_tree_matches_reference(size):
    """Leaf paths and shapes of the port's falcon-mamba tree equal the
    reference's ``lm_init`` tree (the full size by shape only)."""
    if size == "reduced":
        ref_cfg, cfg = _cfgs()
    else:
        ref_cfg, cfg = ref_get_config("falcon-mamba-7b"), get_config("falcon-mamba-7b")
    shapes = jax.eval_shape(lambda k: ref_lm_init(k, ref_cfg)[0],
                            jax.random.key(0))
    want_leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    want_paths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
                  for p, _ in want_leaves]
    specs = lm_specs(cfg)
    leaves, _ = tree_flatten(specs)
    assert tree_paths(specs) == want_paths
    assert [s.shape for s in leaves] == [tuple(x.shape) for _, x in want_leaves]
    assert {s.dtype for s in leaves} == {torch.float32 if size == "reduced"
                                         else torch.bfloat16}
    if size == "full":
        n = sum(int(np.prod(s.shape)) for s in leaves)
        assert 7.2e9 < n < 7.35e9, n
