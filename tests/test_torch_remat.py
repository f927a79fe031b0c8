"""Long-sequence training in the port against the reference: the chunked
scan (``ssm_scan_chunked_torch`` against ``ssm_scan_chunked_jnp``),
per-layer remat (``remat`` / ``remat_policy`` on ``stack_apply``,
``lm_apply``, ``make_loss_fn`` and ``make_train_step_bundle``) and a dp=1
falcon-mamba train run with both, through both packages' bundles.

Inputs come from numpy with a seed, weights from the reference's
``lm_init`` through the bridge; everything is fp32. Tolerances: the scan's
forward rtol = atol = 1e-5, its gradients 1e-4 of their largest magnitude
(``tests/test_torch_mamba.py``); losses rtol 1e-4; the train run rtol = atol
= 2e-4 (``tests/test_hier_packed.py:417``). Remat recomputes the same ops,
so within the port its values are bit-equal to the run without it, with
PyTorch's deterministic algorithms on (the CPU embedding gather's backward
adds in no fixed order otherwise).
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
from repro_torch.core import build_layout  # noqa: E402
from repro_torch.models import lm_apply, lm_specs, reduced  # noqa: E402
from repro_torch.models.mamba import (ssm_assoc_scan,  # noqa: E402
                                      ssm_scan_chunked_torch)
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

B = 2
ARCHS = ("qwen3-0.6b", "falcon-mamba-7b", "stablelm-1.6b")
REMATS = {"off": dict(remat=False), "on": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}


@pytest.fixture(autouse=True)
def one_thread():
    """These tensors are tiny: one intra-op thread keeps a test from
    contending with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(arch, **kw):
    ref = dataclasses.replace(ref_reduced(ref_get_config(arch), **kw),
                              param_dtype="float32", compute_dtype="float32")
    port = dataclasses.replace(reduced(get_config(arch), **kw),
                               param_dtype="float32", compute_dtype="float32")
    return ref, port


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


# ------------------------------------------------------------ chunked scan

SCAN_CASES = [(64, 16), (40, 16), (12, 16), (16, 16)]   # multiple, ragged,
# shorter than a chunk, exactly one chunk


def _scan_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.3, 0.99, (2, S, 5, 4)).astype(np.float32)
    dBx = rng.normal(size=(2, S, 5, 4)).astype(np.float32)
    w = rng.normal(size=(2, S, 5, 4)).astype(np.float32)
    return dA, dBx, w


@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_chunked_scan_matches_reference(S, chunk):
    dA, dBx, _ = _scan_inputs(S)
    want = np.asarray(jax.jit(functools.partial(
        ssm_scan_chunked_jnp, chunk=chunk))(dA, dBx))
    got = ssm_scan_chunked_torch(torch.from_numpy(dA), torch.from_numpy(dBx),
                                 chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", SCAN_CASES)
def test_chunked_scan_gradients_match_reference(S, chunk):
    dA, dBx, w = _scan_inputs(S, seed=1)

    def ref_obj(a, b):
        return jnp.sum(ssm_scan_chunked_jnp(a, b, chunk=chunk) * w)
    want = jax.jit(jax.grad(ref_obj, argnums=(0, 1)))(dA, dBx)
    a = torch.from_numpy(dA).requires_grad_(True)
    b = torch.from_numpy(dBx).requires_grad_(True)
    (ssm_scan_chunked_torch(a, b, chunk=chunk)
     * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((a.grad, b.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_chunked_scan_falls_back_to_the_associative_scan():
    """S % chunk or S <= chunk: the associative scan itself, bit for
    bit, as the reference falls back."""
    for S, chunk in ((40, 16), (12, 16), (16, 16)):
        dA, dBx, _ = (torch.from_numpy(x) for x in _scan_inputs(S))
        assert torch.equal(ssm_scan_chunked_torch(dA, dBx, chunk=chunk),
                           ssm_assoc_scan(dA, dBx))


# ------------------------------------------------------------------ remat

def _batch(cfg, dp=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(dp, B, S + 1)).astype(np.int64))}


def _packed(cfg, seed=0, dp=2):
    from repro_torch.core import PackedParams
    from repro_torch.models import lm_init
    layout = build_layout(lm_specs(cfg))
    packed = PackedParams.pack(lm_init(cfg, seed=seed, device="cpu"), layout,
                               lead=(dp,), device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    return packed


def _loss_and_grads(cfg, packed, batch, **kw):
    for b in packed.buckets:
        b.grad = None
    loss, _ = make_loss_fn(cfg, **kw)(packed.unpack(), batch)
    loss.sum().backward()
    return loss.detach().clone(), [b.grad.clone() for b in packed.buckets]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_bit_equal_loss_and_packed_grads(arch, deterministic):
    _, cfg = _cfgs(arch, d_model=64)
    kw = ({"ssm_scan_impl": functools.partial(ssm_scan_chunked_torch,
                                              chunk=8)}
          if arch == "falcon-mamba-7b" else {})
    packed, batch = _packed(cfg), _batch(cfg)
    want_loss, want = _loss_and_grads(cfg, packed, batch, **kw)
    for name, remat in REMATS.items():
        loss, grads = _loss_and_grads(cfg, packed, batch, **kw, **remat)
        assert torch.equal(loss, want_loss), name
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), name


def _mixed_cfgs(third):
    """Three layers that ``segments_of`` splits into two segments: two of
    the reduced qwen3's attention layers, then one that differs only in
    its window (``third="window"``) or is the reduced falcon-mamba's mixer
    (``third="mamba"``)."""
    cfgs = []
    for cfg, mamba in zip(_cfgs("qwen3-0.6b", d_model=64),
                          _cfgs("falcon-mamba-7b", d_model=64)):
        a = cfg.blocks[0]
        last = (dataclasses.replace(a, attn=dataclasses.replace(a.attn,
                                                                window=4))
                if third == "window" else mamba.blocks[0])
        cfgs.append(dataclasses.replace(cfg, blocks=(a, a, last)))
    return cfgs


@pytest.mark.parametrize("third", ["window", "mamba"])
def test_remat_on_a_two_segment_stack(third, deterministic):
    """Backward recomputes each segment with its own layers: loss and
    packed gradients bit-equal with remat off, on and "dots", and the
    loss and gradients with remat on against the reference's."""
    from repro_torch.models.blocks import segments_of
    ref_cfg, cfg = _mixed_cfgs(third)
    assert len(segments_of(cfg.blocks)) == 2
    packed, batch = _packed(cfg), _batch(cfg)
    want_loss, want = _loss_and_grads(cfg, packed, batch)
    for name, remat in REMATS.items():
        loss, grads = _loss_and_grads(cfg, packed, batch, **remat)
        assert torch.equal(loss, want_loss), name
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), name

    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, 17)).astype(np.int32)
    tree = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    loss_fn = ref_make_loss_fn(ref_cfg, remat=True)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p, t: loss_fn(p, {"tokens": t})[0]))(tree, jnp.asarray(tokens))
    p = params_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], tree),
                          device="cpu")
    leaves, _ = tree_flatten(p)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = make_loss_fn(cfg, remat=True)(
        p, {"tokens": torch.from_numpy(tokens)[None]})
    loss.sum().backward()
    np.testing.assert_allclose(float(loss[0].detach()), float(ref_loss),
                               rtol=1e-4)
    for w, g in zip(leaves, jax.tree.leaves(ref_g)):
        g = np.asarray(g)
        np.testing.assert_allclose(w.grad[0].numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30))


def test_unported_and_unknown_remat_policies_raise():
    _, cfg = _cfgs("qwen3-0.6b", d_model=32)
    packed, batch = _packed(cfg), _batch(cfg)
    # save_moe_combine is ported (tests/test_torch_moe.py); without MoE it
    # saves nothing and changes no value
    want, _ = make_loss_fn(cfg, remat=True)(packed.unpack(), batch)
    got, _ = make_loss_fn(cfg, remat=True, remat_policy="save_moe_combine")(
        packed.unpack(), batch)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="remat_policy"):
        make_loss_fn(cfg, remat=True, remat_policy="everything")(
            packed.unpack(), batch)


def _ops_in_backward(cfg, packed, batch, **kw):
    """aten.bmm calls during the backward, and the forward's weight
    products (bmm calls made inside ``layers.weight_products``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.layers import weight_products

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bmm = self.weight = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                self.bmm += 1
                self.weight += weight_products()
            return func(*args, **(kwargs or {}))

    fwd, bwd = Count(), Count()
    with fwd:
        loss, _ = make_loss_fn(cfg, **kw)(packed.unpack(), batch)
    with bwd:
        loss.sum().backward()
    return fwd, bwd


def test_dots_policy_saves_exactly_the_weight_products():
    """Remat "on" replays the layers' forward in the backward, weight
    products included; "dots" replays none of the weight products (their
    outputs were saved) but still the other products (attention scores)."""
    _, cfg = _cfgs("qwen3-0.6b", d_model=32)
    packed, batch = _packed(cfg), _batch(cfg)
    fwd, bwd = {}, {}
    for name, kw in REMATS.items():
        fwd[name], bwd[name] = _ops_in_backward(cfg, packed, batch, **kw)
    assert fwd["off"].weight > 0 and fwd["off"].bmm > fwd["off"].weight
    assert bwd["off"].weight == 0
    assert bwd["on"].weight > 0
    assert bwd["dots"].weight == 0
    assert bwd["off"].bmm < bwd["dots"].bmm < bwd["on"].bmm


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("policy", [None, "dots"])
def test_remat_loss_matches_reference(arch, policy):
    """``make_loss_fn(remat=True)`` on the reference's weights against the
    reference's ``make_loss_fn(remat=True)``: loss and gradients; Mamba
    with the chunked scans of both packages."""
    ref_cfg, cfg = _cfgs(arch, d_model=64)
    chunk = 8
    ref_scan = port_scan = None
    if arch == "falcon-mamba-7b":
        ref_scan = functools.partial(ssm_scan_chunked_jnp, chunk=chunk)
        port_scan = functools.partial(ssm_scan_chunked_torch, chunk=chunk)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, size=(B, 17)).astype(np.int32)
    tree = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    loss_fn = ref_make_loss_fn(ref_cfg, ssm_scan_impl=ref_scan, remat=True,
                               remat_policy=policy)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, t: loss_fn(p, {"tokens": t})[0]))(tree, jnp.asarray(tokens))
    p = params_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], tree),
                          device="cpu")
    leaves, _ = tree_flatten(p)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = make_loss_fn(cfg, ssm_scan_impl=port_scan, remat=True,
                           remat_policy=policy)(
        p, {"tokens": torch.from_numpy(tokens)[None]})
    loss.sum().backward()
    np.testing.assert_allclose(float(loss[0].detach()), float(want), rtol=1e-4)
    for w, g in zip(leaves, jax.tree.leaves(want_g)):
        g = np.asarray(g)
        np.testing.assert_allclose(w.grad[0].numpy(), g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30))


def test_lm_apply_takes_remat_and_the_bundle_defaults_to_it():
    import inspect

    from repro_torch.models.blocks import stack_apply
    from repro_torch.train import make_train_step_bundle
    for fn in (lm_apply, stack_apply, make_loss_fn):
        sig = inspect.signature(fn).parameters
        assert sig["remat"].default is False
        assert sig["remat_policy"].default is None
    sig = inspect.signature(make_train_step_bundle).parameters
    assert sig["remat"].default is True and sig["remat_policy"].default is None
    assert sig["ssm_scan_impl"].default is None


# ------------------------------------------------ falcon-mamba, dp = 1

def test_dp1_mamba_remat_chunked_train_run_matches_reference():
    """Two steps of the reduced falcon-mamba through both packages' packed
    fused sgd bundles with remat and the chunked scan (chunk 8 under a
    16-token sequence, so two chunks run), dp = 1 (alpha = 0)."""
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
    ref_cfg, cfg = _cfgs("falcon-mamba-7b", d_model=64)
    seq, steps, chunk = 16, 2, 8
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    opt = ref_sgd(ref_step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    ss, sa, bs = train_input_specs(ref_cfg, dist, seq, 2, opt)
    bundle = ref_bundle(ref_cfg, dist, opt, state_shapes=ss, state_axes=sa,
                        batch_shapes=bs, protocol="gossip", remat=True,
                        gossip_packed=True,
                        ssm_scan_impl=functools.partial(ssm_scan_chunked_jnp,
                                                        chunk=chunk))
    state, _ = ref_init_state(jax.random.key(0), ref_cfg, dist, opt,
                              packed=True, layout=bundle.layout)
    tr = RefTrainer(bundle, state, RefDataset(vocab=ref_cfg.vocab, seq_len=seq,
                                              n_shards=1, batch_per_shard=2,
                                              seed=0), log_every=0)
    want = [h["loss"] for h in tr.run(steps)]
    init = _np_tree(ref_lm_init(jax.random.key(0), ref_cfg)[0])

    popt = sgd(step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    pb = make_train_step_bundle(
        cfg, popt, dp=1, gossip_packed=True, device="cpu", remat=True,
        ssm_scan_impl=functools.partial(ssm_scan_chunked_torch, chunk=chunk))
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


def test_launcher_turns_remat_off_on_one_rank(monkeypatch):
    """The reference's rule (``src/repro/launch/train.py:131``): remat off
    under --smoke or with one rank, on otherwise."""
    import repro_torch.launch.train as launch
    seen = []
    real = launch.make_train_step_bundle

    def spy(*a, **kw):
        seen.append(kw["remat"])
        return real(*a, **kw)
    monkeypatch.setattr(launch, "make_train_step_bundle", spy)
    for argv in (["--smoke"], []):
        launch.main(argv + ["--steps", "1", "--device", "cpu",
                            "--log-every", "0", "--d-model", "32"])
    assert seen == [False, False]
    # two ranks without --smoke: on (the run itself stacked, to stay in
    # this process)
    monkeypatch.setattr(launch, "world_from_env", lambda: 2)
    args = launch.parse_args(["--steps", "1", "--device", "cpu",
                              "--log-every", "0", "--d-model", "32"])
    dist = launch.make_distribution(launch.make_smoke_mesh(4, 1), "replica")
    launch._run(args, dist, "cpu", False)
    assert seen == [False, False, True]
