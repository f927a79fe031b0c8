"""The dense-attention members in the port against the reference: olmo-1b
(non-parametric LayerNorm), stablelm-1.6b (LayerNorm, partial rotary,
untied head), internlm2-20b (GQA 48H/8KV) and llava-next-mistral-7b (the
vision stub: image embeddings prepended, their logits dropped, and the
serving path's ``n_img`` offset).

The reference's weights cross through the bridge (``params_from_numpy``);
inputs come from numpy with a seed; everything is fp32 unless a test says
otherwise. Tolerances: norms, GELU and the GELU MLP rtol 2e-6 (atol 2e-6 of
the largest magnitude), bf16 inputs within one bf16 ulp (norms, computed in
fp32 and rounded once by both) or two (GELU, whose ops jnp runs in bf16);
forward and loss rtol 1e-4, gradients 1e-4 of their largest magnitude; the
dp=1 train run and serving rtol = atol = 2e-4 (``tests/test_hier_packed.py
:417``, ``tests/test_torch_serve.py``); checkpoints bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm_apply as ref_lm_apply  # noqa: E402
from repro.models import lm_cache_init as ref_lm_cache_init  # noqa: E402
from repro.models import lm_decode as ref_lm_decode  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import lm_prefill as ref_lm_prefill  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.attention import attn_apply as ref_attn_apply  # noqa: E402
from repro.models.attention import attn_init as ref_attn_init  # noqa: E402
from repro.models.config import AttnSpec as RefAttnSpec  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core import build_layout  # noqa: E402
from repro_torch.models import (AttnSpec, lm_apply, lm_axes,  # noqa: E402
                                lm_cache_init, lm_decode, lm_prefill,
                                lm_specs, reduced)
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.attention import attn_apply  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

ARCHS = ("olmo-1b", "stablelm-1.6b", "internlm2-20b", "llava-next-mistral-7b")
LLAVA = "llava-next-mistral-7b"
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


@pytest.fixture(autouse=True)
def one_thread():
    """These tensors are tiny: one intra-op thread keeps a test from
    contending with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _cfgs(arch, dtype="float32", **kw):
    ref = dataclasses.replace(ref_reduced(ref_configs.get_config(arch), **kw),
                              param_dtype=dtype, compute_dtype="float32")
    port = dataclasses.replace(reduced(configs.get_config(arch), **kw),
                               param_dtype=dtype, compute_dtype="float32")
    return ref, port


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(trees):
    return jax.tree.map(lambda *x: np.stack(x), *trees)


def _images(cfg, lead, seed=0):
    """Stub patch embeddings (*lead, n_image_tokens, d), or None."""
    if cfg.vision is None:
        return None
    return (np.random.default_rng(seed).standard_normal(
        tuple(lead) + (cfg.vision.n_image_tokens, cfg.d_model))
        .astype(np.float32) * np.float32(0.02))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _close_bf16(got: torch.Tensor, want, ulps: int):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert (np.abs(got - want) <= ulps * _bf16_ulp(want) + 1e-30).all()


# ------------------------------------------------------- norms, activations

def _norm_params(kind, d, rng):
    if kind == "nonparam":
        return {}
    p = {"scale": (1 + 0.1 * rng.normal(size=d)).astype(np.float32)}
    if kind == "ln":
        p["bias"] = (0.1 * rng.normal(size=d)).astype(np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln", "nonparam"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(0)
    d = 96
    x = (3 * rng.normal(size=(2, 3, 5, d)) + 1).astype(np.float32)
    ps = [_norm_params(kind, d, rng) for _ in range(2)]
    jdt = jnp.dtype(dtype)
    want = np.stack([np.asarray(ref_layers.norm_apply(
        kind, {k: jnp.asarray(v, jdt) for k, v in p.items()},
        jnp.asarray(xr, jdt)).astype(jnp.float32)) for p, xr in zip(ps, x)])
    tdt = getattr(torch, dtype)
    pp = {k: torch.from_numpy(np.stack([p[k] for p in ps])).to(tdt)
          for k in ps[0]}
    got = layers.norm_apply(kind, pp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                   atol=2e-6 * np.abs(want).max())
    else:
        _close_bf16(got, want, 1)


@pytest.mark.parametrize("kind", ["rms", "ln", "nonparam"])
def test_norm_init_matches_reference(kind):
    want, axes = ref_layers.norm_init(kind, 16)
    got = layers.norm_init(kind, 16)
    assert sorted(got) == sorted(want) and sorted(axes) == sorted(want)
    for k, spec in got.items():
        assert spec.shape == want[k].shape and spec.axes == axes[k]
        assert spec.init == {"scale": "ones", "bias": "zeros"}[k]
    with pytest.raises(ValueError):
        layers.norm_init("batch", 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_reference(dtype):
    x = (3 * np.random.default_rng(1).normal(size=(4, 257))).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(ref_layers.gelu(jnp.asarray(x, jdt)).astype(
        jnp.float32))
    got = layers.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                   atol=2e-6 * np.abs(want).max())
    else:
        _close_bf16(got, want, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_matches_reference(act, dtype):
    d, f = 32, 64
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 5, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    trees = [ref_layers.mlp_init(jax.random.key(i), d, f, act, jdt)
             for i in (0, 1)]
    assert sorted(trees[0][0]) == sorted(layers.mlp_init(d, f, act))
    want = np.stack([np.asarray(ref_layers.mlp_apply(
        p, jnp.asarray(xr, jdt), act).astype(jnp.float32))
        for (p, _), xr in zip(trees, x)])
    pp = params_from_numpy(_stack([_np_tree(p) for p, _ in trees]),
                           device="cpu")
    got = layers.mlp_apply(pp, torch.from_numpy(x).to(tdt), act)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                   atol=2e-6 * np.abs(want).max())
    else:   # bf16 products: one rounding of the hidden layer apart
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=0.02 * np.abs(want).max())
    with pytest.raises(ValueError):
        layers.mlp_apply(pp, torch.from_numpy(x).to(tdt), "relu")


def test_partial_rotary_attention_matches_reference():
    """stablelm-2's rope_frac 0.25 through attn_apply: 4 of each head's 16
    dims rotate."""
    d = 32
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=16, rope_frac=0.25)
    x = np.random.default_rng(3).normal(size=(2, B, 12, d)).astype(np.float32)
    ps = [ref_attn_init(jax.random.key(i), d, RefAttnSpec(**kw),
                        jnp.float32)[0] for i in (0, 1)]
    apply = jax.jit(lambda p, xr: ref_attn_apply(p, RefAttnSpec(**kw), xr))
    want = np.stack([np.asarray(apply(p, xr)) for p, xr in zip(ps, x)])
    pp = params_from_numpy(_stack([_np_tree(p) for p in ps]), device="cpu")
    got = attn_apply(pp, AttnSpec(**kw), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    full = attn_apply(pp, AttnSpec(**dict(kw, rope_frac=1.0)),
                      torch.from_numpy(x))
    assert not torch.allclose(got, full, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------- configs

def _on_port_fields(ref, port):
    """The reference's config value cut down to the fields the port's
    config has (it leaves out the families not ported yet)."""
    if isinstance(port, dict):
        return {k: _on_port_fields(ref[k], v) for k, v in port.items()}
    if isinstance(port, (list, tuple)) and len(port) == len(ref):
        return type(port)(_on_port_fields(r, v) for r, v in zip(ref, port))
    return ref


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for shrink in (lambda c: c, ref_reduced):
        want = dataclasses.asdict(shrink(ref_configs.get_config(arch)))
        got = dataclasses.asdict((reduced if shrink is ref_reduced
                                  else (lambda c: c))(
            configs.get_config(arch)))
        assert _on_port_fields(want, got) == got
    assert (reduced(configs.get_config(arch)).vision is None) == \
        (arch != LLAVA)


def _reference_fields(cfg: dict) -> dict:
    """A port config as a dict without ``SSMSpec.bcdt_norm``, a field the
    reference's ``SSMSpec`` lacks: it must hold None (no norms on dt, B
    and C, the reference's mixer) in every reference arch."""
    for b in cfg["blocks"]:
        if b["ssm"] is not None:
            assert b["ssm"].pop("bcdt_norm") is None
    return cfg


def test_list_archs_and_unported_archs():
    """Every reference arch is registered and loads, field for field (the
    MLA and MTP fields included); none is left unported."""
    assert configs.list_archs() == ref_configs.list_archs()
    assert configs.NOT_PORTED == {}
    for arch in ref_configs.list_archs():
        assert _reference_fields(dataclasses.asdict(
            configs.get_config(arch))) == \
            dataclasses.asdict(ref_configs.get_config(arch)), arch
    assert configs.get_config("deepseek-v3-671b").blocks[0].mla is not None
    with pytest.raises(KeyError):
        configs.get_config("gpt-2")


def _skeleton(tree, leaf):
    if isinstance(tree, dict):
        return {k: _skeleton(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v, leaf) for v in tree]
    return leaf(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_equal_the_references(arch):
    """Reduced: paths (empty norm dicts included), shapes, dtypes and
    logical axes equal the reference's ``lm_init`` tree. Full size: paths,
    shapes and dtypes against ``jax.eval_shape``, nothing allocated."""
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    params, axes = ref_lm_init(jax.random.key(0), ref_cfg)
    want = _skeleton(params, lambda x: (tuple(x.shape), str(x.dtype)))
    assert _skeleton(lm_specs(cfg), lambda s: (
        tuple(s.shape), str(s.dtype).split(".")[-1])) == want
    assert _skeleton(lm_axes(cfg), str) == _skeleton(axes, str)
    full, ref_full = configs.get_config(arch), ref_configs.get_config(arch)
    shapes = jax.eval_shape(lambda k: ref_lm_init(k, ref_full)[0],
                            jax.random.key(0))
    assert _skeleton(lm_specs(full), lambda s: (
        tuple(s.shape), str(s.dtype).split(".")[-1])) == _skeleton(
        shapes, lambda x: (tuple(x.shape), str(x.dtype)))
    if arch == "olmo-1b":
        assert lm_specs(cfg)["final_norm"] == {}
        assert params["final_norm"] == {}
    n = sum(int(np.prod(s.shape)) for s in tree_flatten(lm_specs(full))[0])
    want_n = {"olmo-1b": 1.18e9, "stablelm-1.6b": 1.64e9,
              "internlm2-20b": 19.86e9, LLAVA: 7.24e9}[arch]
    assert abs(n - want_n) < 0.01e9, n


# --------------------------------------------------- forward, loss, grads

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_packed_grads_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    S = 16
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, size=(2, B, S + 1)).astype(np.int32)
    images = _images(cfg, (2, B))
    trees = [ref_lm_init(jax.random.key(i), ref_cfg)[0] for i in (0, 1)]

    def batch_of(r):
        b = {"tokens": jnp.asarray(tokens[r])}
        if images is not None:
            b["image_embeds"] = jnp.asarray(images[r])
        return b
    apply = jax.jit(lambda t, b: ref_lm_apply(
        t, ref_cfg, b["tokens"][:, :-1],
        image_embeds=b.get("image_embeds"))[0])
    loss_fn = ref_make_loss_fn(ref_cfg)
    vg = jax.jit(jax.value_and_grad(lambda t, b: loss_fn(t, b)[0]))
    want_logits = np.stack([apply(t, batch_of(r)) for r, t in enumerate(trees)])
    want_loss, want_grads = zip(*[vg(t, batch_of(r))
                                  for r, t in enumerate(trees)])
    assert want_logits.shape == (2, B, S, cfg.vocab)   # image logits dropped

    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(_stack([_np_tree(t) for t in trees]),
                               layout=layout, device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens)}
    if images is not None:
        batch["image_embeds"] = torch.from_numpy(images)
    logits, aux = lm_apply(packed.unpack(), cfg, batch["tokens"][..., :-1],
                           image_embeds=batch.get("image_embeds"))
    assert all(torch.equal(a, torch.zeros(2)) for a in aux.values())
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-4, atol=1e-4 * np.abs(want_logits).max())
    loss, _ = make_loss_fn(cfg)(packed.unpack(), batch)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(),
                               [float(x) for x in want_loss], rtol=1e-4)
    want_packed = params_from_numpy(
        _stack([_np_tree(g) for g in want_grads]), layout=layout,
        device="cpu")
    for got, want in zip(packed.buckets, want_packed.buckets):
        want = want.numpy()
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    if images is not None:
        with pytest.raises(ValueError, match="image_embeds"):
            lm_apply(packed.unpack(), cfg, batch["tokens"][..., :-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_dp1_fused_train_run_matches_reference(arch):
    """Three steps of the reduced model through both packages' packed fused
    sgd bundles (dp = 1, alpha = 0) from one init, each step's batch from
    the synthetic pipeline plus, for llava, seeded image embeddings (the
    reference's train batch for a VLM, ``launch/specs.py``)."""
    from repro.data import ShardedTokenDataset as RefDataset
    from repro.data import make_replica_batches
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.specs import train_input_specs
    from repro.optim import sgd as ref_sgd
    from repro.optim import step_decay as ref_step_decay
    from repro.train import init_train_state as ref_init_state
    from repro.train import make_distribution
    from repro.train import make_train_step_bundle as ref_bundle
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import init_train_state, make_train_step_bundle
    ref_cfg, cfg = _cfgs(arch, d_model=64)
    seq, steps = 24, 3
    n_img = cfg.vision.n_image_tokens if cfg.vision else 0
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    opt = ref_sgd(ref_step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    ss, sa, bs = train_input_specs(ref_cfg, dist, seq, 2, opt)
    bundle = ref_bundle(ref_cfg, dist, opt, state_shapes=ss, state_axes=sa,
                        batch_shapes=bs, protocol="gossip", remat=False,
                        gossip_packed=True)
    state, _ = ref_init_state(jax.random.key(0), ref_cfg, dist, opt,
                              packed=True, layout=bundle.layout)
    ds = RefDataset(vocab=cfg.vocab, seq_len=seq - n_img, n_shards=1,
                    batch_per_shard=2, seed=0)
    batches = []
    for s in range(steps):
        b = dict(make_replica_batches(ds, s, 1))
        if n_img:
            b["image_embeds"] = _images(cfg, (1, 2), seed=s)
        batches.append(b)
    want = []
    period = max(bundle.protocol.period, 1)
    for s, b in enumerate(batches):
        state, _, m = bundle.jitted(s % period)(
            state, jax.tree.map(jnp.asarray, b))
        want.append(float(m["loss"]))
    init = _np_tree(ref_lm_init(jax.random.key(0), ref_cfg)[0])

    popt = sgd(step_decay(0.3, 0.1, 2), momentum=0.9, weight_decay=1e-4)
    pb = make_train_step_bundle(cfg, popt, dp=1, gossip_packed=True,
                                remat=False, device="cpu")
    assert pb.fused
    pstate = init_train_state(cfg, popt, dp=1, packed=True, layout=pb.layout,
                              params=params_from_numpy(init, layout=pb.layout,
                                                       lead=(1,), device="cpu"),
                              device="cpu")
    got = []
    for s, b in enumerate(batches):
        pstate, _, m = pb.step(pstate, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, s,
                               rotate=False)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(pstate["params"].buckets, state["params"].buckets):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ llava serving

def _serve_pair(window=None):
    ref_cfg, cfg = _cfgs(LLAVA)
    params = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    return (ref_cfg, params, cfg,
            params_from_numpy(_np_tree(params), device="cpu"))


def _close_tree(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_llava_prefill_past_the_window_then_decode_match_reference():
    """8 image positions and a 60-token prompt overrun the reduced 64-slot
    ring; prefill's logits and caches, then 3 decode steps from position
    68, against the reference."""
    ref_cfg, rp, cfg, pp = _serve_pair()
    assert cfg.blocks[0].attn.window == 64
    S, max_seq = 60, 128
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 3)).astype(
        np.int32)
    img = _images(cfg, (B,), seed=6)
    want, rc = jax.jit(lambda p, t, i, c: ref_lm_prefill(
        p, ref_cfg, t, c, image_embeds=i))(rp, toks[:, :S], img,
                                           ref_lm_cache_init(ref_cfg, B,
                                                             max_seq))
    got, pc = lm_prefill(pp, cfg, torch.from_numpy(toks[:, :S]),
                         lm_cache_init(cfg, B, max_seq, device="cpu"),
                         image_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree(pc, rc)
    dec = jax.jit(lambda p, t, c, pos: ref_lm_decode(p, ref_cfg, t, c, pos))
    for t in range(S, S + 3):
        pos = t + img.shape[1]
        want, rc = dec(rp, jnp.asarray(toks[:, t]), rc, jnp.int32(pos))
        got, pc = lm_decode(pp, cfg, torch.from_numpy(toks[:, t]).long(), pc,
                            torch.tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree(pc, rc)


def test_llava_engine_generates_the_references_tokens(monkeypatch):
    """Greedy tokens equal the reference engine's, and decode starts at
    S + n_img."""
    from repro.serve import ServingEngine as RefEngine

    import repro_torch.serve.engine as engine_mod
    from repro_torch.serve import ServingEngine
    ref_cfg, rp, cfg, pp = _serve_pair()
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (B, 10)).astype(
        np.int32)
    img = _images(cfg, (B,), seed=8)
    want = RefEngine(ref_cfg, rp, max_seq=64).generate(prompts, 6,
                                                       image_embeds=img)
    seen = []
    real = engine_mod.lm_decode

    def spy(p, c, tok, caches, pos):
        seen.append(int(pos))
        return real(p, c, tok, caches, pos)
    monkeypatch.setattr(engine_mod, "lm_decode", spy)
    got = ServingEngine(cfg, pp, max_seq=64, device="cpu").generate(
        prompts, 6, image_embeds=img)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert seen == list(range(10 + 8, 10 + 8 + 6))
    with pytest.raises(AssertionError, match="cache too small"):
        ServingEngine(cfg, pp, max_seq=20, device="cpu").generate(
            prompts, 3, image_embeds=img)


def test_prefill_step_with_image_is_lm_prefill():
    from repro.launch.mesh import make_smoke_mesh as ref_make_smoke_mesh
    from repro.serve.step import make_prefill_step as ref_make_prefill_step
    from repro.train import make_distribution as ref_make_distribution
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.serve import make_prefill_step
    from repro_torch.train import make_distribution
    ref_cfg, rp, cfg, pp = _serve_pair()
    rdist = ref_make_distribution(ref_make_smoke_mesh(1, 1), "replica")
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    rcache = jax.eval_shape(lambda: ref_lm_cache_init(ref_cfg, B, 32))
    want = ref_make_prefill_step(ref_cfg, rdist, param_shapes=rp,
                                 param_axes=ref_lm_init(jax.random.key(0),
                                                        ref_cfg)[1],
                                 cache_shapes=rcache, with_image=True)
    cache = lm_cache_init(cfg, B, 32, device="cpu")
    bundle = make_prefill_step(cfg, dist, param_shapes=lm_specs(cfg),
                               param_axes=lm_axes(cfg), cache_shapes=cache,
                               with_image=True)
    assert [tuple(s) for s in bundle.in_specs] == \
        [tuple(s) for s in want.in_specs]
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, 6)))
    img = torch.from_numpy(_images(cfg, (B,), seed=10))
    got, gc = bundle.step_fn(pp, cache, toks, img)
    ref, rc = lm_prefill(pp, cfg, toks, lm_cache_init(cfg, B, 32,
                                                      device="cpu"),
                         image_embeds=img)
    assert torch.equal(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(gc)[0],
                                                 tree_flatten(rc)[0]))
    # with audio frames too (the reference's argument order: image, then
    # frames): llava has no encoder, so the frames change nothing
    both = make_prefill_step(cfg, dist, param_shapes=lm_specs(cfg),
                             param_axes=lm_axes(cfg), cache_shapes=cache,
                             with_image=True, with_audio=True)
    want = ref_make_prefill_step(ref_cfg, rdist, param_shapes=rp,
                                 param_axes=ref_lm_init(jax.random.key(0),
                                                        ref_cfg)[1],
                                 cache_shapes=rcache, with_image=True,
                                 with_audio=True)
    assert [tuple(s) for s in both.in_specs] == \
        [tuple(s) for s in want.in_specs]
    again, _ = both.step_fn(pp, lm_cache_init(cfg, B, 32, device="cpu"), toks,
                            img, torch.ones(B, 3, cfg.d_model))
    assert torch.equal(again, ref)


def test_serve_cli_runs_llava_with_image_embeddings():
    from repro_torch.serve.__main__ import main
    main(["--arch", LLAVA, "--device", "cpu", "--new-tokens", "3",
          "--prompt-len", "5"])


# -------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b"])
def test_checkpoints_cross_packages_bit_for_bit(tmp_path, arch):
    """olmo's empty norm dicts and stablelm's LN bias and untied head, in
    bf16: a trained port state restores in the reference and a reference
    state in the port, every leaf bit for bit."""
    from repro.checkpoint import restore_state as ref_restore
    from repro.checkpoint import save_state as ref_save
    from repro.checkpoint.io import _unpack_view as ref_unpack_view
    from repro.core import PackedParams as RPacked
    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.checkpoint.io import _host, _leaves
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd
    from repro_torch.tree import keystr
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16", d_model=32)
    dp = 2
    init = _np_tree(ref_lm_init(jax.random.key(0), ref_cfg)[0])
    tree = jax.tree.map(lambda a: np.stack([a, (a.astype(np.float32) * 1.01)
                                            .astype(a.dtype)]), init)

    def port_state(steps):
        opt = sgd(0.1, momentum=0.9)
        b = make_train_step_bundle(cfg, opt, dp=dp, gossip_packed=True,
                                   device="cpu")
        st = init_train_state(cfg, opt, dp=dp, packed=True, layout=b.layout,
                              params=params_from_numpy(tree, layout=b.layout,
                                                       device="cpu"),
                              device="cpu")
        if steps:
            tr = Trainer(b, st, ShardedTokenDataset(cfg.vocab, 8, n_shards=dp,
                                                    batch_per_shard=1),
                         log_every=0)
            tr.run(steps)
            st = tr.state
        return st

    def ref_state(seed):
        packed = RPacked.pack(jax.tree.map(jnp.asarray, tree), skip_leading=1)
        rng = np.random.default_rng(seed)
        mom = RPacked([jnp.asarray(rng.normal(size=b.shape).astype(
            np.float32)).astype(b.dtype) for b in packed.buckets],
            packed.layout)
        return {"params": packed, "opt": {"step": jnp.int32(3), "mom": mom}}

    def bits(x):
        x = np.ascontiguousarray(np.asarray(x))
        return x.view({2: np.uint16, 4: np.uint32}[x.dtype.itemsize])

    def port_flat(st):
        return {keystr(p): bits(v.float().numpy() if v.dtype == torch.bfloat16
                                else v.numpy()) if isinstance(v, torch.Tensor)
                else bits(np.int32(v)) for p, v in _leaves(_host(st), ())}

    def ref_flat(st):
        leaves, _ = jax.tree_util.tree_flatten_with_path(ref_unpack_view(st))
        return {jax.tree_util.keystr(p): bits(np.asarray(v, np.float32)
                                              if v.dtype == jnp.bfloat16
                                              else v) for p, v in leaves}

    def same(got, want):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    st = port_state(2)
    keys = port_flat(st)
    if arch == "olmo-1b":
        assert not any("norm" in k for k in keys)
        assert st["params"].unpack()["final_norm"] == {}
    else:
        assert any(k.endswith("['bias']") for k in keys)
        assert any("lm_head" in k for k in keys)
    save_state(str(tmp_path / "port"), st, step=2)
    rest, _ = ref_restore(str(tmp_path / "port"), ref_state(1))
    same(ref_flat(rest), keys)

    want = ref_state(2)
    ref_save(str(tmp_path / "ref"), want, step=3)
    got, man = restore_state(str(tmp_path / "ref"), port_state(0))
    assert man["step"] == 3
    same(port_flat(got), ref_flat(want))
    if arch == "olmo-1b":
        assert got["params"].unpack()["layers"][0][0]["norm1"] == {}
    assert tree_paths(got["params"].unpack()) == \
        tree_paths(st["params"].unpack())


def test_empty_dicts_flatten_as_jax_pytrees():
    """An empty dict (olmo's norms) is a node with no leaves in JAX's
    pytree: the same leaves, paths and round trip in ``repro_torch.tree``,
    and olmo's bucket slot table equals the reference's."""
    from repro.core.buckets import build_layout as ref_build_layout
    from repro_torch.tree import keystr
    tree = {"a": {}, "b": [np.float32(1), {}, {"c": np.float32(2)}], "d": {}}
    leaves, td = tree_flatten(tree)
    want, want_td = jax.tree_util.tree_flatten_with_path(tree)
    assert leaves == [x for _, x in want]
    assert [keystr(p) for p in tree_paths(tree)] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    assert td.unflatten(leaves) == tree == jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), [x for _, x in want])
    ref_cfg, cfg = _cfgs("olmo-1b", dtype="bfloat16")
    ref_lay = ref_build_layout(jax.eval_shape(
        lambda k: ref_lm_init(k, ref_cfg)[0], jax.random.key(0)))
    lay = build_layout(lm_specs(cfg))
    fields = ("index", "bucket", "offset", "size", "shape", "dtype")
    assert [tuple(getattr(s, f) for f in fields) for s in lay.slots] == \
        [tuple(getattr(s, f) for f in fields) for s in ref_lay.slots]
    assert lay.bucket_sizes == tuple(ref_lay.bucket_sizes)
