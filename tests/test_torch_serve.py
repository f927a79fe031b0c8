"""The port's serving path against the reference's: the attention and Mamba
decode steps, the prefill cache writes, ``lm_prefill`` / ``lm_decode`` on
reduced fp32 qwen3-0.6b (full and with a 4-slot sliding window) and
falcon-mamba-7b, ``ServingEngine.generate``, the serve steps' placement
specs, ``SHAPES`` and ``with_sliding_window``, the serving embedding gather
and ``python -m repro_torch.serve``.

The reference's weights cross through the bridge (``params_from_numpy``);
inputs come from numpy with a seed; everything runs on the CPU. Tolerances:
logits and caches at the reference's end-to-end rtol = atol = 2e-4
(``tests/test_models_smoke.py:99``), mixer steps at rtol = atol = 1e-5 (one
layer of fp32 arithmetic in another op order), bf16 logits within 4 bf16
ulps of the largest; cache writes, greedy tokens and the embedding gather
bit for bit.
"""
import dataclasses
import gc
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm_cache_init as ref_lm_cache_init  # noqa: E402
from repro.models import lm_decode as ref_lm_decode  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import lm_prefill as ref_lm_prefill  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.blocks import _cache_write_seq as ref_cache_write_seq  # noqa: E402
from repro.models.config import AttnSpec as RefAttnSpec  # noqa: E402
from repro.models.config import SSMSpec as RefSSMSpec  # noqa: E402
from repro.serve import ServingEngine as RefServingEngine  # noqa: E402
from repro.serve import cache_axes as ref_cache_axes  # noqa: E402
from repro.serve import make_decode_step as ref_make_decode_step  # noqa: E402
from repro.serve import make_prefill_step as ref_make_prefill_step  # noqa: E402
from repro.train import make_distribution as ref_make_distribution  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import (AttnSpec, SSMSpec, lm_apply,  # noqa: E402
                                lm_axes, lm_cache_init, lm_decode, lm_prefill,
                                reduced)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.blocks import _cache_write_seq  # noqa: E402
from repro_torch.models.transformer import (_embed_gather,  # noqa: E402
                                            _embed_lookup)
from repro_torch.serve import (ServingEngine, cache_axes,  # noqa: E402
                               make_decode_step, make_prefill_step)
from repro_torch.serve.__main__ import main as serve_main  # noqa: E402
from repro_torch.train import make_distribution  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
# (arch, sliding window): the three reduced fp32 models of the serve checks
MODELS = [("qwen3-0.6b", None), ("qwen3-0.6b", 4), ("falcon-mamba-7b", None)]
MODEL_IDS = ["qwen3", "qwen3-sw4", "falcon-mamba"]


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny tensors: one intra-op thread keeps a test from contending with
    the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch, window=None):
    ref = dataclasses.replace(ref_reduced(ref_configs.get_config(arch)),
                              param_dtype="float32", compute_dtype="float32")
    port = dataclasses.replace(reduced(configs.get_config(arch)),
                               param_dtype="float32", compute_dtype="float32")
    if window is not None:
        ref = ref_configs.with_sliding_window(ref, window)
        port = configs.with_sliding_window(port, window)
    return ref, port


def _params(ref_cfg):
    """The reference's params from key 0, and the same values in the port."""
    params, _ = ref_lm_init(jax.random.key(0), ref_cfg)
    return params, params_from_numpy(jax.tree.map(np.asarray, params),
                                     device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)


def _caches_close(got, want, tol=TOL):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


# ----------------------------------------------------------- attention

def _attn_pair(window, d=32, seed=0):
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
              window=window)
    rp, _ = ref_attn.attn_init(jax.random.key(seed), d, RefAttnSpec(**kw),
                               jnp.float32)
    pp = {k: _t(v)[None] for k, v in rp.items()}   # one replica
    return RefAttnSpec(**kw), rp, AttnSpec(**kw), pp


@pytest.mark.parametrize("window", [None, 4])
def test_attn_decode_steps_match_reference(window):
    """Ten one-token steps from position 0 against the reference's
    attn_decode: outputs and both cache leaves after every step (the ring
    wraps twice with window 4); the port's position is a 0-d tensor."""
    rspec, rp, spec, pp = _attn_pair(window)
    B, T, d = 2, 10, 32
    x = np.random.default_rng(3).normal(size=(B, T, d)).astype(np.float32)
    rc = ref_attn.attn_cache_init(rspec, B, 16, jnp.float32)
    pc = tree_map(lambda c: c[None],
                  attn.attn_cache_init(spec, B, 16, torch.float32,
                                       device="cpu"))
    assert pc["k"].shape[2] == attn.cache_len(16, window) == \
        ref_attn.cache_len(16, window)
    step = jax.jit(lambda c, x1, pos: ref_attn.attn_decode(rp, rspec, x1, c,
                                                           pos))
    for t in range(T):
        y_ref, rc = step(rc, x[:, t:t + 1], jnp.int32(t))
        y, pc = attn.attn_decode(pp, spec, _t(x[None, :, t:t + 1]), pc,
                                 torch.tensor(t))
        _close(y[0], y_ref, STEP_TOL)
        for k in ("k", "v"):
            _close(pc[k][0], rc[k], STEP_TOL)


def test_ring_prefill_then_decode_matches_windowed_apply():
    """Prefill longer than the window writes the trailing window at its
    ring slots; the decode steps after it equal full-sequence windowed
    attention, the reference's and the port's (test_attention.py:149)."""
    rspec, rp, spec, pp = _attn_pair(4, seed=7)
    B, S_pre, S_dec, d = 2, 11, 4, 32
    S = S_pre + S_dec
    x = (np.random.default_rng(8).normal(size=(B, S, d)) * 0.4).astype(
        np.float32)
    want = ref_attn.attn_apply(rp, rspec, jnp.asarray(x))
    own = attn.attn_apply(pp, spec, _t(x)[None])[0]
    pos = torch.arange(S_pre)[None]
    xt = _t(x[:, :S_pre])[None]
    _, k, v = attn._project_qkv(pp, spec, xt, xt, pos, pos)
    cache = tree_map(lambda c: c[None],
                     attn.attn_cache_init(spec, B, 4, torch.float32,
                                          device="cpu"))
    cache = {"k": _cache_write_seq(cache["k"], k, 2),
             "v": _cache_write_seq(cache["v"], v, 2)}
    outs = []
    for t in range(S_pre, S):
        y, cache = attn.attn_decode(pp, spec, _t(x[None, :, t:t + 1]), cache,
                                    torch.tensor(t))
        outs.append(y[0])
    dec = torch.cat(outs, dim=1)
    _close(dec, _np(want)[:, S_pre:])
    torch.testing.assert_close(dec, own[:, S_pre:], **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [3, 8, 11, 16, 21])
def test_cache_write_seq_is_the_references_bit_for_bit(S, dtype):
    """L = 8: S <= L writes the front and keeps the rest of the cache;
    S > L keeps the last L positions rolled to their ring slots; fp32
    inputs round once into a bf16 cache."""
    rng = np.random.default_rng(S)
    cache = rng.normal(size=(2, 8, 3, 4)).astype(np.float32)
    full = rng.normal(size=(2, S, 3, 4)).astype(np.float32)
    want = ref_cache_write_seq(jnp.asarray(cache, dtype), jnp.asarray(full))
    got = _cache_write_seq(_t(cache).to(getattr(torch, dtype)), _t(full))
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# ----------------------------------------------------------- mamba

def test_mamba_decode_steps_match_reference():
    """Six recurrent steps from a random state against the reference's
    mamba_decode: outputs, h and the conv tail after every step."""
    kw = dict(d_state=8, d_conv=4, expand=2)
    d, B, T = 32, 2, 6
    rp, _ = ref_mamba.mamba_init(jax.random.key(0), d, RefSSMSpec(**kw),
                                 jnp.float32)
    pp = {k: _t(v)[None] for k, v in rp.items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    st = {"h": rng.normal(size=(B, 2 * d, 8)).astype(np.float32),
          "conv": rng.normal(size=(B, 3, 2 * d)).astype(np.float32)}
    rs = jax.tree.map(jnp.asarray, st)
    ps = {k: _t(v)[None] for k, v in st.items()}
    step = jax.jit(lambda s, x1: ref_mamba.mamba_decode(
        rp, RefSSMSpec(**kw), d, x1, s))
    for t in range(T):
        y_ref, rs = step(rs, x[:, t:t + 1])
        y, ps = mamba.mamba_decode(pp, SSMSpec(**kw), d,
                                   _t(x[None, :, t:t + 1]), ps)
        _close(y[0], y_ref, STEP_TOL)
        for k in ("h", "conv"):
            _close(ps[k][0], rs[k], STEP_TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_short_mamba_prompt_leaves_the_references_short_tail(S):
    """A prompt shorter than d_conv - 1 = 3: the reference's prefill
    returns a conv tail of S inputs and its decode then fails; the port's
    prefill returns the same tail and its decode refuses it."""
    rcfg, cfg = _cfgs("falcon-mamba-7b")
    rparams, params = _params(rcfg)
    toks = _tokens(cfg, 2, S)
    _, rc = ref_lm_prefill(rparams, rcfg, jnp.asarray(toks),
                           ref_lm_cache_init(rcfg, 2, 16))
    _, pc = lm_prefill(params, cfg, _t(toks), lm_cache_init(
        cfg, 2, 16, device="cpu"))
    _caches_close(pc, rc)
    assert pc[0][0]["ssm"]["conv"].shape[2] == S
    with pytest.raises(ValueError):
        ref_lm_decode(rparams, rcfg, jnp.asarray(toks[:, -1]), rc,
                      jnp.int32(S))
    with pytest.raises(ValueError, match="d_conv - 1"):
        lm_decode(params, cfg, _t(toks[:, -1]), pc, S)


# ----------------------------------------------------------- whole model

@pytest.mark.parametrize("arch,window", MODELS, ids=MODEL_IDS)
def test_cache_tree_is_the_references(arch, window):
    rcfg, cfg = _cfgs(arch, window)
    want = ref_lm_cache_init(rcfg, 3, 24)
    got = lm_cache_init(cfg, 3, 24, device="cpu")
    assert tree_map(lambda c: (tuple(c.shape), str(c.dtype)[6:]), got) == \
        jax.tree.map(lambda c: (c.shape, str(c.dtype)), want)


@pytest.mark.parametrize("arch,window", MODELS, ids=MODEL_IDS)
def test_prefill_and_decode_match_reference(arch, window):
    """Prefill 12 tokens (3 windows on the windowed model), then 4 decode
    steps at device positions: logits and every cache leaf against the
    reference's after each call."""
    rcfg, cfg = _cfgs(arch, window)
    rparams, params = _params(rcfg)
    B, S, steps = 2, 12, 4
    toks = _tokens(cfg, B, S + steps)
    rpre = jax.jit(lambda p, t, c: ref_lm_prefill(p, rcfg, t, c))
    rdec = jax.jit(lambda p, t, c, pos: ref_lm_decode(p, rcfg, t, c, pos))
    want, rc = rpre(rparams, jnp.asarray(toks[:, :S]),
                    ref_lm_cache_init(rcfg, B, 32))
    got, pc = lm_prefill(params, cfg, _t(toks[:, :S]),
                         lm_cache_init(cfg, B, 32, device="cpu"))
    _close(got, want)
    _caches_close(pc, rc)
    for t in range(S, S + steps):
        want, rc = rdec(rparams, jnp.asarray(toks[:, t]), rc, jnp.int32(t))
        got, pc = lm_decode(params, cfg, _t(toks[:, t]), pc, torch.tensor(t))
        _close(got, want)
        _caches_close(pc, rc)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_bf16_prefill_and_decode_match_reference(arch):
    """The configs' own bf16: decode's fp32 query (RoPE's tables are fp32)
    meets the bf16 cache, which the reference's einsum promotes. Each side
    rounds every op's output to bf16 in its own op order, so logits agree
    within 4 bf16 ulps of the largest logit."""
    rcfg = ref_reduced(ref_configs.get_config(arch))
    cfg = reduced(configs.get_config(arch))
    assert cfg.param_dtype == rcfg.param_dtype == "bfloat16"
    rparams, params = _params(rcfg)
    B, S, steps = 2, 10, 3
    toks = _tokens(cfg, B, S + steps)
    rdec = jax.jit(lambda p, t, c, pos: ref_lm_decode(p, rcfg, t, c, pos))
    want, rc = jax.jit(lambda p, t, c: ref_lm_prefill(p, rcfg, t, c))(
        rparams, jnp.asarray(toks[:, :S]), ref_lm_cache_init(rcfg, B, 32))
    got, pc = lm_prefill(params, cfg, _t(toks[:, :S]),
                         lm_cache_init(cfg, B, 32, device="cpu"))
    for t in range(S, S + steps + 1):
        assert got.dtype == torch.bfloat16
        w = np.asarray(want, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=4 * ulp)
        if t < S + steps:
            want, rc = rdec(rparams, jnp.asarray(toks[:, t]), rc,
                            jnp.int32(t))
            got, pc = lm_decode(params, cfg, _t(toks[:, t]), pc,
                                torch.tensor(t))


@pytest.mark.parametrize("arch,window", MODELS, ids=MODEL_IDS)
def test_decode_matches_own_full_forward(arch, window):
    """prefill(t[:-1]) + decode(t[-1]) == lm_apply(t) at the last position,
    the reference's own check (tests/test_models_smoke.py:74) on the
    port alone."""
    _, cfg = _cfgs(arch, window)
    from repro_torch.models import lm_init
    params = lm_init(cfg, seed=3, device="cpu")
    B, S = 2, 12
    toks = _t(_tokens(cfg, B, S, seed=4)).long()
    full, _ = lm_apply(tree_map(lambda w: w[None], params), cfg, toks[None])
    _, caches = lm_prefill(params, cfg, toks[:, :-1],
                           lm_cache_init(cfg, B, 64, device="cpu"))
    logits, _ = lm_decode(params, cfg, toks[:, -1], caches, S - 1)
    torch.testing.assert_close(logits, full[0, :, -1], **TOL)


@pytest.mark.parametrize("arch,window", MODELS, ids=MODEL_IDS)
def test_engine_generates_the_references_tokens(arch, window):
    """Greedy tokens from the port's engine equal the reference engine's,
    and a second call gives the same tokens."""
    rcfg, cfg = _cfgs(arch, window)
    rparams, params = _params(rcfg)
    prompts = _tokens(cfg, 3, 8, seed=2)
    want = RefServingEngine(rcfg, rparams, max_seq=64).generate(prompts, 6)
    eng = ServingEngine(cfg, params, max_seq=64, device="cpu")
    got = eng.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.generate(prompts, 6), got)


def test_engine_reads_nothing_back_inside_its_loop(monkeypatch):
    """No token or position crosses to the host before the loop ends: every
    tensor-to-Python conversion raises while generate runs, and the tokens
    come back once, as one array."""
    _, cfg = _cfgs("qwen3-0.6b", 4)
    from repro_torch.models import lm_init
    eng = ServingEngine(cfg, lm_init(cfg, seed=0, device="cpu"), max_seq=32,
                        device="cpu")
    prompts = _tokens(cfg, 2, 6)
    want = eng.generate(prompts, 5)

    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read back inside the loop")

    for name in ("item", "tolist", "__bool__", "__int__", "__index__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = eng.generate(prompts, 5)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, want)


def test_engine_frees_its_cache_without_the_cycle_collector():
    """The decode cache (30 GB at qwen3's full width and 32k slots) goes
    when ``generate`` returns, with the cycle collector off: no reference
    cycle (a self-recursive closure over the leaves, as ``tree.py`` once
    had) keeps it or a view of it alive."""
    _, cfg = _cfgs("qwen3-0.6b", 4)
    from repro_torch.models import lm_init
    eng = ServingEngine(cfg, lm_init(cfg, seed=0, device="cpu"), max_seq=32,
                        device="cpu")

    def cache_views():
        return sum(type(o) is torch.Tensor and o.dim() >= 5
                   for o in gc.get_objects())

    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        before = cache_views()
        eng.generate(_tokens(cfg, 2, 6), 3)
        assert cache_views() == before
    finally:
        if was:
            gc.enable()


def test_engine_and_prefill_refuse_what_is_not_ported():
    _, cfg = _cfgs("qwen3-0.6b")
    from repro_torch.models import lm_init
    params = lm_init(cfg, seed=0, device="cpu")
    eng = ServingEngine(cfg, params, max_seq=32, device="cpu")
    # a model without an encoder ignores audio frames, as the reference's
    # does; an enc-dec model needs them
    np.testing.assert_array_equal(
        eng.generate(_tokens(cfg, 1, 4), 2,
                     audio_frames=np.ones((1, 2, cfg.d_model), np.float32)),
        eng.generate(_tokens(cfg, 1, 4), 2))
    _, whisper = _cfgs("whisper-base")
    with pytest.raises(ValueError, match="audio_frames"):
        ServingEngine(whisper, lm_init(whisper, seed=0, device="cpu"),
                      max_seq=32, device="cpu").generate(
            _tokens(whisper, 1, 4), 2)
    with pytest.raises(AssertionError, match="cache too small"):
        eng.generate(_tokens(cfg, 1, 30), 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(cfg, params, max_seq=32)
        with pytest.raises(RuntimeError, match="cuda"):
            lm_cache_init(cfg, 1, 8)


# ----------------------------------------------------------- serve steps

SPEC_MESHES = [((1, 4, 1), "replica"), ((1, 2, 2), "replica"),
               ((2, 2, 2), "fsdp")]


def _ref_specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_cache_axes_equal_the_references(arch):
    rcfg, cfg = _cfgs(arch)
    assert cache_axes(cfg) == ref_cache_axes(rcfg)


@pytest.mark.parametrize("shape,mode", SPEC_MESHES,
                         ids=["1x4x1", "1x2x2", "fsdp-2x2x2"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_serve_step_specs_equal_the_references(arch, shape, mode):
    """The decode and prefill steps' param, cache and input specs on the
    ported plan equal the reference's on an AbstractMesh of the same shape
    (batch 4 shards over the data axes; batch 1 leaves the cache sequence
    to ``data``); the port's step functions are lm_decode / lm_prefill."""
    pod, data, model = shape
    rcfg, cfg = _cfgs(arch)
    mesh = make_smoke_mesh(data, model, pod=pod)
    dist = make_distribution(mesh, mode)
    rdist = ref_make_distribution(
        AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names)), mode)
    rparams, raxes = ref_lm_init(jax.random.key(0), rcfg)
    from repro_torch.models import lm_specs
    for batch in (4, 1):
        rcache = jax.eval_shape(lambda: ref_lm_cache_init(rcfg, batch, 32))
        pcache = lm_cache_init(cfg, batch, 32, device="cpu")
        for rmake, make in ((ref_make_decode_step, make_decode_step),
                            (ref_make_prefill_step, make_prefill_step)):
            want = rmake(rcfg, rdist, param_shapes=rparams, param_axes=raxes,
                         cache_shapes=rcache)
            got = make(cfg, dist, param_shapes=lm_specs(cfg),
                       param_axes=lm_axes(cfg), cache_shapes=pcache)
            assert got.param_specs == _ref_specs(want.param_specs)
            assert got.cache_specs == _ref_specs(want.cache_specs)
            assert [tuple(s) for s in got.in_specs] == \
                [tuple(s) for s in want.in_specs]
    params = params_from_numpy(jax.tree.map(np.asarray, rparams),
                               device="cpu")
    toks = _t(_tokens(cfg, 4, 6))
    bundle = make_prefill_step(cfg, dist, param_shapes=lm_specs(cfg),
                               param_axes=lm_axes(cfg),
                               cache_shapes=lm_cache_init(cfg, 4, 32,
                                                          device="cpu"))
    logits, cache = bundle.step_fn(params, lm_cache_init(
        cfg, 4, 32, device="cpu"), toks)
    want, _ = lm_prefill(params, cfg, toks, lm_cache_init(cfg, 4, 32,
                                                          device="cpu"))
    assert torch.equal(logits, want)
    dec = make_decode_step(cfg, dist, param_shapes=lm_specs(cfg),
                           param_axes=lm_axes(cfg), cache_shapes=cache)
    logits, _ = dec.step_fn(params, cache, toks[:, -1], torch.tensor(6))
    assert logits.shape == (4, cfg.vocab)
    # with_audio takes frames after the tokens; a model without an encoder
    # ignores them, as the reference's does
    audio = make_prefill_step(cfg, dist, param_shapes=lm_specs(cfg),
                              param_axes=lm_axes(cfg), cache_shapes=cache,
                              with_audio=True)
    assert len(audio.in_specs) == 2
    logits, _ = audio.step_fn(params, lm_cache_init(cfg, 4, 32, device="cpu"),
                              toks, torch.ones(4, 3, cfg.d_model))
    assert torch.equal(logits, want)


# ----------------------------------------------------------- configs

def test_shapes_and_sliding_window_equal_the_references():
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.LONG_CONTEXT_WINDOW == ref_configs.LONG_CONTEXT_WINDOW
    for arch in configs.list_archs():
        for window in (4, configs.LONG_CONTEXT_WINDOW):
            got = configs.with_sliding_window(configs.get_config(arch), window)
            want = ref_configs.with_sliding_window(
                ref_configs.get_config(arch), window)
            assert got.name == want.name
            assert [b.kind for b in got.blocks] == \
                [b.kind for b in want.blocks]
            assert [b.attn and dataclasses.asdict(b.attn) for b in
                    got.blocks] == [b.attn and dataclasses.asdict(b.attn)
                                    for b in want.blocks]
    # a window already set stays
    cfg = configs.with_sliding_window(configs.get_config("qwen3-0.6b"), 8)
    assert configs.with_sliding_window(cfg, 4).blocks[0].attn.window == 8


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serving_gather_is_the_staged_lookup_bit_for_bit(dtype):
    """Serving gathers the rows and skips ``_embed_lookup``'s fp32 staging
    of the table: the same bits (a bf16 -> fp32 -> bf16 round trip is
    exact), without a table-sized copy."""
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn(1, 300, 24, generator=gen) * 3).to(getattr(torch,
                                                                  dtype))
    emb.view(-1)[:4] = torch.tensor([float("inf"), -0.0, 1e-40, 65504])
    toks = torch.randint(0, 300, (1, 5, 7), generator=gen)
    toks[0, 0, 0] = 0
    got = _embed_gather({"embed": emb}, toks)
    want = _embed_lookup({"embed": emb}, toks)
    assert got.dtype == want.dtype
    ints = {2: torch.int16, 4: torch.int32}[emb.element_size()]
    assert torch.equal(got.view(ints), want.view(ints))


# ----------------------------------------------------------- the CLI

def test_serve_cli_runs_on_cpu():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
         "--arch", "falcon-mamba-7b", "--new-tokens", "5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "generated (4, 5)" in out.stdout
    assert "first row:" in out.stdout


def test_serve_cli_refuses_unported_arch_and_needs_a_card(capsys):
    """No arch is left unported: deepseek-v3 (MLA, its latent cache)
    serves through the CLI; without a card the default device raises."""
    serve_main(["--arch", "deepseek-v3-671b", "--device", "cpu",
                "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-671b-smoke" in out and "generated (4, 3)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve_main([])
