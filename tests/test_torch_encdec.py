"""The encoder-decoder family in the port against the reference:
whisper-base (a stub audio frontend: precomputed frame embeddings, a
non-causal unrotated encoder, cross-attention in every decoder layer).

* Cross-attention: ``attn_apply(memory=)`` and ``attn_decode(memory_kv=)``
  against the reference's; ``rope_frac`` 0 rotates nothing (``_rot_dim``
  is 0, and the encoder's attention does not see positions).
* Reduced fp32 whisper: ``encode_audio``, ``lm_apply``'s logits and aux,
  ``make_loss_fn``'s loss and metrics, the packed gradients, prefill and
  decode (logits and every cache leaf, ``mem_k``/``mem_v`` included)
  against the reference within 2e-4; the port's decode against its own
  full forward; the encoder's gradients through the checkpointed decoder's
  ``memory`` (remat off and on bit-equal).
* Serving: ``cache_axes`` and the serve steps' specs (``with_audio``),
  ``ServingEngine.generate(audio_frames=)`` against the reference's
  engine, and the CLI.
* The weights bridge carries a reduced whisper and a reduced jamba tree
  bit for bit (their checkpoints cross the packages in
  ``tests/test_torch_ckpt.py``).
* A dp = 4 trajectory through both packages' packed fused bundles, the
  reference's in a subprocess with 4 forced host devices, stepping both
  with explicit batches that carry seeded frames (the Trainers feed
  tokens only).
"""
import dataclasses
import os
import pickle
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
from repro.models import encode_audio as ref_encode_audio  # noqa: E402
from repro.models import lm_apply as ref_lm_apply  # noqa: E402
from repro.models import lm_cache_init as ref_lm_cache_init  # noqa: E402
from repro.models import lm_decode as ref_lm_decode  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import lm_prefill as ref_lm_prefill  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.config import AttnSpec as RefAttnSpec  # noqa: E402
from repro.serve import ServingEngine as RefServingEngine  # noqa: E402
from repro.serve import cache_axes as ref_cache_axes  # noqa: E402
from repro.serve import make_decode_step as ref_make_decode_step  # noqa: E402
from repro.serve import make_prefill_step as ref_make_prefill_step  # noqa: E402
from repro.train import make_distribution as ref_make_distribution  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core import PackedParams, build_layout  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import (AttnSpec, encode_audio, lm_apply,  # noqa: E402
                                lm_axes, lm_cache_init, lm_decode, lm_init,
                                lm_prefill, lm_specs, reduced)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serve import (ServingEngine, cache_axes,  # noqa: E402
                               make_decode_step, make_prefill_step)
from repro_torch.train import (init_train_state, make_distribution,  # noqa: E402
                               make_loss_fn, make_train_step_bundle)
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WHISPER = "whisper-base"
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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(trees):
    return jax.tree.map(lambda *x: np.stack(x), *trees)


def _cfgs(arch=WHISPER, dtype="float32", **kw):
    ref = dataclasses.replace(ref_reduced(ref_configs.get_config(arch), **kw),
                              param_dtype=dtype, compute_dtype="float32")
    port = dataclasses.replace(reduced(configs.get_config(arch), **kw),
                               param_dtype=dtype, compute_dtype="float32")
    return ref, port


def _frames(cfg, lead, seed=0):
    """Seeded stub frame embeddings (*lead, n_frames, d), normal x 0.02."""
    return (np.random.default_rng(seed).standard_normal(
        tuple(lead) + (cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
        * np.float32(0.02))


def _tokens(cfg, lead, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, tuple(lead) + (S,)).astype(np.int32)


def _close_tree(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------- cross-attention

CROSS = dict(n_heads=4, n_kv_heads=2, head_dim=16, cross=True, causal=False,
             rope_frac=0.0)


def _attn_pair(kw, d=32):
    ps = [ref_attn.attn_init(jax.random.key(i), d, RefAttnSpec(**kw),
                             jnp.float32)[0] for i in (0, 1)]
    return ps, params_from_numpy(_stack([_np_tree(p) for p in ps]),
                                 device="cpu")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_reference(qk_norm):
    """Two replicas: 7 queries over 11 memory positions (GQA 4/2), no
    mask; ``attn_apply(memory=)`` and ``attn_decode(memory_kv=)`` (one
    query, the cached keys and values) against the reference's."""
    kw = dict(CROSS, qk_norm=qk_norm)
    ps, pp = _attn_pair(kw)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, B, 7, 32)).astype(np.float32)
    mem = rng.normal(size=(2, B, 11, 32)).astype(np.float32)
    run = jax.jit(lambda p, xr, m: ref_attn.attn_apply(
        p, RefAttnSpec(**kw), xr, memory=m))
    want = np.stack([np.asarray(run(p, xr, m))
                     for p, xr, m in zip(ps, x, mem)])
    got = attn.attn_apply(pp, AttnSpec(**kw), torch.from_numpy(x),
                          memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # decode over the memory's cached keys and values
    kv = [(jnp.einsum("btd,dhk->bthk", m, p["wk"]),
           jnp.einsum("btd,dhk->bthk", m, p["wv"])) for p, m in zip(ps, mem)]
    dec = jax.jit(lambda p, x1, k, v: ref_attn.attn_decode(
        p, RefAttnSpec(**kw), x1, {}, 3, memory_kv=(k, v))[0])
    want = np.stack([np.asarray(dec(p, xr[:, :1], k, v))
                     for p, xr, (k, v) in zip(ps, x, kv)])
    mk = torch.from_numpy(np.stack([np.asarray(k) for k, _ in kv]))
    mv = torch.from_numpy(np.stack([np.asarray(v) for _, v in kv]))
    cache = {"untouched": torch.zeros(1)}
    got, c = attn.attn_decode(pp, AttnSpec(**kw),
                              torch.from_numpy(x[:, :, :1]), cache, 3,
                              memory_kv=(mk, mv))
    assert c is cache
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_rope_frac_zero_rotates_nothing():
    """whisper's encoder and cross-attention set rope_frac 0: ``_rot_dim``
    is 0 and the encoder's (non-causal) attention gives the same output at
    any positions; the reference's agrees."""
    enc = dict(n_heads=4, n_kv_heads=4, head_dim=16, causal=False,
               rope_frac=0.0)
    for kw in (enc, CROSS):
        assert attn._rot_dim(AttnSpec(**kw)) == 0
        assert ref_attn._rot_dim(RefAttnSpec(**kw)) == 0
    assert attn._rot_dim(AttnSpec(**dict(enc, rope_frac=0.25))) == 4
    ps, pp = _attn_pair(enc)
    x = np.random.default_rng(3).normal(size=(2, B, 9, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    a = attn.attn_apply(pp, AttnSpec(**enc), xt)
    b = attn.attn_apply(pp, AttnSpec(**enc), xt,
                        positions=torch.arange(100, 109)[None])
    assert torch.equal(a, b)
    rotated = attn.attn_apply(pp, AttnSpec(**dict(enc, rope_frac=1.0)), xt)
    assert not torch.allclose(a, rotated, rtol=1e-3, atol=1e-3)
    want = np.stack([np.asarray(jax.jit(lambda p, xr: ref_attn.attn_apply(
        p, RefAttnSpec(**enc), xr))(p, xr)) for p, xr in zip(ps, x)])
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------- whole model

def test_configs_and_param_trees_equal_the_references():
    """The full and reduced configs field for field (``cross_attn`` is not
    shrunk by ``reduced``, in either package); the param trees' paths,
    shapes, dtypes and logical axes, reduced and full size (71.4 M
    params)."""
    full, ref_full = configs.get_config(WHISPER), ref_configs.get_config(
        WHISPER)
    for got, want in ((full, ref_full), (reduced(full), ref_reduced(ref_full))):
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert all(b["mla"] is None for b in g["blocks"])
        assert g["mtp"] is False and g["mtp_coef"] == 0.3
        assert g == w
    assert reduced(full).blocks[0].cross_attn == full.blocks[0].cross_attn

    def skel(tree, leaf):
        if isinstance(tree, dict):
            return {k: skel(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [skel(v, leaf) for v in tree]
        return leaf(tree)
    ref_cfg, cfg = _cfgs(dtype="bfloat16")
    params, axes = ref_lm_init(jax.random.key(0), ref_cfg)
    assert skel(lm_specs(cfg), lambda s: (
        tuple(s.shape), str(s.dtype).split(".")[-1])) == skel(
        params, lambda x: (tuple(x.shape), str(x.dtype)))
    assert skel(lm_axes(cfg), str) == skel(axes, str)
    shapes = jax.eval_shape(lambda k: ref_lm_init(k, ref_full)[0],
                            jax.random.key(0))
    assert skel(lm_specs(full), lambda s: (
        tuple(s.shape), str(s.dtype).split(".")[-1])) == skel(
        shapes, lambda x: (tuple(x.shape), str(x.dtype)))
    n = sum(int(np.prod(s.shape)) for s in tree_flatten(lm_specs(full))[0])
    assert n == 71_395_840


def test_forward_loss_and_grads_match_reference():
    """Two replicas with their own init and frames: ``encode_audio``,
    ``lm_apply``'s logits and aux, the loss and metrics, the packed
    gradients (the encoder's included)."""
    ref_cfg, cfg = _cfgs()
    S = 12
    tokens = _tokens(cfg, (2, B), S + 1, seed=4)
    frames = _frames(cfg, (2, B))
    trees = [ref_lm_init(jax.random.key(i), ref_cfg)[0] for i in (0, 1)]
    enc = jax.jit(lambda t, f: ref_encode_audio(t, ref_cfg, f))
    apply = jax.jit(lambda t, tok, f: ref_lm_apply(
        t, ref_cfg, tok[:, :-1], audio_frames=f)[0])
    loss_fn = ref_make_loss_fn(ref_cfg)
    vg = jax.jit(jax.value_and_grad(lambda t, b: loss_fn(t, b), has_aux=True))
    want_mem = np.stack([np.asarray(enc(t, frames[r]))
                         for r, t in enumerate(trees)])
    want_logits = np.stack([np.asarray(apply(t, tokens[r], frames[r]))
                            for r, t in enumerate(trees)])
    want = [vg(t, {"tokens": jnp.asarray(tokens[r]),
                   "audio_frames": jnp.asarray(frames[r])})
            for r, t in enumerate(trees)]

    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(_stack([_np_tree(t) for t in trees]),
                               layout=layout, device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tokens),
             "audio_frames": torch.from_numpy(frames)}
    with torch.no_grad():
        mem = encode_audio(packed.unpack(), cfg, batch["audio_frames"])
    np.testing.assert_allclose(mem.numpy(), want_mem, **TOL)
    logits, aux = lm_apply(packed.unpack(), cfg, batch["tokens"][..., :-1],
                           audio_frames=batch["audio_frames"])
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=2e-4, atol=2e-4 * np.abs(want_logits).max())
    assert all(torch.equal(a, torch.zeros(2)) for a in aux.values())
    loss, metrics = make_loss_fn(cfg)(packed.unpack(), batch)
    loss.sum().backward()
    for key in metrics:
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   [float(w[0][1][key]) for w in want],
                                   rtol=2e-4, atol=1e-7)
    want_packed = params_from_numpy(_stack([_np_tree(w[1]) for w in want]),
                                    layout=layout, device="cpu")
    for got, ref in zip(packed.buckets, want_packed.buckets):
        ref = ref.numpy()
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="audio_frames"):
        lm_apply(packed.unpack(), cfg, batch["tokens"][..., :-1])


def test_encoder_gradients_flow_through_the_checkpointed_decoder():
    """remat checkpoints the decoder's layers with the encoder's output
    ``memory`` as an input: the encoder's gradients are nonzero and equal
    remat off's bit for bit."""
    _, cfg = _cfgs(d_model=32)
    layout = build_layout(lm_specs(cfg))
    packed = PackedParams.pack(lm_init(cfg, seed=0, device="cpu"), layout,
                               lead=(2,), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, (2, B), 9)),
             "audio_frames": torch.from_numpy(_frames(cfg, (2, B)))}
    grads = []
    for remat in (False, True):
        bs = [b.detach().clone().requires_grad_(True) for b in packed.buckets]
        p = PackedParams(bs, layout)
        loss, _ = make_loss_fn(cfg, remat=remat)(p.unpack(), batch)
        loss.sum().backward()
        grads.append(PackedParams([b.grad for b in bs], layout).unpack())
    for a, b in zip(tree_flatten(grads[0])[0], tree_flatten(grads[1])[0]):
        assert torch.equal(a, b)
    enc = tree_flatten(grads[1]["encoder"])[0]
    assert enc and all(bool(g.abs().max() > 0) for g in enc)


def _serve_pair(**kw):
    ref_cfg, cfg = _cfgs(**kw)
    params = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    return ref_cfg, params, cfg, params_from_numpy(_np_tree(params),
                                                   device="cpu")


def test_prefill_and_decode_match_reference():
    """Prefill (the encoder once, every layer's cross keys and values
    cached) and 3 decode steps: logits and every cache leaf against the
    reference's."""
    ref_cfg, rp, cfg, pp = _serve_pair()
    S, max_seq = 8, 32
    toks = _tokens(cfg, (B,), S + 3, seed=5)
    frames = _frames(cfg, (B,), seed=6)
    rc = ref_lm_cache_init(ref_cfg, B, max_seq)
    pc = lm_cache_init(cfg, B, max_seq, device="cpu")
    assert tree_map(lambda c: (tuple(c.shape), str(c.dtype)[6:]), pc) == \
        jax.tree.map(lambda c: (c.shape, str(c.dtype)), rc)
    want, rc = jax.jit(lambda p, t, c, f: ref_lm_prefill(
        p, ref_cfg, t, c, audio_frames=f))(rp, jnp.asarray(toks[:, :S]), rc,
                                           jnp.asarray(frames))
    got, pc = lm_prefill(pp, cfg, torch.from_numpy(toks[:, :S]).long(), pc,
                         audio_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree(pc, rc)
    assert float(pc[0][0]["mem_k"].abs().max()) > 0
    decode = jax.jit(lambda p, t, c, pos: ref_lm_decode(p, ref_cfg, t, c, pos))
    for t in range(S, S + 3):
        want, rc = decode(rp, jnp.asarray(toks[:, t]), rc, jnp.int32(t))
        got, pc = lm_decode(pp, cfg, torch.from_numpy(toks[:, t]).long(), pc,
                            torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close_tree(pc, rc)


def test_decode_matches_own_full_forward():
    _, cfg = _cfgs()
    params = lm_init(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (B,), 12, seed=7)).long()
    frames = torch.from_numpy(_frames(cfg, (B,), seed=8))
    full, _ = lm_apply(tree_map(lambda w: w[None], params), cfg, toks[None],
                       audio_frames=frames[None])
    _, cache = lm_prefill(params, cfg, toks[:, :-1],
                          lm_cache_init(cfg, B, 32, device="cpu"),
                          audio_frames=frames)
    last, _ = lm_decode(params, cfg, toks[:, -1], cache, 11)
    torch.testing.assert_close(last, full[0, :, -1], **TOL)


# --------------------------------------------------------------- serving

def test_engine_generates_the_references_tokens():
    ref_cfg, rp, cfg, pp = _serve_pair()
    prompts = _tokens(cfg, (B,), 6, seed=9)
    frames = _frames(cfg, (B,), seed=10)
    want = RefServingEngine(ref_cfg, rp, max_seq=32).generate(
        prompts, 5, audio_frames=frames)
    got = ServingEngine(cfg, pp, max_seq=32, device="cpu").generate(
        prompts, 5, audio_frames=frames)
    np.testing.assert_array_equal(got, np.asarray(want))


def _ref_specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda s: isinstance(s, JP))


@pytest.mark.parametrize("shape,mode", [((1, 4, 1), "replica"),
                                        ((1, 2, 2), "replica")],
                         ids=["1x4x1", "1x2x2"])
def test_serve_steps_with_audio_equal_the_references(shape, mode):
    """``cache_axes`` (``mem_k``/``mem_v``), the decode and prefill steps'
    specs with ``with_audio`` on the ported plan against the reference's
    on an AbstractMesh; the prefill step takes the frames after the
    tokens and is ``lm_prefill``."""
    ref_cfg, rp, cfg, pp = _serve_pair()
    assert cache_axes(cfg) == ref_cache_axes(ref_cfg)
    pod, data, model = shape
    mesh = make_smoke_mesh(data, model, pod=pod)
    dist = make_distribution(mesh, mode)
    rdist = ref_make_distribution(
        AbstractMesh(tuple(mesh.axis_sizes), tuple(mesh.axis_names)), mode)
    raxes = ref_lm_init(jax.random.key(0), ref_cfg)[1]
    rcache = jax.eval_shape(lambda: ref_lm_cache_init(ref_cfg, 4, 32))
    pcache = lm_cache_init(cfg, 4, 32, device="cpu")
    for rmake, make, kw in ((ref_make_decode_step, make_decode_step, {}),
                            (ref_make_prefill_step, make_prefill_step,
                             dict(with_audio=True))):
        want = rmake(ref_cfg, rdist, param_shapes=rp, param_axes=raxes,
                     cache_shapes=rcache, **kw)
        got = make(cfg, dist, param_shapes=lm_specs(cfg),
                   param_axes=lm_axes(cfg), cache_shapes=pcache, **kw)
        assert got.param_specs == _ref_specs(want.param_specs)
        assert got.cache_specs == _ref_specs(want.cache_specs)
        assert [tuple(s) for s in got.in_specs] == \
            [tuple(s) for s in want.in_specs]
    toks = torch.from_numpy(_tokens(cfg, (4,), 6)).long()
    frames = torch.from_numpy(_frames(cfg, (4,)))
    logits, cache = got.step_fn(pp, pcache, toks, frames)
    want, wc = lm_prefill(pp, cfg, toks, lm_cache_init(cfg, 4, 32,
                                                       device="cpu"),
                          audio_frames=frames)
    assert torch.equal(logits, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(cache)[0],
                                                 tree_flatten(wc)[0]))


def test_serve_cli_runs_whisper_with_frames(capsys):
    from repro_torch.serve.__main__ import main
    main(["--arch", WHISPER, "--device", "cpu", "--new-tokens", "3",
          "--prompt-len", "5"])
    assert "generated (4, 3)" in capsys.readouterr().out


# ------------------------------------------------- weights and checkpoints

@pytest.mark.parametrize("arch", [WHISPER, "jamba-v0.1-52b"])
def test_bridge_round_trip(arch):
    """``params_from_numpy`` carries a reduced bf16 state's every leaf
    (``encoder.{layers,norm,pos}``, ``norm_x``, ``cross``, ``ff.{router,
    w_gate,w_in,w_out}``, the stacked layer axes) bit for bit, as a tree
    and packed under a replica axis."""
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    tree = _np_tree(ref_lm_init(jax.random.key(0), ref_cfg)[0])
    got = params_from_numpy(tree, device="cpu")
    paths = [k for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    names = {str(getattr(p, "key", "")) for path in paths for p in path}
    assert names >= ({"encoder", "pos", "norm_x", "cross"} if arch == WHISPER
                     else {"router", "w_gate", "w_in", "w_out"})
    for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(tree)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        assert np.array_equal(a.view(torch.int16).numpy(),
                              b.view(np.int16))
    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(tree, layout=layout, lead=(3,), device="cpu")
    for a, b in zip(tree_flatten(packed.unpack())[0], jax.tree.leaves(tree)):
        for r in range(3):
            assert np.array_equal(a[r].view(torch.int16).numpy(),
                                  b.view(np.int16))


# --------------------------------------------- dp 4 through both bundles

D_MODEL, SEQ, GLOBAL_B, STEPS, LR = 32, 10, 8, 4, 0.3

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train import (init_train_state, make_distribution,
                         make_train_step_bundle)

cfg = dataclasses.replace(reduced(get_config("whisper-base"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh(4, 1), "replica")
opt = sgd(step_decay({lr}, 0.1, 2), momentum=0.9)
ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
assert bs["audio_frames"].shape == (4, {gb} // 4, cfg.encoder.n_frames,
                                    cfg.d_model)
bundle = make_train_step_bundle(
    cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
    protocol="gossip", remat=False, gossip_packed=True)
assert bundle.fused
state, _ = init_train_state(jax.random.key(0), cfg, dist, opt, packed=True,
                            layout=bundle.layout)
with open(sys.argv[2], "rb") as f:
    batches = pickle.load(f)
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0]),
        "loss": [], "ce": []}}
period = max(bundle.protocol.period, 1)
for s, b in enumerate(batches):
    state, _, m = bundle.jitted(s % period)(state,
                                            jax.tree.map(jnp.asarray, b))
    out["loss"].append(float(m["loss"]))
    out["ce"].append(float(m["ce"]))
out["buckets"] = [np.asarray(b) for b in state["params"].buckets]
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _dp4_batches(cfg):
    from repro_torch.data import ShardedTokenDataset, make_replica_batches
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=4,
                             batch_per_shard=GLOBAL_B // 4, seed=0)
    return [dict(make_replica_batches(ds, s, 4),
                 audio_frames=_frames(cfg, (4, GLOBAL_B // 4), seed=s))
            for s in range(STEPS)]


def test_dp4_whisper_trajectory_matches_reference_bundle(tmp_path):
    """Reduced whisper, dp 4, sync gossip, packed fused sgd: both bundles
    stepped with the same explicit batches (tokens and seeded frames) from
    one init; losses and final buckets within 2e-4."""
    _, cfg = _cfgs(d_model=D_MODEL)
    batches = _dp4_batches(cfg)
    with open(tmp_path / "batches.pkl", "wb") as f:
        pickle.dump(batches, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(d=D_MODEL, lr=LR, seq=SEQ, gb=GLOBAL_B)
    r = subprocess.run([sys.executable, "-c", script,
                        str(tmp_path / "ref.pkl"),
                        str(tmp_path / "batches.pkl")], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(tmp_path / "ref.pkl", "rb") as f:  # written by the subprocess
        want = pickle.load(f)
    from repro_torch.optim import step_decay
    opt = sgd(step_decay(LR, 0.1, 2), momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=4, gossip_packed=True,
                                    remat=False, device="cpu")
    assert bundle.fused
    state = init_train_state(cfg, opt, dp=4, packed=True,
                             layout=bundle.layout,
                             params=params_from_numpy(
                                 want["init"], layout=bundle.layout,
                                 lead=(4,), device="cpu"), device="cpu")
    losses = []
    for s, b in enumerate(batches):
        state, _, m = bundle.step(state, {k: torch.from_numpy(v)
                                          for k, v in b.items()}, s,
                                  rotate=False)
        losses.append(float(m["loss"]))
        assert float(m["loss"]) == float(m["ce"])
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    for a, b in zip(state["params"].buckets, want["buckets"]):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)
