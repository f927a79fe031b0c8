"""DeepSeek-V3's multi-head latent attention (MLA) and its multi-token
prediction (MTP) head in the port against the reference, and
deepseek-v3-671b as a whole.

The reference's weights cross through the bridge (``params_from_numpy``);
inputs come from numpy with a seed; fp32 unless a test says otherwise.

* The MLA helpers alone (``_rms``, ``_mla_q``, ``_mla_latent_kv``,
  ``mla_apply``, ``mla_cache_init``) at the reduced ``MLASpec``, full and
  windowed: fp32 within rtol = atol = 2e-5, bf16 within 2 bf16 ulps (of
  each element for the norm, of the largest magnitude where a product
  rounds to bf16). torch's and XLA's CPU ``rsqrt`` may differ by an ulp.
* ``mla_decode`` token by token against the reference's within 2e-5, and
  against the port's own ``mla_apply`` within 2e-4 (ref
  ``tests/test_attention.py:116``): a full cache, a ring, and positions
  past a full cache's end (the reference's clamped write).
* Reduced fp32 deepseek at 4 layers (3 dense MLA layers, then MLA + MoE; the
  MTP head's block is MoE): ``lm_apply``'s logits, ``mtp_logits`` and aux,
  the loss, its metrics and every leaf's gradient within 2e-4; the MTP
  block's own MoE aux is left out of the loss.
* A dp = 4 packed trajectory against the reference's replica simulator
  (its bundle cannot run MoE on a multi-device mesh on this JAX):
  unfused against ``make_sim_train_step``, fused against the reference's
  mix-then-apply composition (its ``gossip_mix_sim``, then its sgd
  update), both within 2e-4, in one subprocess; the launcher's ``--smoke
  --arch deepseek-v3-671b`` history carries ``mtp_ce``.
* ``ServingEngine`` on reduced deepseek, plain and with a 4-slot window:
  prefill logits and the ``c_kv`` / ``k_rope`` caches within 1e-5, greedy
  tokens equal to the reference engine's.
* The registry and config fields, ``subquadratic``, ``cache_axes``, and
  the full-width param tree (61 layers and the MTP head, 682.6 G params)
  against ``jax.eval_shape`` of the reference's init.
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

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm_apply as ref_lm_apply  # noqa: E402
from repro.models import lm_cache_init as ref_lm_cache_init  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import lm_prefill as ref_lm_prefill  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.config import MLASpec as RefMLASpec  # noqa: E402
from repro.serve import ServingEngine as RefServingEngine  # noqa: E402
from repro.serve.step import cache_axes as ref_cache_axes  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.models import (MLASpec, lm_apply, lm_axes,  # noqa: E402
                                lm_cache_init, lm_init, lm_prefill, lm_specs,
                                reduced, segments_of)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.serve import ServingEngine, cache_axes  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map, tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEEPSEEK = "deepseek-v3-671b"
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


def _cfgs(n_layers=4, window=None, **kw):
    """Reduced fp32 deepseek of both packages (4 layers: the fourth and the
    MTP block are MoE), optionally windowed."""
    out = []
    for get, red, sw in ((ref_configs.get_config, ref_reduced,
                          ref_configs.with_sliding_window),
                         (configs.get_config, reduced,
                          configs.with_sliding_window)):
        cfg = dataclasses.replace(red(get(DEEPSEEK), n_layers=n_layers, **kw),
                                  param_dtype="float32",
                                  compute_dtype="float32")
        out.append(cfg if window is None else sw(cfg, window))
    return tuple(out)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _close(got: torch.Tensor, want, dtype, *, per_element=False):
    """The reference's output ``want`` in the port's dtype, and within
    rtol = atol = 2e-5 at ``dtype`` fp32; at bf16 within 2 bf16 ulps of
    each element (``per_element``) or of the largest magnitude."""
    assert got.dtype == getattr(torch, str(jnp.asarray(want).dtype)), \
        (got.dtype, want.dtype)
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    ulp = (_bf16_ulp(want) if per_element
           else _bf16_ulp(np.abs(want).max()))
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want).max()


# ------------------------------------------------------------- MLA alone

D = 48
SPEC = dict(n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
            qk_rope_dim=8, v_head_dim=16)


def _mla(spec_kw, dtype, seed=0):
    """Two replicas' reference MLA params (norm scales perturbed so their
    product is exercised), the port's stacked copy, and the specs."""
    rspec = RefMLASpec(**spec_kw)
    rng = np.random.default_rng(seed)
    trees = []
    for i in (0, 1):
        p = _np_tree(ref_attn.mla_init(jax.random.key(i), D, rspec,
                                       jnp.dtype(dtype))[0])
        for k in ("q_norm", "kv_norm"):
            p[k] = (1 + 0.2 * rng.normal(size=p[k].shape)).astype(p[k].dtype)
        trees.append(p)
    return (rspec, [jax.tree.map(jnp.asarray, t) for t in trees],
            MLASpec(**spec_kw),
            params_from_numpy(_stack(trees), device="cpu"))


def _x(dtype, S, seed=1):
    x = np.random.default_rng(seed).normal(size=(2, B, S, D)).astype(
        np.float32) * np.float32(0.7)
    return ([jnp.asarray(xr, jnp.dtype(dtype)) for xr in x],
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
def test_mla_helpers_match_reference(window, dtype):
    S = 12
    rspec, rps, spec, pp = _mla(dict(SPEC, window=window), dtype)
    xs, xt = _x(dtype, S)
    pos_r, pos_t = jnp.arange(S)[None], torch.arange(S)[None]
    # _rms on the raw latent (no product before it): per element
    lat_t = attn.replica_matmul(xt, pp["wq_a"])
    for r, (p, x) in enumerate(zip(rps, xs)):
        want = ref_attn._rms(jnp.asarray(lat_t[r].float().numpy(),
                                         jnp.dtype(dtype)), p["q_norm"])
        _close(attn._rms(lat_t[r:r + 1], pp["q_norm"][r:r + 1])[0], want,
               dtype, per_element=True)
    fns = {
        "q": (lambda p, x: ref_attn._mla_q(p, rspec, x, pos_r),
              lambda: attn._mla_q(pp, spec, xt, pos_t)),
        "kv": (lambda p, x: ref_attn._mla_latent_kv(p, rspec, x, pos_r),
               lambda: attn._mla_latent_kv(pp, spec, xt, pos_t)),
        "apply": (lambda p, x: (ref_attn.mla_apply(p, rspec, x),),
                  lambda: (attn.mla_apply(pp, spec, xt),))}
    for name, (ref_fn, port_fn) in fns.items():
        ref_fn = jax.jit(ref_fn)
        want = [ref_fn(p, x) for p, x in zip(rps, xs)]
        for i, got in enumerate(port_fn()):
            # the RoPE halves are fp32 in both (rotated against fp32 tables)
            _close(got, jnp.stack([w[i] for w in want]), dtype)
    cache = attn.mla_cache_init(spec, B, S, getattr(torch, dtype),
                                device="cpu")
    rcache = ref_attn.mla_cache_init(rspec, B, S, jnp.dtype(dtype))
    assert sorted(cache) == sorted(rcache) == ["c_kv", "k_rope"]
    for k in cache:
        assert tuple(cache[k].shape) == rcache[k].shape
        assert cache[k].dtype == getattr(torch, dtype)
        assert not cache[k].any()
    assert cache["c_kv"].shape[1] == (S if window is None else window)


@pytest.mark.parametrize("case", ["full", "ring", "clamp"])
def test_mla_decode_token_by_token(case):
    """Each step's output and both cache leaves against the reference's
    ``mla_decode`` (2e-5); the outputs against the port's own full
    ``mla_apply`` (2e-4). ``clamp``: a 4-slot full cache driven to
    position 7, where the reference's write clamps to the last slot."""
    S = 8
    window = 3 if case == "ring" else None
    rspec, rps, spec, pp = _mla(dict(SPEC, window=window), "float32", seed=2)
    xs, xt = _x("float32", S, seed=3)
    L = 4 if case == "clamp" else S
    rdec = jax.jit(lambda p, x1, c, pos: ref_attn.mla_decode(p, rspec, x1, c,
                                                             pos))
    rc = [ref_attn.mla_cache_init(rspec, B, L, jnp.float32) for _ in rps]
    pc = tree_map(lambda c: c[None].repeat(2, *([1] * c.dim())),
                  attn.mla_cache_init(spec, B, L, torch.float32,
                                      device="cpu"))
    outs = []
    for t in range(S):
        want = [rdec(p, x[:, t:t + 1], c, jnp.int32(t))
                for p, x, c in zip(rps, xs, rc)]
        rc = [w[1] for w in want]
        y, pc = attn.mla_decode(pp, spec, xt[:, :, t:t + 1], pc,
                                torch.tensor(t))
        np.testing.assert_allclose(
            y.numpy(), np.stack([np.asarray(w[0]) for w in want]),
            rtol=2e-5, atol=2e-5)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(
                pc[k].numpy(), np.stack([np.asarray(c[k]) for c in rc]),
                rtol=2e-5, atol=2e-5)
        outs.append(y)
    if case != "clamp":
        full = attn.mla_apply(pp, spec, xt)
        torch.testing.assert_close(torch.cat(outs, dim=2), full, **TOL)


# ----------------------------------------------------------- whole model

def _tokens(cfg, lead, S, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=tuple(lead) + (S + 1,)).astype(np.int32)


def test_lm_apply_with_mtp_matches_reference():
    """Two replicas with their own init: logits, ``mtp_logits`` (S-1
    positions), ``moe_aux`` and ``moe_dropped_frac``. The aux is the
    stack's alone: the same params without the MTP head give the same aux
    bit for bit, though the head's block (MoE) has an aux of its own."""
    rcfg, cfg = _cfgs()
    assert cfg.mtp and [b.moe is not None for b in cfg.blocks] == [
        False, False, False, True]
    S = 12
    tokens = _tokens(cfg, (2, B), S)
    trees = [ref_lm_init(jax.random.key(i), rcfg)[0] for i in (0, 1)]
    apply = jax.jit(lambda t, tok: ref_lm_apply(t, rcfg, tok[:, :-1]))
    want = [apply(t, jnp.asarray(tokens[r])) for r, t in enumerate(trees)]
    pp = params_from_numpy(_stack([_np_tree(t) for t in trees]),
                           device="cpu")
    tok = torch.from_numpy(tokens)[..., :-1].long()
    logits, aux = lm_apply(pp, cfg, tok)
    assert sorted(aux) == ["moe_aux", "moe_dropped_frac", "mtp_logits"]
    assert tuple(aux["mtp_logits"].shape) == (2, B, S - 1, cfg.vocab)
    for got, key in ((logits, None), (aux["mtp_logits"], "mtp_logits")):
        w = np.stack([np.asarray(x[0] if key is None else x[1][key])
                      for x in want])
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4,
                                   atol=2e-4 * np.abs(w).max())
    for key in ("moe_aux", "moe_dropped_frac"):
        np.testing.assert_allclose(aux[key].numpy(),
                                   [float(x[1][key]) for x in want], **TOL)
    stack_only = {k: v for k, v in pp.items() if k != "mtp"}
    _, aux0 = lm_apply(stack_only, dataclasses.replace(cfg, mtp=False), tok)
    assert sorted(aux0) == ["moe_aux", "moe_dropped_frac"]
    for key in aux0:
        assert torch.equal(aux[key], aux0[key]), key
    h = torch.randn(2, B, S - 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    _, own = blocks.block_apply(pp["mtp"]["block"], cfg, cfg.blocks[-1], h)
    assert (own["moe_aux"] > 0).all()


def test_loss_metrics_and_every_gradient_match_reference():
    """``make_loss_fn``: loss = ce + moe_aux + 0.3 mtp_ce and its metrics,
    and the gradient of every leaf (the ``mtp`` subtree's included) against
    ``jax.grad`` of the reference's loss, within 2e-4 of the leaf's
    largest."""
    rcfg, cfg = _cfgs()
    S = 12
    tokens = _tokens(cfg, (2, B), S, seed=5)
    trees = [ref_lm_init(jax.random.key(i), rcfg)[0] for i in (2, 3)]
    loss_fn = ref_make_loss_fn(rcfg)
    vg = jax.jit(jax.value_and_grad(lambda t, b: loss_fn(t, b), has_aux=True))
    want = [vg(t, {"tokens": jnp.asarray(tokens[r])})
            for r, t in enumerate(trees)]
    pp = params_from_numpy(_stack([_np_tree(t) for t in trees]),
                           device="cpu")
    leaves, treedef = tree_flatten(pp)
    for w in leaves:
        w.requires_grad_(True)
    loss, metrics = make_loss_fn(cfg)(treedef.unflatten(leaves),
                                      {"tokens": torch.from_numpy(tokens)})
    loss.sum().backward()
    assert sorted(metrics) == ["ce", "loss", "moe_aux", "moe_dropped_frac",
                               "mtp_ce"]
    for key in metrics:
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   [float(w[0][1][key]) for w in want],
                                   rtol=2e-4, atol=1e-6)
    m = {k: v.detach() for k, v in metrics.items()}
    torch.testing.assert_close(m["loss"], m["ce"] + m["moe_aux"]
                               + cfg.mtp_coef * m["mtp_ce"], rtol=0, atol=0)
    assert (m["loss"] > m["ce"]).all()
    paths = tree_paths(pp)
    assert sum(p[0] == "mtp" for p in paths) == len(tree_flatten(
        pp["mtp"])[0]) > 0
    ref_grads = jax.tree.leaves(_stack([_np_tree(w[1]) for w in want]))
    assert len(ref_grads) == len(leaves)
    for path, got, ref in zip(paths, leaves, ref_grads):
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max(),
                                   err_msg=str(path))


# ------------------------------------------------------------- training

D_MODEL, SEQ, GLOBAL_B, STEPS, LR = 32, 12, 8, 4, 0.3

_REFERENCE = r"""
import dataclasses, pickle, sys
import repro
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import build_schedule, make_sim_train_step
from repro.core.simulate import gossip_mix_sim
from repro.data import ShardedTokenDataset, make_replica_batches
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train.loss import make_loss_fn

cfg = dataclasses.replace(
    reduced(get_config("deepseek-v3-671b"), n_layers=4, d_model={d}),
    param_dtype="float32", compute_dtype="float32")
opt = sgd(step_decay({lr}, 0.1, 2), momentum=0.9)
init = lm_init(jax.random.key(0), cfg)[0]
out = {{"init": jax.tree.map(np.asarray, init)}}
loss_fn = make_loss_fn(cfg)
sched = build_schedule(4)
perm = jnp.asarray(np.stack([sched.recv_from(t)
                             for t in range(sched.period)]))
sim = make_sim_train_step(lambda p, b: loss_fn(p, b)[0], opt, sched)
grad_fn = jax.vmap(jax.value_and_grad(lambda p, b: loss_fn(p, b)[0]))


@jax.jit
def fused(st, params, batch, t):
    # the fused engine's composition: mix with the partner's pre-update
    # params, then the update
    losses, grads = grad_fn(params, batch)
    params, st = opt.update(gossip_mix_sim(params, perm[t % sched.period]),
                            grads, st)
    return st, params, {{"loss": losses.mean()}}


ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards=4,
                         batch_per_shard={gb} // 4, seed=0)
for name, step in (("unfused", sim), ("fused", fused)):
    params = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), init)
    st, losses = opt.init(params), []
    for t in range({steps}):
        batch = jax.tree.map(jnp.asarray, make_replica_batches(ds, t, 4))
        st, params, m = step(st, params, batch, jnp.int32(t))
        losses.append(float(m["loss"]))
    out[name] = {{"loss": losses, "params": jax.tree.map(np.asarray, params)}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(d=D_MODEL, lr=LR, seq=SEQ, gb=GLOBAL_B,
                               steps=STEPS)
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dp4_trajectory_matches_reference(reference_runs, fused):
    """Reduced deepseek (4 layers, d 32), dp 4, sync gossip, packed sgd
    through the port's Trainer from the reference's init: losses and final
    params within 2e-4 of the reference simulator's (unfused: update, then
    the mix) or of its mix-then-apply composition (fused: the sweep mixes
    with the partner's pre-update bucket, then applies the update)."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    _, cfg = _cfgs(d_model=D_MODEL)
    opt = sgd(step_decay(LR, 0.1, 2), momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=4, gossip_packed=True,
                                    fused_update=fused, remat=False,
                                    device="cpu")
    assert bundle.fused == fused
    params = params_from_numpy(reference_runs["init"], layout=bundle.layout,
                               lead=(4,), device="cpu")
    state = init_train_state(cfg, opt, dp=4, packed=True,
                             layout=bundle.layout, params=params,
                             device="cpu")
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=4,
                             batch_per_shard=GLOBAL_B // 4, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(STEPS)
    want = reference_runs["fused" if fused else "unfused"]
    np.testing.assert_allclose([h["loss"] for h in hist], want["loss"], **TOL)
    assert all(h["loss"] > h["ce"] and h["mtp_ce"] > 0 for h in hist)
    got = tr.state["params"].unpack()
    ref_leaves = jax.tree.leaves(want["params"])
    assert len(tree_flatten(got)[0]) == len(ref_leaves)
    for a, b in zip(tree_flatten(got)[0], ref_leaves):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)


def test_launcher_smoke_history_has_mtp_ce(monkeypatch):
    """``--smoke --arch deepseek-v3-671b --device cpu`` trains the reduced
    model; its history carries ``mtp_ce`` and the loss exceeds the CE (ref
    ``tests/test_train_integration.py:64``)."""
    import repro_torch.launch.train as launcher
    seen = []

    class Recording(launcher.Trainer):
        def run(self, *a, **kw):
            seen.append(super().run(*a, **kw))
            return seen[-1]
    monkeypatch.setattr(launcher, "Trainer", Recording)
    launcher.main(["--smoke", "--arch", DEEPSEEK, "--steps", "3",
                   "--seq-len", "12", "--global-batch", "2", "--d-model",
                   "32", "--log-every", "0", "--device", "cpu"])
    hist = seen[0]
    assert len(hist) == 3
    for h in hist:
        assert "mtp_ce" in h and np.isfinite(h["mtp_ce"])
        assert h["loss"] > h["ce"]


# -------------------------------------------------------------- serving

@pytest.mark.parametrize("window", [None, 4], ids=["full", "window4"])
def test_serving_matches_reference(window):
    """Prefill's last logits and every cache leaf (``c_kv``, ``k_rope``;
    the window's ring when the 10-token prompt outruns 4 slots) within
    1e-5 of the reference's; the greedy tokens of ``ServingEngine`` equal
    the reference engine's."""
    rcfg, cfg = _cfgs(window=window)
    params = ref_lm_init(jax.random.key(0), rcfg)[0]
    pp = params_from_numpy(_np_tree(params), device="cpu")
    S, max_seq = 10, 32
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want, rc = jax.jit(lambda p, t, c: ref_lm_prefill(p, rcfg, t, c))(
        params, jnp.asarray(prompts), ref_lm_cache_init(rcfg, B, max_seq))
    with torch.inference_mode():
        got, pc = lm_prefill(pp, cfg, torch.from_numpy(prompts).long(),
                             lm_cache_init(cfg, B, max_seq, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert [sorted(c["kv"]) for seg in pc for c in seg] == \
        [["c_kv", "k_rope"]] * len(pc)
    g, w = tree_flatten(pc)[0], jax.tree.leaves(rc)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert g[0].shape[2] == (max_seq if window is None else window)
    ref_tokens = RefServingEngine(rcfg, params, max_seq).generate(prompts, 6)
    tokens = ServingEngine(cfg, pp, max_seq, device="cpu").generate(prompts,
                                                                     6)
    np.testing.assert_array_equal(tokens, ref_tokens)


# ---------------------------------------------------- configs and trees

def test_config_fields_equal_the_references():
    """The full config, the reduced ones (2 layers: dense only; 4: the
    fourth MoE) and the windowed variant, field for field (the MLA
    fields and the MTP head's included)."""
    full, ref_full = configs.get_config(DEEPSEEK), ref_configs.get_config(
        DEEPSEEK)
    pairs = [(full, ref_full),
             (configs.with_sliding_window(full, 8192),
              ref_configs.with_sliding_window(ref_full, 8192))]
    for n in (2, 4):
        pairs.append((reduced(full, n_layers=n),
                      ref_reduced(ref_full, n_layers=n)))
    for got, want in pairs:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert full.mtp and full.mtp_coef == 0.3
    assert reduced(full).blocks[0].mla == MLASpec(
        n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
        qk_rope_dim=8, v_head_dim=16)
    assert all(b.moe is None for b in reduced(full).blocks)


def test_block_kinds_has_ssm_and_subquadratic():
    """``tests/test_system.py:73`` on the port, plus deepseek: full MLA
    is not subquadratic, its windowed variant is."""
    get, sw = configs.get_config, configs.with_sliding_window
    assert get("falcon-mamba-7b").subquadratic()
    assert get("llava-next-mistral-7b").subquadratic()
    assert not get("qwen3-0.6b").subquadratic()
    assert not get("jamba-v0.1-52b").subquadratic()
    assert sw(get("qwen3-0.6b"), 8192).subquadratic()
    ds = get(DEEPSEEK)
    assert not ds.subquadratic() and sw(ds, 8192).subquadratic()
    assert ds.block_kinds() == ("mla",) * 61 and not ds.has_ssm()
    jamba = get("jamba-v0.1-52b")
    assert jamba.has_ssm() and jamba.block_kinds().count("attn") == 4
    for arch in configs.list_archs():
        ref = ref_configs.get_config(arch)
        for c, r in ((get(arch), ref),
                     (sw(get(arch), 64), ref_configs.with_sliding_window(
                         ref, 64))):
            assert (c.block_kinds(), c.has_ssm(), c.subquadratic()) == \
                (r.block_kinds(), r.has_ssm(), r.subquadratic()), arch


def test_cache_axes_and_reduced_tree_axes_match_reference():
    rcfg, cfg = _cfgs()
    assert cache_axes(cfg) == ref_cache_axes(rcfg)
    assert cache_axes(cfg)[0][0]["kv"] == {"c_kv": ",batch,kv_seq,",
                                           "k_rope": ",batch,kv_seq,"}
    assert [(len(p), R) for p, R in segments_of(cfg.blocks)] == [(1, 3),
                                                                  (1, 1)]
    axes = ref_lm_init(jax.random.key(0), rcfg)[1]
    assert tree_flatten(lm_axes(cfg))[0] == jax.tree.leaves(axes)
    assert tree_paths(lm_axes(cfg)) == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(axes)]
    assert lm_axes(cfg)["mtp"]["proj"] == "embed,embed_out"


def test_full_width_param_tree_equals_the_references():
    """Every leaf path, shape and dtype of the full-width tree (61 layers
    in two segments, 3 dense and 58 MoE, and the MTP head) against
    ``jax.eval_shape`` of the reference's init, nothing allocated."""
    def skel(tree, leaf):
        if isinstance(tree, dict):
            return {k: skel(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [skel(v, leaf) for v in tree]
        return leaf(tree)
    full = configs.get_config(DEEPSEEK)
    shapes = jax.eval_shape(lambda k: ref_lm_init(
        k, ref_configs.get_config(DEEPSEEK))[0], jax.random.key(0))
    specs = lm_specs(full)
    assert skel(specs, lambda s: (tuple(s.shape),
                                  str(s.dtype).split(".")[-1])) == \
        skel(shapes, lambda x: (tuple(x.shape), str(x.dtype)))
    n = sum(int(np.prod(s.shape)) for s in tree_flatten(specs)[0])
    assert n == 682_636_465_152
    assert sum(int(np.prod(s.shape)) for s in tree_flatten(
        specs["mtp"])[0]) == 11_610_060_800
    assert [R for _, R in segments_of(full.blocks)] == [3, 58]


def test_registry_is_the_references():
    assert configs.list_archs() == ref_configs.list_archs()
    assert len(configs.list_archs()) == 10 and configs.NOT_PORTED == {}
    assert configs.get_config(DEEPSEEK) is configs.get_config(DEEPSEEK)
    full = lm_init(dataclasses.replace(reduced(configs.get_config(DEEPSEEK)),
                                       param_dtype="float32"),
                   seed=0, device="cpu")
    assert sorted(full["mtp"]) == ["block", "norm_e", "norm_h", "proj"]
