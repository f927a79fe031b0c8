"""Routed mixture of experts in the port against the reference: jamba
(Mamba + attention + MoE) and kimi-k2 (384 experts top-8 with a shared
expert, reduced), the ``(logits, aux)`` model signature and the loss
``ce + moe_aux``.

* Units against ``repro.models.moe``: ``moe_capacity`` over a grid, the
  dispatch tables bit for bit (drops at a small capacity factor, tied
  router probabilities), ``moe_apply``'s output and both aux values, its
  gradients; mirrors of ``tests/test_moe.py``'s six tests on the port; the
  combine's add order at k = 8 in bf16.
* Reduced fp32 jamba and kimi-k2: ``lm_apply``'s logits and aux,
  ``make_loss_fn``'s loss and metrics, the gradients, prefill and decode
  (logits and every cache leaf) against the reference within 2e-4; the
  port's decode against its own full forward at ``capacity_factor`` 8.
* Remat off, on and ``save_moe_combine`` bit-equal on reduced jamba (two
  segments), and the policy's saves counted.
* The registry: each of the nine ported configs equals the reference's
  field for field.
* One subprocess drives the reference: a dp = 4 trajectory of reduced
  jamba through its replica simulator (its bundle cannot run MoE on a
  multi-device mesh on this JAX), and its launcher under ``--smoke --arch
  jamba-v0.1-52b`` and ``kimi-k2-1t-a32b``.
"""
import dataclasses
import json
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
from repro.models import lm_apply as ref_lm_apply  # noqa: E402
from repro.models import lm_cache_init as ref_lm_cache_init  # noqa: E402
from repro.models import lm_decode as ref_lm_decode  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import lm_prefill as ref_lm_prefill  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.models.config import MoESpec as RefMoESpec  # noqa: E402
from repro.train.loss import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import params_from_numpy  # noqa: E402
from repro_torch.core import PackedParams, build_layout  # noqa: E402
from repro_torch.models import (MoESpec, lm_apply, lm_cache_init,  # noqa: E402
                                lm_decode, lm_init, lm_prefill, lm_specs,
                                reduced, segments_of)
from repro_torch.models import blocks, moe  # noqa: E402
from repro_torch.models.layers import silu  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAMBA, KIMI = "jamba-v0.1-52b", "kimi-k2-1t-a32b"
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


def _cfgs(arch, capacity_factor=None, **kw):
    """Reduced fp32 configs of both packages (optionally another capacity
    factor on every MoE layer)."""
    out = []
    for get, red in ((ref_configs.get_config, ref_reduced),
                     (configs.get_config, reduced)):
        cfg = dataclasses.replace(red(get(arch), **kw), param_dtype="float32",
                                  compute_dtype="float32")
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, blocks=tuple(
                dataclasses.replace(b, moe=dataclasses.replace(
                    b.moe, capacity_factor=capacity_factor))
                if b.moe is not None else b for b in cfg.blocks))
        out.append(cfg)
    return tuple(out)


# ----------------------------------------------------------------- units

@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
def test_capacity_matches_reference(cf):
    for E in (1, 4, 16, 384):
        for k in (1, 2, 8):
            if k > E:
                continue
            spec = dict(n_experts=E, top_k=k, d_ff_expert=8,
                        capacity_factor=cf)
            for S in (1, 3, 16, 64, 1024, 4096):
                assert moe.moe_capacity(S, MoESpec(**spec)) == \
                    ref_moe.moe_capacity(S, RefMoESpec(**spec))


def _ref_topk(probs, k):
    w, i = jax.lax.top_k(jnp.asarray(probs), k)
    return np.asarray(w), np.asarray(i)


def _probs(rng, shape, tied):
    if tied:   # a zero router: every expert equally likely
        return np.full(shape, 1.0 / shape[-1], np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(x), -1))


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_top_k_breaks_ties_toward_the_lower_index(tied):
    rng = np.random.default_rng(0)
    probs = _probs(rng, (3, 7, 16), tied)
    if not tied:   # a few exact ties among random values too
        probs[0, :, 5] = probs[0, :, 2]
        probs[1, :, 9] = probs[1, :, 3]
    for k in (1, 2, 8):
        want_w, want_i = _ref_topk(probs, k)
        got_w, got_i = moe._top_k(torch.from_numpy(probs), k)
        assert np.array_equal(got_i.numpy(), want_i)
        assert np.array_equal(got_w.numpy(), want_w)
    if tied:
        assert (want_i == np.arange(k)).all()


DISPATCH = {"random": (8, 2, 24, 1.25, False),
            "drops": (4, 2, 32, 0.25, False),
            "tied": (4, 2, 16, 1.25, True),
            "kimi_k8": (384, 8, 40, 1.25, False),
            "decode": (16, 2, 1, 1.25, False)}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch_tables_are_the_references_bit_for_bit(case):
    E, k, S, cf, tied = DISPATCH[case]
    G = 3
    rng = np.random.default_rng(1)
    _, topi = _ref_topk(_probs(rng, (G, S, E), tied), k)
    C = ref_moe.moe_capacity(S, RefMoESpec(n_experts=E, top_k=k,
                                           d_ff_expert=8, capacity_factor=cf))
    table, inv, dropped = jax.jit(jax.vmap(
        lambda ti: ref_moe._dispatch_one_group(None, ti, E, C)))(topi)
    got = moe._dispatch_one_group(torch.from_numpy(np.array(topi)).long(),
                                  E, C)
    assert np.array_equal(got[0].numpy(), np.asarray(table))
    assert np.array_equal(got[1].numpy(), np.asarray(inv))
    assert np.array_equal(got[2].numpy(), np.asarray(dropped))
    if case == "drops":
        assert (np.asarray(dropped) > 0).all()
    # the slot -> choice table points each filled slot at its token
    choice = got[3].numpy()
    filled = choice < S * k
    assert np.array_equal(np.where(filled, choice // k, S), np.asarray(table))


def _moe_pair(E, k, n_shared, cf, d=16, f=32, seed=0, dtype=jnp.float32):
    spec = dict(n_experts=E, top_k=k, d_ff_expert=f, n_shared=n_shared,
                capacity_factor=cf)
    ps = [ref_moe.moe_init(jax.random.key(seed + r), d, RefMoESpec(**spec),
                           dtype)[0] for r in range(2)]
    return RefMoESpec(**spec), MoESpec(**spec), ps


MOE_CASES = {"plain": (0, 1.25, False), "shared": (1, 1.25, False),
             "drops": (0, 0.5, False), "shared_drops": (1, 0.5, False),
             "tied": (0, 1.25, True), "shared_tied": (1, 0.5, True)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    """Two replicas with their own weights: outputs within 1e-6 of their
    largest magnitude, both aux values within 1e-6."""
    n_shared, cf, tied = MOE_CASES[case]
    ref_spec, spec, ps = _moe_pair(4, 2, n_shared, cf)
    if tied:
        ps = [dict(p, router=jnp.zeros_like(p["router"])) for p in ps]
    x = np.random.default_rng(2).normal(size=(2, 3, 12, 16)).astype(
        np.float32) * 0.5
    run = jax.jit(lambda p, xr: ref_moe.moe_apply(p, ref_spec, xr))
    want = [run(p, jnp.asarray(xr)) for p, xr in zip(ps, x)]
    pp = params_from_numpy(_stack([_np_tree(p) for p in ps]), device="cpu")
    y, m = moe.moe_apply(pp, spec, torch.from_numpy(x))
    wy = np.stack([np.asarray(w[0]) for w in want])
    np.testing.assert_allclose(y.numpy(), wy, rtol=0,
                               atol=1e-6 * np.abs(wy).max())
    for key in ("moe_aux", "moe_dropped_frac"):
        assert m[key].shape == (2,) and m[key].dtype == torch.float32
        np.testing.assert_allclose(m[key].numpy(),
                                   [float(w[1][key]) for w in want],
                                   rtol=1e-6, atol=1e-7)
    if cf < 1:
        assert (m["moe_dropped_frac"] > 0).all()


def test_moe_gradients_match_reference():
    """d/d(params, x) of sum(y * c) + moe_aux, per replica."""
    ref_spec, spec, ps = _moe_pair(4, 2, 1, 0.75)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 2, 10, 16)).astype(np.float32) * 0.5
    c = rng.normal(size=x.shape).astype(np.float32)

    def f(p, xr, cr):
        y, m = ref_moe.moe_apply(p, ref_spec, xr)
        return jnp.sum(y * cr) + m["moe_aux"]
    g = jax.jit(jax.grad(f, argnums=(0, 1)))
    want = [g(p, jnp.asarray(xr), jnp.asarray(cr))
            for p, xr, cr in zip(ps, x, c)]
    pp = tree_map(lambda w: w.requires_grad_(True), params_from_numpy(
        _stack([_np_tree(p) for p in ps]), device="cpu"))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, m = moe.moe_apply(pp, spec, xt)
    ((y * torch.from_numpy(c)).flatten(1).sum(1) + m["moe_aux"]).sum() \
        .backward()
    wp = _stack([_np_tree(w[0]) for w in want])
    for got, ref in zip(tree_flatten(pp)[0], tree_flatten(wp)[0]):
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30))
    wx = np.stack([np.asarray(w[1]) for w in want])
    np.testing.assert_allclose(xt.grad.numpy(), wx, rtol=0,
                               atol=1e-5 * np.abs(wx).max())


def test_combine_adds_in_ascending_slot_order_at_k8_bf16():
    """kimi's k = 8 in bf16: the combine equals an explicit add into zeros
    over each token's slots in ascending order, bit for bit (an order that
    atomics would not keep)."""
    rng = np.random.default_rng(4)
    E, C, S, k, d, G = 16, 6, 10, 8, 24, 2
    ye = torch.from_numpy(rng.normal(size=(G, E * C, d)).astype(
        np.float32)).to(torch.bfloat16)
    inv = torch.stack([torch.from_numpy(np.stack([
        rng.choice(E * C + 1, size=k, replace=False) for _ in range(S)]))
        for _ in range(G)])
    inv[0, 0, 3] = E * C    # a dropped choice
    got = moe._combine(ye, inv)
    pad = torch.cat([ye, torch.zeros(G, 1, d, dtype=ye.dtype)], 1)
    for g in range(G):
        for t in range(S):
            acc = torch.zeros(d, dtype=torch.bfloat16)
            for s in sorted(inv[g, t].tolist()):
                acc = acc + pad[g, s]
            assert torch.equal(got[g, t], acc)


# ----------------------------------------- tests/test_moe.py on the port

def _port_moe(spec, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn((1,) + s.shape, generator=gen) * s.scale)
            if not isinstance(s, dict) else
            {kk: torch.randn((1,) + ss.shape, generator=gen) * ss.scale
             for kk, ss in s.items()}
            for k, s in moe.moe_init(d, spec).items()}


def _dense_oracle(p, spec, x):
    """Every token through its top-k experts without capacity limits."""
    probs = torch.softmax(torch.einsum("rbsd,rde->rbse", x, p["router"]), -1)
    topw, topi = moe._top_k(probs, spec.top_k)
    if spec.router_scale:
        topw = topw / (topw.sum(-1, keepdim=True) + 1e-9)
    h = silu(torch.einsum("rbsd,redf->rbsef", x, p["w_gate"])) \
        * torch.einsum("rbsd,redf->rbsef", x, p["w_in"])
    ye = torch.einsum("rbsef,refd->rbsed", h, p["w_out"])
    sel = torch.gather(ye, 3, topi[..., None].expand(
        topi.shape + (x.shape[-1],)))
    out = (sel * topw[..., None]).sum(3)
    if spec.n_shared:
        from repro_torch.models.layers import mlp_apply
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out


@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
def test_port_moe_matches_dense_oracle_when_capacity_suffices(n_shared):
    spec = MoESpec(n_experts=4, top_k=2, d_ff_expert=32, n_shared=n_shared,
                   capacity_factor=8.0)
    p = _port_moe(spec, 16)
    x = torch.randn(1, 2, 12, 16, generator=torch.Generator().manual_seed(1)) \
        * 0.5
    y, m = moe.moe_apply(p, spec, x)
    torch.testing.assert_close(y, _dense_oracle(p, spec, x), rtol=2e-4,
                               atol=2e-4)
    assert float(m["moe_dropped_frac"]) == 0.0


def test_port_moe_capacity_drops_reported():
    spec = MoESpec(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=0.25)
    p = _port_moe(spec, 8)
    y, m = moe.moe_apply(p, spec, torch.randn(
        1, 1, 32, 8, generator=torch.Generator().manual_seed(1)))
    assert float(m["moe_dropped_frac"]) > 0.0 and torch.isfinite(y).all()


def test_port_aux_loss_minimal_when_balanced():
    """A zero router: P_e is exactly 1/E, so aux = E * sum_e f_e / E = 1."""
    spec = MoESpec(n_experts=4, top_k=1, d_ff_expert=8, aux_coef=1.0)
    p = _port_moe(spec, 8)
    p["router"] = torch.zeros_like(p["router"])
    _, m = moe.moe_apply(p, spec, torch.randn(
        1, 1, 64, 8, generator=torch.Generator().manual_seed(1)))
    np.testing.assert_allclose(float(m["moe_aux"]), 1.0, rtol=1e-5)


@pytest.mark.parametrize("E,k,S", [(2, 1, 4), (4, 2, 16), (8, 4, 16),
                                   (8, 1, 4)])
def test_port_moe_finite_and_shape(E, k, S):
    spec = MoESpec(n_experts=E, top_k=k, d_ff_expert=8, capacity_factor=1.25)
    p = _port_moe(spec, 8, seed=E * 10 + k)
    x = torch.randn(1, 2, S, 8, generator=torch.Generator().manual_seed(S))
    y, m = moe.moe_apply(p, spec, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert 0.0 <= float(m["moe_dropped_frac"]) <= 1.0


def test_port_capacity_formula():
    spec = MoESpec(n_experts=8, top_k=2, d_ff_expert=8, capacity_factor=1.0)
    assert moe.moe_capacity(32, spec) == 8
    assert moe.moe_capacity(1, spec) == 1


# ----------------------------------------------------------- whole models

ARCHS = (JAMBA, KIMI)


def _batch(cfg, lead, S, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=tuple(lead) + (S + 1,)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """Two replicas with their own init: logits and aux of ``lm_apply``,
    ``make_loss_fn``'s loss and metrics, and the packed gradients."""
    ref_cfg, cfg = _cfgs(arch)
    S = 16
    tokens = _batch(cfg, (2, B), S)
    trees = [ref_lm_init(jax.random.key(i), ref_cfg)[0] for i in (0, 1)]
    apply = jax.jit(lambda t, tok: ref_lm_apply(t, ref_cfg, tok[:, :-1]))
    loss_fn = ref_make_loss_fn(ref_cfg)
    vg = jax.jit(jax.value_and_grad(lambda t, b: loss_fn(t, b), has_aux=True))
    want = [apply(t, jnp.asarray(tokens[r])) for r, t in enumerate(trees)]
    want_lm = [vg(t, {"tokens": jnp.asarray(tokens[r])})
               for r, t in enumerate(trees)]

    layout = build_layout(lm_specs(cfg))
    packed = params_from_numpy(_stack([_np_tree(t) for t in trees]),
                               layout=layout, device="cpu")
    for b in packed.buckets:
        b.requires_grad_(True)
    tok = torch.from_numpy(tokens)
    logits, aux = lm_apply(packed.unpack(), cfg, tok[..., :-1])
    wl = np.stack([np.asarray(w[0]) for w in want])
    np.testing.assert_allclose(logits.detach().numpy(), wl, rtol=2e-4,
                               atol=2e-4 * np.abs(wl).max())
    for key in ("moe_aux", "moe_dropped_frac"):
        assert aux[key].shape == (2,)
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   [float(w[1][key]) for w in want], **TOL)
    assert float(aux["moe_dropped_frac"].min()) > 0   # drops at 1.25
    loss, metrics = make_loss_fn(cfg)(packed.unpack(), {"tokens": tok})
    loss.sum().backward()
    assert sorted(metrics) == ["ce", "loss", "moe_aux", "moe_dropped_frac"]
    for key in metrics:
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   [float(w[0][1][key]) for w in want_lm],
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(loss.detach().numpy(),
                               (metrics["ce"] + metrics["moe_aux"]).detach()
                               .numpy(), rtol=0, atol=0)
    want_packed = params_from_numpy(
        _stack([_np_tree(w[1]) for w in want_lm]), layout=layout,
        device="cpu")
    for got, ref in zip(packed.buckets, want_packed.buckets):
        ref = ref.numpy()
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max())


def _close_tree(got, want):
    g, w = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill's logits and caches, then 3 decode steps (their logits and
    caches), against the reference's, at the configs' own capacity."""
    ref_cfg, cfg = _cfgs(arch)
    params = ref_lm_init(jax.random.key(0), ref_cfg)[0]
    pp = params_from_numpy(_np_tree(params), device="cpu")
    S, max_seq = 10, 32
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 3)).astype(
        np.int32)
    prefill = jax.jit(lambda p, t, c: ref_lm_prefill(p, ref_cfg, t, c))
    decode = jax.jit(lambda p, t, c, pos: ref_lm_decode(p, ref_cfg, t, c, pos))
    want, rc = prefill(params, jnp.asarray(toks[:, :S]),
                       ref_lm_cache_init(ref_cfg, B, max_seq))
    got, pc = lm_prefill(pp, cfg, torch.from_numpy(toks[:, :S]).long(),
                         lm_cache_init(cfg, B, max_seq, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_tree(pc, rc)
    for t in range(S, S + 3):
        want, rc = decode(params, jnp.asarray(toks[:, t]), rc, jnp.int32(t))
        got, pc = lm_decode(pp, cfg, torch.from_numpy(toks[:, t]).long(), pc,
                            torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close_tree(pc, rc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_full_forward(arch):
    """prefill(t[:-1]) + decode(t[-1]) == lm_apply(t) at the last position
    when capacity is ample (``capacity_factor`` 8, as ref
    ``tests/test_models_smoke.py``: capacity depends on the tokens per
    group, S in prefill and 1 in decode)."""
    _, cfg = _cfgs(arch, capacity_factor=8.0)
    params = lm_init(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_batch(cfg, (B,), 11, seed=6)).long()
    full, aux = lm_apply(tree_map(lambda w: w[None], params), cfg, toks[None])
    assert float(aux["moe_dropped_frac"]) == 0.0
    _, cache = lm_prefill(params, cfg, toks[:, :-1],
                          lm_cache_init(cfg, B, 32, device="cpu"))
    last, _ = lm_decode(params, cfg, toks[:, -1], cache, 11)
    torch.testing.assert_close(last, full[0, :, -1], **TOL)


# ----------------------------------------------------------------- remat

def test_remat_policies_bit_equal_and_save_the_combine():
    """Reduced jamba (two segments: Mamba + MLP, Mamba + MoE): remat off,
    on and save_moe_combine give bit-equal loss, metrics and gradients
    (deterministic algorithms); save_moe_combine saves exactly one op per
    MoE layer and forward."""
    _, cfg = _cfgs(JAMBA, d_model=32)
    assert len(segments_of(cfg.blocks)) == 2
    layout = build_layout(lm_specs(cfg))
    packed = PackedParams.pack(lm_init(cfg, seed=0, device="cpu"), layout,
                               lead=(2,), device="cpu")
    batch = {"tokens": torch.from_numpy(_batch(cfg, (2, B), 12))}
    saves = []
    policy = blocks._save_moe_combine

    def counting(ctx, op, *a, **k):
        out = policy(ctx, op, *a, **k)
        if ctx.is_recompute is False and out.name == "MUST_SAVE":
            saves.append(op)
        return out
    results = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, kw in (("off", {}), ("on", dict(remat=True)),
                         ("save_moe_combine", dict(
                             remat=True, remat_policy="save_moe_combine"))):
            bs = [b.detach().clone().requires_grad_(True)
                  for b in packed.buckets]
            p = PackedParams(bs, layout)
            blocks._save_moe_combine = counting
            try:
                loss, m = make_loss_fn(cfg, **kw)(p.unpack(), batch)
                loss.sum().backward()
            finally:
                blocks._save_moe_combine = policy
            results[name] = (m, [b.grad for b in bs])
    finally:
        torch.use_deterministic_algorithms(was)
    base_m, base_g = results["off"]
    for name, (m, g) in results.items():
        for key in base_m:
            assert torch.equal(m[key], base_m[key]), (name, key)
        assert all(torch.equal(a, b) for a, b in zip(g, base_g)), name
    n_moe = sum(b.moe is not None for b in cfg.blocks)
    assert len(saves) == n_moe and all(
        op is torch.ops.aten.add.Tensor for op in saves)


# -------------------------------------------------------------- registry

_MLA_MTP_DEFAULTS = {"mla": None, "mtp": False, "mtp_coef": 0.3}


def _mla_mtp_fields(d, found):
    """Collect the MLA and MTP fields of a config dict into ``found``."""
    if isinstance(d, dict):
        for k, v in d.items():
            if k in _MLA_MTP_DEFAULTS:
                found.setdefault(k, []).append(v)
            else:
                _mla_mtp_fields(v, found)
    elif isinstance(d, (list, tuple)):
        for v in d:
            _mla_mtp_fields(v, found)
    return found


def test_registry_equals_the_references_field_for_field():
    """All ten archs, full and reduced, field for field, the MLA and MTP
    fields included: they hold the reference's defaults everywhere but in
    deepseek-v3."""
    archs = configs.list_archs()
    assert archs == ref_configs.list_archs()
    assert len(archs) == 10 and configs.NOT_PORTED == {}
    for arch in archs:
        for shrink, ref_shrink in ((lambda c: c, lambda c: c),
                                   (reduced, ref_reduced)):
            got = dataclasses.asdict(shrink(configs.get_config(arch)))
            want = dataclasses.asdict(ref_shrink(ref_configs.get_config(arch)))
            assert got == want, arch
            fields = _mla_mtp_fields(got, {})
            default = all(v == _MLA_MTP_DEFAULTS[k] for k, vs in
                          fields.items() for v in vs)
            assert default == (arch != "deepseek-v3-671b"), arch


def test_full_size_param_trees_equal_the_references():
    """Paths, shapes and dtypes of the full-size jamba and kimi-k2 trees
    against ``jax.eval_shape`` of the reference's init, nothing
    allocated."""
    def skel(tree, leaf):
        if isinstance(tree, dict):
            return {k: skel(v, leaf) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [skel(v, leaf) for v in tree]
        return leaf(tree)
    for arch, n_want in ((JAMBA, 51.57e9), (KIMI, 1044.86e9)):
        shapes = jax.eval_shape(lambda k: ref_lm_init(
            k, ref_configs.get_config(arch))[0], jax.random.key(0))
        specs = lm_specs(configs.get_config(arch))
        assert skel(specs, lambda s: (tuple(s.shape),
                                      str(s.dtype).split(".")[-1])) == \
            skel(shapes, lambda x: (tuple(x.shape), str(x.dtype)))
        n = sum(int(np.prod(s.shape)) for s in tree_flatten(specs)[0])
        assert abs(n - n_want) < 0.01 * n_want, (arch, n)


# ------------------------------------- reference bundle and launcher runs

D_MODEL, SEQ, GLOBAL_B, STEPS, LR = 32, 12, 8, 4, 0.3
LAUNCH = ["--smoke", "--seq-len", "12", "--global-batch", "2", "--d-model",
          "32", "--log-every", "0"]

_REFERENCE = r"""
import json, os, pickle, sys
import repro
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import build_schedule, make_sim_train_step
from repro.data import ShardedTokenDataset, make_replica_batches
from repro.models import lm_init, reduced
from repro.optim import sgd, step_decay
from repro.train.loss import make_loss_fn
import repro.launch.train as L

cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
opt = sgd(step_decay({lr}, 0.1, 2), momentum=0.9)
init = lm_init(jax.random.key(0), cfg)[0]
out = {{"init": jax.tree.map(np.asarray, init)}}
loss_fn = make_loss_fn(cfg)
step = make_sim_train_step(lambda p, b: loss_fn(p, b)[0], opt,
                           build_schedule(4))
params = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), init)
st, losses = opt.init(params), []
ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards=4,
                         batch_per_shard={gb} // 4, seed=0)
for t in range({steps}):
    batch = jax.tree.map(jnp.asarray, make_replica_batches(ds, t, 4))
    st, params, m = step(st, params, batch, jnp.int32(t))
    losses.append(float(m["loss"]))
out["sim"] = {{"loss": losses, "params": jax.tree.map(np.asarray, params)}}
# the launcher: a straight 4-step run, and a 2-step run that writes its
# checkpoint for the port's launcher to resume
dest, launch, ckpt = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
for arch in ("jamba-v0.1-52b", "kimi-k2-1t-a32b"):
    for extra in (["--steps", "4"],
                  ["--steps", "2", "--checkpoint", os.path.join(ckpt, arch)]):
        sys.argv = ["train", "--arch", arch] + launch + extra
        L.main()
with open(dest, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    out, ckpt = tmp / "ref.pkl", tmp / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(d=D_MODEL, lr=LR, seq=SEQ, gb=GLOBAL_B,
                               steps=STEPS)
    r = subprocess.run([sys.executable, "-c", script, str(out),
                        json.dumps(LAUNCH), str(ckpt)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out, "rb") as f:  # written by the subprocess above
        res = pickle.load(f)
    runs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    res["launcher"] = {run["arch"]: run for run in runs[::2]}
    res["ckpt"] = ckpt
    return res


def test_dp4_jamba_trajectory_matches_reference(reference_runs):
    """Reduced jamba, dp 4, sync gossip, packed sgd (update, then the mix:
    ``fused_update=False``) through the port's Trainer against the
    reference's replica simulator (``make_sim_train_step``, the same
    composition) from one init: losses and final params. The reference's
    bundle cannot run MoE on a multi-device mesh on this JAX (its
    expert-parallel ``shard_map`` fails in the SPMD partitioner)."""
    from repro_torch.data import ShardedTokenDataset
    from repro_torch.optim import sgd, step_decay
    from repro_torch.train import (Trainer, init_train_state,
                                   make_train_step_bundle)
    _, cfg = _cfgs(JAMBA, d_model=D_MODEL)
    opt = sgd(step_decay(LR, 0.1, 2), momentum=0.9)
    bundle = make_train_step_bundle(cfg, opt, dp=4, gossip_packed=True,
                                    fused_update=False, remat=False,
                                    device="cpu")
    params = params_from_numpy(reference_runs["init"], layout=bundle.layout,
                               lead=(4,), device="cpu")
    state = init_train_state(cfg, opt, dp=4, packed=True,
                             layout=bundle.layout, params=params,
                             device="cpu")
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=4,
                             batch_per_shard=GLOBAL_B // 4, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(STEPS)
    want = reference_runs["sim"]
    np.testing.assert_allclose([h["loss"] for h in hist], want["loss"], **TOL)
    assert all(h["moe_aux"] > 0 for h in hist)
    got = tr.state["params"].unpack()
    for a, b in zip(tree_flatten(got)[0], jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)


@pytest.mark.parametrize("arch", [JAMBA, KIMI])
def test_launcher_smoke_matches_reference_launcher(arch, reference_runs,
                                                   capsys):
    """``--smoke --arch jamba|kimi`` as the reference's launcher runs it
    (its reduced fp32 model, per-leaf sync gossip): the port's launcher
    resumes the reference launcher's 2-step checkpoint (torch cannot replay
    jax.random, so the shared state is the reference's) and runs to step
    4; its last loss is the reference's straight 4-step run's within
    2e-4."""
    from repro_torch.launch.train import main
    main(["--arch", arch, *LAUNCH, "--steps", "2", "--device", "cpu",
          "--checkpoint", str(reference_runs["ckpt"] / arch), "--resume"])
    out = capsys.readouterr().out
    assert "at step 2" in out
    got = [json.loads(line) for line in out.splitlines()
           if line.startswith("{")][-1]
    want = reference_runs["launcher"][got["arch"]]
    assert got["arch"] == reduced(configs.get_config(arch)).name
    assert got["start_step"] == 2 and np.isfinite(got["final_loss"])
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=2e-4, atol=2e-4)


def test_launcher_refuses_the_encoder_decoder_arch():
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="audio_frames"):
        main(["--arch", "whisper-base", *LAUNCH, "--steps", "1",
              "--device", "cpu"])
