"""AdamW and LARS in the port against the reference: kernels, optimizer
units, the LARS norm prepass, the engines and the dp=4 trajectories.

* Kernels: ``fused_adamw_plain`` / ``fused_lars_plain`` (what the port's
  wrappers run on the CPU) against the reference's jnp twins
  ``fused_adamw_ref`` / ``fused_lars_ref`` and, where the alpha is not one
  per row, its Pallas kernels in interpret mode, at alpha 0.5 and 0
  (static), a () tensor and one alpha per row; raw partners (bf16 on fp32
  and, for LARS, fp32 on bf16), int8 and fp8 codes with their scales for
  AdamW (decoded by ``dequant_flat`` for the twin), and a ragged AdamW
  tail. fp32 within 2 ulp of the largest of the results and the operands
  (XLA:CPU contracts multiply-adds into FMAs where the port rounds each op,
  the gap the reference notes between its own twin and interpret paths,
  tests/test_fused_update.py:167-178); AdamW's fp32 params within 4 ulp of
  the largest of those and the step ``lr * u``, since u chains two
  divisions and a square root of moments that each carry that gap; bf16
  params equal to the twin's and
  within one bf16 ulp of the interpret kernel's (which differs from the
  twin by that much itself on AdamW's longer chain).
* Fused against the unfused composition in the port over 3 steps
  (tests/test_fused_update.py:98-176): equal for sgd, adamw in fp32 and
  bf16 (adamw's tree-level update runs the same fp32 math); sgd in bf16
  within 2e-2 (its tree-level momentum is bf16); lars within 4 fp32 ulps,
  because the prepass sums squares per 128-element row and then per slot
  while the tree-level norm sums the whole leaf in one reduction.
* The LARS prepass (``_lars_row_scale``) against the reference's, per
  replica row with that row's alpha, and the dp=4 sync fused engine against
  the reference's tree-level LARS applied per replica
  (tests/test_fused_update.py:544-589): trust ratios within rtol 2e-6 (the
  two sum in different orders), params within 2 ulp, momenta within 2e-6
  of their terms (``mu * m`` and ``g * trust``).
* Units (tests/test_optim_data_ckpt.py:43, :149, :160) and packed against
  leaf LARS (tests/test_buckets.py:146, :176).
* The slice as a whole: dp=4 trajectories of adamw and lars through the
  port's Trainer against the reference trainer (a subprocess with four
  forced host devices) for sync fused, sync unfused, gossip_async int8
  subset 0.5 fused and gossip_async unfused, 4 steps, 5 buckets. Losses
  within rtol = atol = 2e-4 (tests/test_hier_packed.py:417); bucket
  elements too, except (a) where a wire code flipped (at most alpha times
  one code step of the tile, as tests/test_torch_async.py) and (b) under
  AdamW, where the first steps move an element by about lr times the sign
  of its gradient, so a gradient at rounding level in one framework can
  flip it: at most 2 * lr * steps. Such elements must be at most 0.1% of
  all; the count is printed.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.async_gossip import exchange_ok as ref_exchange_ok  # noqa: E402
from repro.core.async_gossip import init_inbox_ring as ref_init_ring  # noqa: E402
from repro.core.async_gossip import \
    init_wire_inbox_ring as ref_init_wire_ring  # noqa: E402
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.core.topology import build_subset_schedule as ref_subset  # noqa: E402
from repro.kernels import quantize as RQ  # noqa: E402
from repro.kernels.fused_update import fused_adamw_1d as ref_adamw_1d  # noqa: E402
from repro.kernels.fused_update import fused_adamw_ref  # noqa: E402
from repro.kernels.fused_update import fused_lars_1d as ref_lars_1d  # noqa: E402
from repro.kernels.fused_update import fused_lars_ref  # noqa: E402
from repro.optim import lars as ref_lars  # noqa: E402
from repro.optim.optimizers import _lars_row_scale as ref_row_scale  # noqa: E402
from repro_torch.checkpoint import array_to_torch, params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (PackedParams, build_layout,  # noqa: E402
                              build_schedule, make_packed_fused_async_update,
                              make_packed_fused_update)
from repro_torch.data import ShardedTokenDataset  # noqa: E402
from repro_torch.kernels import (fused_adamw_1d, fused_adamw_bucket,  # noqa: E402
                                 fused_lars_1d, fused_lars_bucket,
                                 fused_update, gossip_mix_bucket)
from repro_torch.kernels import quantize as Q  # noqa: E402
from repro_torch.models import reduced  # noqa: E402
from repro_torch.optim import adamw, lars, sgd, step_decay  # noqa: E402
from repro_torch.optim.optimizers import (_lars_row_scale,  # noqa: E402
                                          bias_correction)
from repro_torch.train import (Trainer, init_train_state,  # noqa: E402
                               make_train_step_bundle)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ROWS = 4
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return array_to_torch(np.asarray(x), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype="float32", operands=(), ulps=2):
    """fp32: |got - want| <= ``ulps`` ulp of the largest of got, want and
    the operands, elementwise; bf16: equal."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype != "float32":
        np.testing.assert_array_equal(got, want)
        return
    scale = np.maximum(np.abs(got), np.abs(want))
    for x in operands:
        scale = np.maximum(scale, np.abs(_f32(x)))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= ulps * np.spacing(scale)).all(), \
        float((err / np.spacing(scale)).max())


def _within_bf16_ulp(got, want):
    """bf16 values at most one bf16 ulp apart: the reference's own Pallas
    kernel (interpret mode) and its jnp twin differ by that much on AdamW's
    longer chain, where an fp32 ulp of FMA contraction lands on a bf16
    rounding boundary."""
    got, want = _f32(got), _f32(want)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))) * 2.0 ** 16
    assert (np.abs(got - want) <= ulp).all()


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a jax array and a torch tensor (bit-identical)."""
    x = jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32)
                    ).astype(dtype)
    return x, _t(x)


ALPHAS = ["0.5", "0", "tensor", "per-row"]


def _alpha(kind):
    """(reference alpha, port alpha): static floats, a () tensor, or one
    alpha per row ((ROWS, 1) for the twin, (ROWS,) for the port)."""
    if kind == "tensor":
        return jnp.float32(0.25), torch.tensor(0.25)
    if kind == "per-row":
        a = np.array([0.5, 0.0, 0.25, 0.125], np.float32)
        return jnp.asarray(a)[:, None], torch.from_numpy(a)
    return float(kind), float(kind)


# ------------------------------------------------------------------ adamw

ADAM = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.02)
LR = np.float32(0.01)


def _adam_inputs(rng, n, dtype):
    jp, tp = _pair(rng, (ROWS, n), dtype)
    jg, tg = _pair(rng, (ROWS, n), dtype, 0.1)
    jm, tm = _pair(rng, (ROWS, n), jnp.float32, 0.01)
    jv, tv = _pair(rng, (ROWS, n), jnp.float32, 1e-3)
    jv, tv = jnp.abs(jv), tv.abs()
    return (jp, jg, jm, jv), (tp, tg, tm, tv)


@pytest.mark.parametrize("kind", ALPHAS)
@pytest.mark.parametrize("dtype,partner", [
    (d, b) for d in DTYPES for b in ("raw", "int8", "fp8", "none")]
    + [("float32", "bf16")])  # a narrower partner on an fp32 bucket
def test_adamw_plain_matches_reference(dtype, kind, partner):
    rng = np.random.default_rng(len(kind) + 7 * len(partner))
    n = 6 * 128
    (jp, jg, jm, jv), (tp, tg, tm, tv) = _adam_inputs(rng, n, DTYPES[dtype])
    jb, tb = _pair(rng, (ROWS, n), DTYPES[dtype])
    scales = jscales = None
    if partner == "bf16":
        jb, tb = jb.astype(jnp.bfloat16), tb.to(torch.bfloat16)
    elif partner in ("int8", "fp8"):
        enc = RQ.encode_wire(jb, partner, keys=RQ.wire_key(
            2, jnp.arange(ROWS), 1, 0))
        jb, jscales = enc["q"], enc["s"]
        tb, scales = _t(jb), _t(jscales)
    elif partner == "none":
        jb = tb = None
    j_al, t_al = _alpha(kind)
    c1, c2 = bias_correction(0.9, 3), bias_correction(0.95, 3)
    coef = dict(lr=jnp.float32(LR), c1=jnp.float32(c1), c2=jnp.float32(c2))
    dec = RQ.dequant_flat(jb, jscales) if jscales is not None else jb
    want = jax.jit(lambda p, g, b, m, v, a: fused_adamw_ref(
        p, g, b, m, v, alpha=a, **coef, **ADAM),
        static_argnums=(5,) if kind in ("0.5", "0") else ())(
        jp, jg, dec, jm, jv, j_al)
    wants = [want]
    if kind != "per-row":  # the Pallas kernel flattens its rows
        wants.append(ref_adamw_1d(jp, jg, jb, jm, jv, alpha=j_al,
                                  partner_scales=jscales, interpret=True,
                                  **coef, **ADAM))
    before = fused_update.adamw_launches.count
    got = fused_adamw_1d(tp, tg, tb, tm, tv, lr=float(LR), c1=c1, c2=c2,
                         alpha=t_al, partner_scales=scales, **ADAM)
    assert got[0] is tp and got[1] is tm and got[2] is tv  # in place
    assert fused_update.adamw_launches.count == before  # CPU: no kernel
    ops = (jp, jg, jm, jv) + ((dec,) if dec is not None else ())
    for k, w in enumerate(wants):
        if k and dtype == "bfloat16":  # the interpret kernel
            _within_bf16_ulp(got[0], w[0])
        else:  # the step lr * u is an operand of p's last subtraction
            _close(got[0], w[0], dtype, ops + (_f32(jp) - _f32(w[0]),),
                   ulps=4)
        _close(got[1], w[1], "float32", (jm, jg))
        _close(got[2], w[2], "float32", (jv, jg * jg))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adamw_ragged_tail_matches_reference(dtype):
    """A length that is not a LANE multiple: the reference's tiled prefix
    and jnp epilogue against the port's one sweep."""
    rng = np.random.default_rng(3)
    n = 3 * 128 + 37
    jp, tp = _pair(rng, (n,), DTYPES[dtype])
    jg, tg = _pair(rng, (n,), DTYPES[dtype], 0.1)
    jb, tb = _pair(rng, (n,), DTYPES[dtype])
    jm, tm = _pair(rng, (n,), jnp.float32, 0.01)
    jv, tv = _pair(rng, (n,), jnp.float32, 1e-3)
    jv, tv = jnp.abs(jv), tv.abs()
    coef = dict(lr=jnp.float32(LR), c1=jnp.float32(0.1), c2=jnp.float32(0.05))
    want = ref_adamw_1d(jp, jg, jb, jm, jv, alpha=0.5, interpret=True,
                        **coef, **ADAM)
    got = fused_adamw_1d(tp, tg, tb, tm, tv, lr=float(LR),
                         c1=float(np.float32(0.1)), c2=float(np.float32(0.05)),
                         alpha=0.5, **ADAM)
    if dtype == "bfloat16":
        _within_bf16_ulp(got[0], want[0])
    else:
        _close(got[0], want[0], dtype,
               (jp, jg, jb, jm, jv, _f32(jp) - _f32(want[0])), ulps=4)
    _close(got[1], want[1], "float32", (jm, jg))
    _close(got[2], want[2], "float32", (jv, jg * jg))


def test_adamw_one_minus_beta_is_the_double_rounded_once():
    """(1 - b1) reaches the arithmetic as float32(1 - 0.9) = 0x3DCCCCCD, not
    1.0f - 0.9f = 0x3DCCCCD0: with m = 0 and g = 1, m' is that value."""
    p, g = torch.zeros(128), torch.ones(128)
    m, v = torch.zeros(128), torch.zeros(128)
    fused_adamw_1d(p, g, None, m, v, lr=0.0, c1=0.1, c2=0.05)
    assert m[0].view(torch.int32).item() == 0x3DCCCCCD
    assert np.float32(1.0) - np.float32(0.9) != np.float32(1 - 0.9)


def test_bias_correction_matches_reference():
    """numpy float32 ``1 - beta^t`` against the reference's traced float32
    pow: within 2 ulp of the larger of ``beta^t`` and ``1 - beta^t`` (XLA's
    pow and numpy's differ by an ulp of ``beta^t``, which is many ulp of
    ``1 - beta^t`` when that is small, and one of it after rounding when
    it is large)."""
    worst = 0.0
    for beta in (0.9, 0.95, 0.999):
        for t in range(1, 40):
            want = float(jax.jit(lambda s: 1 - beta ** s.astype(jnp.float32))(
                jnp.int32(t)))
            got = bias_correction(beta, t)
            ulp = float(np.spacing(np.float32(max(want, 1.0 - want))))
            worst = max(worst, abs(got - want) / ulp)
    assert worst <= 2.0, worst


# ------------------------------------------------------------------- lars

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ALPHAS)
@pytest.mark.parametrize("partner", ["same", "other", "none"])
def test_lars_plain_matches_reference(dtype, kind, partner):
    """Partners of the bucket's width, of the other width (fp32 on bf16:
    the reference's pre-decoded quantized partner) and none; one trust
    scale per 128-element row."""
    rng = np.random.default_rng(31 + len(kind) + len(partner))
    n = 6 * 128
    jp, tp = _pair(rng, (ROWS, n), DTYPES[dtype])
    jg, tg = _pair(rng, (ROWS, n), DTYPES[dtype], 0.1)
    jm, tm = _pair(rng, (ROWS, n), jnp.float32, 0.01)
    other = jnp.float32 if dtype == "bfloat16" else jnp.bfloat16
    jb, tb = _pair(rng, (ROWS, n), DTYPES[dtype] if partner == "same"
                   else other)
    if partner == "none":
        jb = tb = None
    js, ts = _pair(rng, (ROWS * n // 128,), jnp.float32, 1e-2)
    js, ts = jnp.abs(js), ts.abs()
    j_al, t_al = _alpha(kind)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    want = jax.jit(lambda p, g, b, m, s, a: fused_lars_ref(
        p, g, b, m, s, lr=jnp.float32(0.1), alpha=a, **kw),
        static_argnums=(5,) if kind in ("0.5", "0") else ())(
        jp, jg, jb, jm, js, j_al)
    wants = [want]
    if kind != "per-row":
        wants.append(ref_lars_1d(jp, jg, jb, jm, js, lr=jnp.float32(0.1),
                                 alpha=j_al, interpret=True, **kw))
    before = fused_update.lars_launches.count
    got = fused_lars_1d(tp, tg, tb, tm, ts, lr=0.1, alpha=t_al, **kw)
    assert got[0] is tp and got[1] is tm
    assert fused_update.lars_launches.count == before
    ops = (jp, jg, jm) + ((jb,) if jb is not None else ())
    for k, w in enumerate(wants):
        if k and dtype == "bfloat16":  # the interpret kernel
            _within_bf16_ulp(got[0], w[0])
        else:
            _close(got[0], w[0], dtype, ops)
        _close(got[1], w[1], "float32", (jm, jg * js.repeat(128).reshape(
            ROWS, n)))


def test_lars_kernel_wants_lane_aligned_buffers_and_row_scales():
    p = torch.zeros(2, 200)
    with pytest.raises(ValueError, match="row_scale"):
        fused_lars_1d(p, p.clone(), None, p.clone(), torch.ones(3), lr=0.1)
    p = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="row_scale"):
        fused_lars_1d(p, p.clone(), None, p.clone(), torch.ones(2), lr=0.1)


# -------------------------------------------- fused vs unfused, in the port

BF16_TOL = 2e-2


def _odd_tree(lead=(), seed=7):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=lead + s).astype(np.float32)  # noqa: E731
    return {"w1": mk(5, 3), "w2": mk(130), "w3": mk(2, 7, 11), "b": mk(1)}


def _torch_tree(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _optimizers():
    return [
        ("sgd", sgd(0.1, momentum=0.9, weight_decay=1e-4)),
        ("sgd_plain", sgd(0.1, momentum=0.0)),
        ("adamw", adamw(0.01, weight_decay=0.02)),
        ("lars", lars(0.1, momentum=0.9, weight_decay=1e-4)),
    ]


def _clone_state(opt, state):
    out = {"step": state["step"]}
    for k in opt.fused_moments:
        out[k] = (PackedParams([b.clone() for b in state[k].buckets],
                               state[k].layout)
                  if state[k] is not None else None)
    return out


@pytest.mark.parametrize("opt_name,opt", _optimizers(),
                         ids=[n for n, _ in _optimizers()])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_fused_bucket_matches_unfused_composition(opt_name, opt, dtype,
                                                  alpha):
    """fused_update == standalone bucket mix + tree-level update, per
    bucket, for 3 steps (dp = 1, so lars's norms agree in scope)."""
    tree = _torch_tree(_odd_tree(), dtype)
    layout = build_layout(tree)
    grads = PackedParams.pack({k: v * 0.1 + 0.01 for k, v in tree.items()},
                              layout, lead=(1,))
    partner = PackedParams.pack({k: v + 0.02 for k, v in tree.items()},
                                layout, lead=(1,))
    rp = PackedParams.pack(tree, layout, lead=(1,))
    fp = PackedParams([b.clone() for b in rp.buckets], layout)
    rst = opt.init(rp)
    fst = _clone_state(opt, rst)
    for _ in range(3):
        if alpha:
            for b, q in zip(rp.buckets, partner.buckets):
                gossip_mix_bucket(b, q, alpha)
        rp, rst = opt.update(rp, grads, rst)
        for i in range(layout.num_buckets):
            moms = tuple(fst[k].buckets[i] if fst[k] is not None else None
                         for k in opt.fused_moments)
            opt.fused_update(i, fp.buckets[i], grads.buckets[i],
                             partner.buckets[i], moms, step=fst["step"],
                             alpha=alpha, layout=layout)
        fst = dict(fst, step=fst["step"] + 1)
        assert fst["step"] == rst["step"]
        pairs = list(zip(fp.buckets, rp.buckets))
        mpairs = [pr for k in opt.fused_moments if rst[k] is not None
                  for pr in zip(fst[k].buckets, rst[k].buckets)]
        for (a, b), is_mom in ([(x, False) for x in pairs]
                               + [(x, True) for x in mpairs]):
            a, b = _f32(a), _f32(b)
            if opt_name == "sgd" and dtype == torch.bfloat16:
                np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL)
            elif opt_name == "lars" and (is_mom or dtype == torch.float32):
                _close(a, b, "float32", (), ulps=4)
            elif opt_name == "lars":  # bf16 params: a trust ulp may round
                np.testing.assert_allclose(a, b, rtol=BF16_TOL, atol=1e-6)
            else:
                np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- lars prepass

def _five_bucket_layout():
    tree = {f"w{i}": torch.zeros(n) for i, n in
            enumerate((700, 520, 400, 390, 260, 250, 130, 100))}
    layout = build_layout(tree, target_bucket_bytes=3000)
    assert layout.num_buckets == 5
    return layout


def _packed_random(layout, rng, scale=1.0, lead=(ROWS,)):
    """Random leaves packed through the layout: alignment gaps are zero,
    as in a real bucket."""
    tree = {f"w{s.index}": torch.from_numpy(
        (rng.normal(size=lead + s.shape) * scale).astype(np.float32))
        for s in layout.slots}
    tree = layout.treedef.unflatten([tree[f"w{s.index}"]
                                     for s in layout.slots])
    return PackedParams.pack(tree, layout, lead=lead)


def _ref_layout(layout):
    tree = layout.treedef.unflatten([np.zeros(s.shape, np.float32)
                                     for s in layout.slots])
    ref = ref_build_layout(tree, target_bucket_bytes=3000)
    assert ref.bucket_sizes == layout.bucket_sizes
    return ref


@pytest.mark.parametrize("kind", ALPHAS)
@pytest.mark.parametrize("partner", [True, False], ids=["partner", "local"])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_lars_row_scale_matches_reference_per_replica(kind, partner, wd):
    layout = _five_bucket_layout()
    ref_layout = _ref_layout(layout)
    rng = np.random.default_rng(5)
    ps, gs, bs = (_packed_random(layout, rng, s) for s in (1.0, 0.1, 1.0))
    _, t_al = _alpha(kind)
    kw = dict(weight_decay=wd, trust_coef=1e-3, eps=1e-9)
    for i in range(layout.num_buckets):
        p, g, b = ps.buckets[i], gs.buckets[i], bs.buckets[i]
        got = _lars_row_scale(layout, i, p, g, b if partner else None,
                              alpha=t_al, **kw)
        assert got.shape == (ROWS, p.shape[-1] // 128)
        for r in range(ROWS):  # the reference's scalar alpha, row by row
            a = (float(t_al[r]) if kind == "per-row" else
                 jnp.float32(0.25) if kind == "tensor" else float(kind))
            want = ref_row_scale(
                ref_layout, i, jnp.asarray(p[r:r + 1].numpy()),
                jnp.asarray(g[r:r + 1].numpy()),
                jnp.asarray(b[r:r + 1].numpy()) if partner else None,
                alpha=a, **kw)
            np.testing.assert_allclose(got[r].numpy(), np.asarray(want)[0],
                                       rtol=2e-6, atol=0)


def test_lars_sync_engine_matches_per_replica_oracle():
    """dp=4 sync fused engine with lars against the reference's tree-level
    lars applied to each replica of the mixed params (each rank owns a
    distinct model), every phase of the schedule, each step from the
    reference's state."""
    dp, alpha = 4, 0.5
    layout = _five_bucket_layout()
    ref_layout = _ref_layout(layout)
    rng = np.random.default_rng(8)
    ps = _packed_random(layout, rng, lead=(dp,))
    gs = _packed_random(layout, rng, 0.1, lead=(dp,))
    ms = _packed_random(layout, rng, 0.01, lead=(dp,))
    opt = lars(0.1, momentum=0.9, weight_decay=1e-4)
    ropt = ref_lars(0.1, momentum=0.9, weight_decay=1e-4)
    sched = build_schedule(dp)
    eng = make_packed_fused_update(sched, layout, opt, alpha=alpha)
    rp = [jnp.asarray(b.numpy()) for b in ps.buckets]
    rm = [jnp.asarray(b.numpy()) for b in ms.buckets]
    rg = [jnp.asarray(b.numpy()) for b in gs.buckets]
    for t in range(sched.period):
        recv = np.asarray(sched.recv_from(t))
        mixed = [((1.0 - alpha) * b + alpha * b[recv]).astype(b.dtype)
                 for b in rp]
        outs = [ropt.update(
            RefPacked([b[r:r + 1] for b in mixed], ref_layout),
            RefPacked([b[r:r + 1] for b in rg], ref_layout),
            {"step": jnp.int32(t),
             "mom": RefPacked([b[r:r + 1] for b in rm], ref_layout)})
            for r in range(dp)]
        want_p = [np.concatenate([np.asarray(o[0].buckets[i]) for o in outs])
                  for i in range(layout.num_buckets)]
        want_m = [np.concatenate([np.asarray(o[1]["mom"].buckets[i])
                                  for o in outs])
                  for i in range(layout.num_buckets)]
        params = PackedParams([_t(b) for b in rp], layout)
        state = {"step": t, "mom": PackedParams([_t(b) for b in rm], layout)}
        got_p, got_s = eng(params, gs, state, t)
        for i in range(layout.num_buckets):
            _close(got_p.buckets[i], want_p[i], "float32",
                   (rp[i], rp[i][recv]))
            # m = mu * m + g * trust: the trust ratios agree to 2e-6, so
            # does g * trust = m' - mu * m, whatever m' cancels to
            err = np.abs(got_s["mom"].buckets[i].numpy() - want_m[i])
            assert (err <= 2e-6 * (np.abs(want_m[i])
                                   + 0.9 * np.abs(np.asarray(rm[i])))
                    + 1e-12).all()
        rp = [jnp.asarray(w) for w in want_p]
        rm = [jnp.asarray(w) for w in want_m]


def test_lars_quantized_partner_is_decoded_before_the_prepass():
    """An int8 payload through lars.fused_update equals the same update
    with the decoded fp32 partner (the reference's pre-decode)."""
    layout = _five_bucket_layout()
    rng = np.random.default_rng(2)
    ps = _packed_random(layout, rng)
    gs = _packed_random(layout, rng, 0.1)
    enc = {"q": torch.from_numpy(rng.integers(-127, 128, ps.buckets[0].shape,
                                              dtype=np.int8)),
           "s": torch.rand(ROWS, ps.buckets[0].shape[-1] // 128) * 1e-2}
    opt = lars(0.1, weight_decay=1e-4)
    a = (ps.buckets[0].clone(), torch.zeros_like(ps.buckets[0]))
    b = (ps.buckets[0].clone(), torch.zeros_like(ps.buckets[0]))
    opt.fused_update(0, a[0], gs.buckets[0], enc, (a[1],), step=0,
                     alpha=0.5, layout=layout)
    dec = enc["q"].float().view(ROWS, -1, 128) * enc["s"][..., None]
    opt.fused_update(0, b[0], gs.buckets[0], dec.view(ROWS, -1), (b[1],),
                     step=0, alpha=0.5, layout=layout)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="BucketLayout"):
        opt.fused_update(0, a[0], gs.buckets[0], None, (a[1],), step=0,
                         alpha=0.0)


# --------------------------------------------- engines x wires x optimizers

ENGINE_WIRES = [("int8", 1.0), ("fp8", 1.0), ("bf16", 1 / 3), ("fp32", 1.0)]
ENGINE_STEP = 2        # the optimizer step the states carry


def _ref_engine_update(name, ps, gs, moms, partners, alphas, ref_layout):
    """The reference's fused bucket update per bucket: adamw's jnp twin
    with the port's host bias corrections (the float32 pow gap is held
    apart by test_bias_correction_matches_reference), lars's fused backend
    row by row (its prepass takes one scalar alpha per device)."""
    new_p, new_m = [], []
    for i, (p, g, m) in enumerate(zip(ps, gs, moms)):
        b, a = partners[i], alphas[i]
        if name == "adamw":
            c1 = jnp.float32(bias_correction(0.9, ENGINE_STEP + 1))
            c2 = jnp.float32(bias_correction(0.95, ENGINE_STEP + 1))
            np_, nm, nv = fused_adamw_ref(
                p, g, b, m[0], m[1], lr=jnp.float32(LR), c1=c1, c2=c2,
                alpha=a if b is not None else 0.0, **ADAM)
            new_p.append(np_)
            new_m.append((nm, nv))
            continue
        ropt = ref_lars(0.1, momentum=0.9, weight_decay=1e-4)
        rows = [ropt.fused_update(
            i, p[r:r + 1], g[r:r + 1], b[r:r + 1] if b is not None else None,
            (m[0][r:r + 1],), step=jnp.int32(ENGINE_STEP),
            alpha=(jnp.float32(np.asarray(a).reshape(-1)[r])
                   if b is not None and not isinstance(a, float) else
                   a if b is not None else 0.0),
            layout=ref_layout, impl="jnp") for r in range(ROWS)]
        new_p.append(jnp.concatenate([o[0] for o in rows]))
        new_m.append((jnp.concatenate([o[1][0] for o in rows]),))
    return new_p, new_m


def _engine_opt(name):
    return (adamw(float(LR), **ADAM) if name == "adamw"
            else lars(0.1, momentum=0.9, weight_decay=1e-4))


def _check_engine_step(name, got_p, got_s, want_p, want_m, ps, gs, moms):
    keys = ("m", "v") if name == "adamw" else ("mom",)
    for i in range(len(want_p)):
        _close(got_p.buckets[i], want_p[i], "float32",
               (ps[i], gs[i], _f32(ps[i]) - _f32(want_p[i])), ulps=4)
        for j, k in enumerate(keys):
            got = got_s[k].buckets[i].numpy()
            want = np.asarray(want_m[i][j])
            if name == "adamw":
                _close(got, want, "float32", (moms[i][j], gs[i] * gs[i]))
            else:  # trust ratios agree to 2e-6 (test above)
                err = np.abs(got - want)
                assert (err <= 2e-6 * (np.abs(want) + 0.9 * np.abs(
                    np.asarray(moms[i][j]))) + 1e-12).all()


@pytest.mark.parametrize("name", ["adamw", "lars"])
@pytest.mark.parametrize("wire_dtype,subset", ENGINE_WIRES,
                         ids=["int8", "fp8", "bf16_sub3", "fp32"])
def test_fused_async_engine_matches_composed_reference(name, wire_dtype,
                                                       subset):
    """gossip_async (k 2, drops 0.3) fused engine with adamw / lars on
    every wire, per-row masked alpha, every phase plus the bootstrap
    steps, each step from the reference's state: the RAW bucket encoded on
    the ring counter and exchanged, the reference's fused update against
    the oldest slot's decoded payload at alpha * valid[:, 0] per row."""
    k, drop, alpha = 2, 0.3, 0.5
    layout = _five_bucket_layout()
    ref_layout = _ref_layout(layout)
    wire = Q.WireFormat(wire_dtype, subset, seed=2)
    sub = ref_subset(layout.num_buckets, subset)
    eff = 4 if sub is None else 4 * sub.period // np.gcd(4, sub.period)
    sched = build_schedule(DP)
    update = make_packed_fused_async_update(
        sched, layout, _engine_opt(name), alpha=alpha, staleness=k,
        drop_rate=drop, drop_seed=5, wire=wire)
    rng = np.random.default_rng(21)
    ps = [jnp.asarray(b.numpy()) for b in _packed_random(layout, rng).buckets]
    ring = (ref_init_ring(ps, k, DP) if wire.is_default else
            ref_init_wire_ring(SimpleNamespace(buckets=ps), k, DP,
                               RQ.WireFormat(wire_dtype, subset, seed=2)))
    nmom = 2 if name == "adamw" else 1
    moms = [tuple(jnp.abs(jnp.asarray(b.numpy())) * 1e-3 for b in
                  _packed_random(layout, rng).buckets) for _ in range(nmom)]
    moms = [tuple(m[i] for m in moms) for i in range(layout.num_buckets)]
    for step in range(eff + k):
        ph = step % eff
        gs = [jnp.asarray(b.numpy())
              for b in _packed_random(layout, rng, 0.1).buckets]
        recv = jnp.asarray(sched.recv_from(ph))
        ok = ref_exchange_ok(ring["t"], jnp.arange(DP), 5, drop)
        cons = (np.ones(layout.num_buckets, bool) if sub is None
                else sub.selected(ph - k))
        a = (alpha * ring["valid"][:, 0])[:, None]
        partners = [RQ.decode_wire(ring["slots"][0][i]) if cons[i] else None
                    for i in range(layout.num_buckets)]
        want_p, want_m = _ref_engine_update(name, ps, gs, moms, partners,
                                            [a] * layout.num_buckets,
                                            ref_layout)
        keys = ("m", "v") if name == "adamw" else ("mom",)
        state = {"step": ENGINE_STEP}
        for j, key in enumerate(keys):
            state[key] = PackedParams([_t(m[j]) for m in moms], layout)
        ring_t = {"slots": tuple(
            [None if x is None else
             {kk: _t(v) for kk, v in x.items()} if isinstance(x, dict)
             else _t(x) for x in slot] for slot in ring["slots"]),
            "valid": np.array(ring["valid"], np.float32), "t": int(ring["t"])}
        got_p, got_s, got_ring = update(
            PackedParams([_t(p) for p in ps], layout),
            PackedParams([_t(g) for g in gs], layout), ring_t, state, ph)
        _check_engine_step(name, got_p, got_s, want_p, want_m, ps, gs, moms)
        np.testing.assert_array_equal(
            got_ring["valid"], np.concatenate([np.asarray(ring["valid"])[:, 1:],
                                               np.asarray(ok)[:, None]], 1))
        # next step: the reference's state; the ring advanced as the
        # reference's engine does (RAW buckets encoded on the counter)
        sent = (np.ones(layout.num_buckets, bool) if sub is None
                else sub.selected(ph))
        outbox = []
        for i, p in enumerate(ps):
            if wire.is_default:
                outbox.append(p[recv])
            elif sent[i]:
                enc = RQ.encode_wire(p, wire_dtype, keys=RQ.wire_key(
                    ring["t"], jnp.arange(DP), i, 2))
                outbox.append(jax.tree.map(lambda e: e[recv], enc))
            else:
                outbox.append(RQ.zero_payload_like(p, wire_dtype))
        ring = {"slots": tuple(ring["slots"][1:]) + (tuple(outbox),),
                "valid": jnp.concatenate([ring["valid"][:, 1:],
                                          ok[:, None]], 1),
                "t": ring["t"] + 1}
        ps, moms = want_p, want_m


@pytest.mark.parametrize("name", ["adamw", "lars"])
@pytest.mark.parametrize("wire_dtype,subset", ENGINE_WIRES,
                         ids=["int8", "fp8", "bf16_sub3", "fp32"])
def test_fused_sync_engine_matches_composed_reference(name, wire_dtype,
                                                      subset):
    """Sync fused engine with adamw / lars on every wire at every phase of
    the wire's period: each sent bucket's partner is the pre-update bucket
    encoded on the folded phase, exchanged and decoded; an unsent bucket
    takes the pure local update."""
    alpha = 0.5
    layout = _five_bucket_layout()
    ref_layout = _ref_layout(layout)
    wire = Q.WireFormat(wire_dtype, subset, seed=2)
    sub = ref_subset(layout.num_buckets, subset)
    eff = 4 if sub is None else 4 * sub.period // np.gcd(4, sub.period)
    sched = build_schedule(DP)
    update = make_packed_fused_update(sched, layout, _engine_opt(name),
                                      alpha=alpha, wire=wire)
    rng = np.random.default_rng(22)
    ps = [jnp.asarray(b.numpy()) for b in _packed_random(layout, rng).buckets]
    nmom = 2 if name == "adamw" else 1
    moms = [tuple(jnp.abs(jnp.asarray(b.numpy())) * 1e-3 for b in
                  _packed_random(layout, rng).buckets) for _ in range(nmom)]
    moms = [tuple(m[i] for m in moms) for i in range(layout.num_buckets)]
    for ph in range(eff):
        gs = [jnp.asarray(b.numpy())
              for b in _packed_random(layout, rng, 0.1).buckets]
        recv = jnp.asarray(sched.recv_from(ph))
        sent = (np.ones(layout.num_buckets, bool) if sub is None
                else sub.selected(ph))
        partners = []
        for i, p in enumerate(ps):
            if not sent[i]:
                partners.append(None)
                continue
            enc = RQ.encode_wire(p, wire_dtype, keys=RQ.wire_key(
                ph, jnp.arange(DP), i, 2)) if wire_dtype != "fp32" else p
            partners.append(RQ.decode_wire(
                jax.tree.map(lambda e: e[recv], enc)))
        want_p, want_m = _ref_engine_update(name, ps, gs, moms, partners,
                                            [alpha] * layout.num_buckets,
                                            ref_layout)
        keys = ("m", "v") if name == "adamw" else ("mom",)
        state = {"step": ENGINE_STEP}
        for j, key in enumerate(keys):
            state[key] = PackedParams([_t(m[j]) for m in moms], layout)
        got_p, got_s = update(PackedParams([_t(p) for p in ps], layout),
                              PackedParams([_t(g) for g in gs], layout),
                              state, ph)
        assert got_s["step"] == ENGINE_STEP + 1
        _check_engine_step(name, got_p, got_s, want_p, want_m, ps, gs, moms)
        ps, moms = want_p, want_m


# ------------------------------------------------------------------ units

def _one_leaf(values, lead=(1,)):
    tree = {"w": torch.tensor(values, dtype=torch.float32)}
    layout = build_layout(tree)
    return PackedParams.pack(tree, layout, lead=lead), layout


def _fused_step(opt, params, grads, state):
    moms = tuple(state[k].buckets[0] for k in opt.fused_moments)
    opt.fused_update(0, params.buckets[0], grads.buckets[0], None, moms,
                     step=state["step"], alpha=0.0, layout=params.layout)
    return params


@pytest.mark.parametrize("path", ["tree", "fused"])
def test_adamw_first_step_unit(path):
    opt = adamw(1e-2, b1=0.9, b2=0.999)
    p, _ = _one_leaf([0.0])
    g, _ = _one_leaf([3.0])
    s = opt.init(p)
    p1 = opt.update(p, g, s)[0] if path == "tree" else _fused_step(opt, p, g,
                                                                   s)
    # bias-corrected first step == -lr * sign(g)
    np.testing.assert_allclose(p1.unpack()["w"].detach().numpy(), [[-1e-2]],
                               rtol=1e-4)
    assert not p1.buckets[0][0, 1:].any()  # the padding stays zero


@pytest.mark.parametrize("path", ["tree", "fused"])
def test_lars_trust_ratio_scaling(path):
    opt = lars(1.0, momentum=0.0, trust_coef=1e-3)
    p, _ = _one_leaf([2.0] * 4)
    g, _ = _one_leaf([1.0] * 4)
    s = opt.init(p)
    p1 = opt.update(p, g, s)[0] if path == "tree" else _fused_step(opt, p, g,
                                                                   s)
    # trust = 1e-3 * ||w||/||g|| = 1e-3 * 2 -> step = lr * trust * g
    np.testing.assert_allclose(p1.unpack()["w"].detach().numpy(),
                               np.full((1, 4), 2.0 - 2e-3), rtol=1e-5)


@pytest.mark.parametrize("path", ["tree", "fused"])
def test_lars_zero_grad_no_nan(path):
    opt = lars(0.1)
    p, _ = _one_leaf([1.0] * 3)
    g, _ = _one_leaf([0.0] * 3)
    s = opt.init(p)
    p1 = opt.update(p, g, s)[0] if path == "tree" else _fused_step(opt, p, g,
                                                                   s)
    assert torch.isfinite(p1.buckets[0]).all()


def test_optimizer_states_are_fp32():
    tree = _torch_tree(_odd_tree(), torch.bfloat16)
    params = PackedParams.pack(tree, build_layout(tree), lead=(2,))
    for opt, keys in ((adamw(0.1), ("m", "v")), (lars(0.1), ("mom",))):
        st = opt.init(params)
        assert opt.fused_moments == keys and st["step"] == 0
        for k in keys:
            assert all(b.dtype == torch.float32 and not b.any()
                       and b.shape == p.shape
                       for b, p in zip(st[k].buckets, params.buckets))


def test_lars_packed_matches_reference_leaf():
    """The port's packed tree-level lars reads per-LAYER norms through the
    unpack views: it matches the reference's per-leaf update on the same
    leaves (with their leading replica axis, which the norm spans) for 3
    steps, within 4 ulp (a whole-leaf sum in another order)."""
    tree = _odd_tree(lead=(4,))
    grads = {k: v * 0.1 + 0.01 for k, v in tree.items()}
    ropt = ref_lars(0.1, momentum=0.9, weight_decay=1e-4)
    opt = lars(0.1, momentum=0.9, weight_decay=1e-4)
    r_p = {k: jnp.asarray(v) for k, v in tree.items()}
    r_g = {k: jnp.asarray(v) for k, v in grads.items()}
    r_s = ropt.init(r_p)
    layout = build_layout(_torch_tree(tree, torch.float32), skip_leading=1)
    p = PackedParams.pack(_torch_tree(tree, torch.float32), layout)
    g = PackedParams.pack(_torch_tree(grads, torch.float32), layout)
    s = opt.init(p)
    for _ in range(3):
        r_p, r_s = ropt.update(r_p, r_g, r_s)
        p, s = opt.update(p, g, s)
        up, um = p.unpack(), s["mom"].unpack()
        for k in tree:
            _close(up[k], r_p[k], "float32", (), ulps=4)
            _close(um[k], r_s["mom"][k], "float32", (), ulps=4)


def _ref_cfg(d_model=64):
    from repro.configs import get_config as ref_get_config
    from repro.models import reduced as ref_reduced
    return dataclasses.replace(ref_reduced(ref_get_config("qwen3-0.6b"),
                                           d_model=d_model),
                               param_dtype="float32", compute_dtype="float32")


def _port_cfg(d_model=64):
    return dataclasses.replace(reduced(get_config("qwen3-0.6b"),
                                       d_model=d_model),
                               param_dtype="float32", compute_dtype="float32")


def test_lars_trains_packed_and_matches_reference_leaf_training():
    """End to end at dp=1: the port's packed lars (fused, the default)
    against the reference's per-leaf lars trainer, in process."""
    from repro.data import ShardedTokenDataset as RefDataset
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.specs import train_input_specs
    from repro.models import lm_init as ref_lm_init
    from repro.train import Trainer as RefTrainer
    from repro.train import init_train_state as ref_init_state
    from repro.train import make_distribution
    from repro.train import make_train_step_bundle as ref_bundle

    cfg = _ref_cfg()
    dist = make_distribution(make_smoke_mesh(1, 1), "replica")
    ropt = ref_lars(0.5, momentum=0.9)
    ss, sa, bs = train_input_specs(cfg, dist, 24, 4, ropt)
    bundle = ref_bundle(cfg, dist, ropt, state_shapes=ss, state_axes=sa,
                        batch_shapes=bs, protocol="gossip", remat=False,
                        gossip_packed=False)
    state, _ = ref_init_state(jax.random.key(0), cfg, dist, ropt,
                              packed=False, layout=bundle.layout)
    ds = RefDataset(vocab=cfg.vocab, seq_len=24, n_shards=1,
                    batch_per_shard=4, seed=0)
    want = [h["loss"] for h in RefTrainer(bundle, state, ds,
                                          log_every=0).run(4)]
    init = jax.tree.map(np.asarray, ref_lm_init(jax.random.key(0), cfg)[0])

    pcfg = _port_cfg()
    opt = lars(0.5, momentum=0.9)
    pb = make_train_step_bundle(pcfg, opt, dp=1, gossip_packed=True,
                                device="cpu")
    assert pb.fused
    pst = init_train_state(pcfg, opt, dp=1, packed=True, layout=pb.layout,
                           params=params_from_numpy(init, layout=pb.layout,
                                                    lead=(1,), device="cpu"),
                           device="cpu")
    pds = ShardedTokenDataset(vocab=pcfg.vocab, seq_len=24, n_shards=1,
                              batch_per_shard=4, seed=0)
    got = [h["loss"] for h in Trainer(pb, pst, pds, log_every=0).run(4)]
    np.testing.assert_allclose(got, want, **TOL)


def test_bucket_wrappers_take_payloads_and_count_no_cpu_launch():
    """The bucket wrappers take a raw partner or a {"q", "s"} payload; on
    CPU tensors they run the plain versions and count no launch."""
    counters = (fused_update.adamw_launches,
                fused_update.adamw_scaled_launches, fused_update.lars_launches)
    for c in counters:
        c.reset()
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.normal(size=(2, 256)).astype(np.float32))
    enc = {"q": torch.ones(2, 256, dtype=torch.int8),
           "s": torch.full((2, 2), 0.5)}
    dec = torch.full((2, 256), 0.5)
    outs = []
    for partner in (enc, dec):
        q, m, v = p.clone(), torch.zeros_like(p), torch.zeros_like(p)
        fused_adamw_bucket(q, p * 0.1, partner, m, v, lr=0.01, c1=0.1,
                           c2=0.05, alpha=0.5)
        r, mom = p.clone(), torch.zeros_like(p)
        fused_lars_bucket(r, p * 0.1, partner, mom, torch.ones(4), lr=0.1,
                          alpha=0.5)
        outs.append((q, m, v, r, mom))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert all(c.count == 0 for c in counters)
    with pytest.raises(ValueError, match="LANE"):
        fused_adamw_bucket(torch.ones(2, 100), torch.ones(2, 100), None,
                           torch.zeros(2, 100), torch.zeros(2, 100), lr=0.1,
                           c1=0.1, c2=0.1)


# ------------------------------------------------------- the slice as a whole

D_MODEL, SEQ, GLOBAL_B, STEPS, EVERY, DP = 64, 16, 8, 4, 2, 4
K, DROP, BUCKET_BYTES = 2, 0.2, 96 << 10
ADAMW_LR, LARS_LR = 1e-3, 0.1
CASES = [  # (optimizer, protocol, wire, subset, fused)
    (o, proto, wire, sub, fused)
    for o in ("adamw", "lars")
    for proto, wire, sub, fused in (("gossip", "fp32", 1.0, True),
                                    ("gossip", "fp32", 1.0, False),
                                    ("gossip_async", "int8", 0.5, True),
                                    ("gossip_async", "fp32", 1.0, False))]
CASE_IDS = [f"{o}-{'sync' if p == 'gossip' else 'async'}-{w}-"
            f"{'fused' if f else 'unfused'}" for o, p, w, _, f in CASES]

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={dp}"
import repro
import dataclasses, functools
import jax, numpy as np
import repro.train.step as S
from repro.configs import get_config
from repro.data import ShardedTokenDataset
from repro.launch.mesh import make_smoke_mesh
from repro.launch.specs import train_input_specs
from repro.models import lm_init, reduced
from repro.optim import adamw, lars, step_decay
from repro.train import (Trainer, init_train_state, make_distribution,
                         make_train_step_bundle)

S.build_layout = functools.partial(S.build_layout,
                                   target_bucket_bytes={bucket_bytes})
cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b"), d_model={d}),
                          param_dtype="float32", compute_dtype="float32")
dist = make_distribution(make_smoke_mesh({dp}, 1), "replica")
opts = {{"adamw": adamw(step_decay({adamw_lr}, 0.1, {every}),
                        weight_decay=0.01),
         "lars": lars(step_decay({lars_lr}, 0.1, {every}), momentum=0.9,
                      weight_decay=1e-4)}}
out = {{"init": jax.tree.map(np.asarray, lm_init(jax.random.key(0), cfg)[0])}}
for name, proto, wire, subset, fused in {cases}:
    opt = opts[name]
    ss, sa, bs = train_input_specs(cfg, dist, {seq}, {gb}, opt)
    bundle = make_train_step_bundle(
        cfg, dist, opt, state_shapes=ss, state_axes=sa, batch_shapes=bs,
        protocol=proto, staleness={k}, drop_rate={drop}, wire_dtype=wire,
        gossip_subset=subset, remat=False, gossip_packed=True,
        fused_update=fused)
    assert bundle.fused == fused and bundle.layout.num_buckets == 5
    state, _ = init_train_state(jax.random.key(0), cfg, dist, opt,
                                packed=True, layout=bundle.layout,
                                inbox=bundle.protocol.staleness,
                                wire=bundle.wire)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len={seq}, n_shards={dp},
                             batch_per_shard={gb} // {dp}, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run({steps})
    out[(name, proto, wire, fused)] = {{
        "loss": [h["loss"] for h in hist],
        "buckets": [np.asarray(b) for b in tr.state["params"].buckets],
    }}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    script = _REFERENCE.format(dp=DP, d=D_MODEL, adamw_lr=ADAMW_LR,
                               lars_lr=LARS_LR, every=EVERY, seq=SEQ,
                               gb=GLOBAL_B, steps=STEPS, k=K, drop=DROP,
                               cases=CASES, bucket_bytes=BUCKET_BYTES)
    r = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    with open(out, "rb") as f:  # written by the subprocess above
        return pickle.load(f)


def _port_run(monkeypatch, init_tree, name, proto, wire, subset, fused):
    import repro_torch.train.step as step_mod
    monkeypatch.setattr(step_mod, "build_layout", functools.partial(
        step_mod.build_layout, target_bucket_bytes=BUCKET_BYTES))
    cfg = _port_cfg(D_MODEL)
    opt = (adamw(step_decay(ADAMW_LR, 0.1, EVERY), weight_decay=0.01)
           if name == "adamw" else
           lars(step_decay(LARS_LR, 0.1, EVERY), momentum=0.9,
                weight_decay=1e-4))
    bundle = make_train_step_bundle(
        cfg, opt, dp=DP, protocol=proto, staleness=K, drop_rate=DROP,
        wire_dtype=wire, gossip_subset=subset, gossip_packed=True,
        fused_update=fused, device="cpu")
    assert bundle.fused == fused and bundle.layout.num_buckets == 5
    params = params_from_numpy(init_tree, layout=bundle.layout, lead=(DP,),
                               device="cpu")
    state = init_train_state(cfg, opt, dp=DP, packed=True,
                             layout=bundle.layout, params=params,
                             device="cpu", inbox=bundle.protocol.staleness,
                             wire=bundle.wire)
    ds = ShardedTokenDataset(vocab=cfg.vocab, seq_len=SEQ, n_shards=DP,
                             batch_per_shard=GLOBAL_B // DP, seed=0)
    tr = Trainer(bundle, state, ds, log_every=0)
    hist = tr.run(STEPS)
    return [h["loss"] for h in hist], tr.state


def _code_step(ref: np.ndarray, wire: str) -> np.ndarray:
    """0.5 (alpha) times one code step of each element's tile: the most a
    flipped wire code moves a mixed element."""
    if wire == "fp32":
        return np.zeros_like(ref)
    tiles = ref.reshape(ref.shape[:-1] + (-1, 128))
    amax = np.abs(tiles).max(-1, keepdims=True)
    return (0.5 * amax / 127.0 + 0 * tiles).reshape(ref.shape)


@pytest.mark.parametrize("name,proto,wire,subset,fused", CASES, ids=CASE_IDS)
def test_dp4_trajectory_matches_reference(reference_runs, monkeypatch, name,
                                          proto, wire, subset, fused):
    want = reference_runs[(name, proto, wire, fused)]
    losses, state = _port_run(monkeypatch, reference_runs["init"], name,
                              proto, wire, subset, fused)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], **TOL)
    sign_flip = 2 * ADAMW_LR * STEPS if name == "adamw" else 0.0
    flips = total = 0
    for got, ref in zip(state["params"].buckets, want["buckets"]):
        got = got.detach().numpy()
        bad = ~np.isclose(got, ref, **TOL)
        bound = _code_step(ref, wire) * (1 + 1e-3) + sign_flip + TOL["atol"]
        assert (np.abs(got - ref)[bad] <= bound[bad]).all()
        flips += int(bad.sum())
        total += got.size
    print(f"{name} {proto} {wire} fused={fused}: {flips} of {total} "
          f"elements outside rtol 2e-4 (code step or Adam sign flip)")
    assert flips <= 1e-3 * total, (flips, total)
