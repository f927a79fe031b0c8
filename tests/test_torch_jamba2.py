"""The port's AI21-Jamba2-3B path on the CPU, where the reference package
has no counterpart (``PORT_ONLY``):

* ``SSMSpec.bcdt_norm``: the norms on dt, B and C, weighted and
  weightless, against the formula written out; the mixer's leaves gain
  the three scales only when weighted, and with the field at None the
  olmo-1b and falcon-mamba trees keep their leaves;
* remat by layer: on Jamba's period-14 pattern the loss and gradients are
  bit-equal with remat off, on and "dots", and ``checkpoint`` is called
  once a layer; on period-1 olmo and falcon-mamba it is called once a
  layer with that layer's weight views, the calls of one region a repeat;
* serving: a Jamba2-3B-shaped toy's prefill then decode gives the
  logits of its full forward;
* the config: attention at layers 7 and 21, one segment of 14 layers
  twice, 3.03 B parameters, named by ``get_config`` and the launcher.

Everything is fp32; tolerances: the norm formula rtol 1e-6 (the same ops
in the same order up to the mean's reduction), serving rtol = atol = 1e-4
(prefill's and decode's scans combine in other orders than the
associative scan of the full forward).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_archs, get_config, list_archs  # noqa: E402
from repro_torch.models import lm_apply, lm_init, lm_specs  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.config import (AttnSpec, BlockSpec,  # noqa: E402
                                       SSMSpec)
from repro_torch.models.layers import draw  # noqa: E402
from repro_torch.models.transformer import (lm_cache_init,  # noqa: E402
                                            lm_decode, lm_prefill)
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map, tree_paths  # noqa: E402

REMATS = {"off": dict(remat=False), "on": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}


@pytest.fixture(autouse=True)
def small():
    """One intra-op thread and deterministic algorithms (the CPU embedding
    gather's backward adds in no fixed order otherwise)."""
    was = (torch.get_num_threads(),
           torch.are_deterministic_algorithms_enabled())
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.set_num_threads(was[0])
    torch.use_deterministic_algorithms(was[1])


def _toy(n_layers=4, period=2, offset=1, d=32):
    """Jamba2-3B's blocks at toy widths: NoPE attention over one KV head
    where ``i % period == offset``, Mamba-1 with weighted norms elsewhere,
    a SwiGLU MLP on every layer; fp32."""
    attn = AttnSpec(n_heads=4, n_kv_heads=1, head_dim=d // 4, rope_frac=0.0)
    ssm = SSMSpec(d_state=4, d_conv=4, expand=2, dt_rank=3,
                  bcdt_norm="weighted")
    blocks = tuple(BlockSpec(kind="attn", attn=attn, d_ff=2 * d)
                   if i % period == offset else
                   BlockSpec(kind="mamba", ssm=ssm, d_ff=2 * d)
                   for i in range(n_layers))
    return dataclasses.replace(get_config("jamba2-3b"), d_model=d, vocab=64,
                               blocks=blocks, max_seq=64,
                               param_dtype="float32", compute_dtype="float32")


def _params(cfg, seed=0, dp=1):
    """Weights with a replica axis, norm scales drawn away from one."""
    p = lm_init(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    p = tree_map(lambda x: (x + 0.5 * torch.rand(x.shape, generator=gen)
                            if bool((x == 1).all()) else x), p)
    return tree_map(lambda x: x.unsqueeze(0).expand(
        (dp,) + tuple(x.shape)).clone(), p)


# ------------------------------------------------------------ the norms

@pytest.mark.parametrize("form", ["weighted", "weightless"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bcdt_norms_are_the_written_out_formula(form, dtype):
    spec = SSMSpec(d_state=4, d_conv=4, expand=2, dt_rank=3, bcdt_norm=form)
    specs, td = tree_flatten(M.mamba_init(8, spec, dtype))
    gen = torch.Generator().manual_seed(3)
    p = td.unflatten([draw(s, gen, "cpu").unsqueeze(0).expand(
        (2,) + s.shape).clone() for s in specs])
    for k in ("dt_norm", "b_norm", "c_norm"):
        if k in p:
            p[k] = (1 + torch.rand(p[k].shape, generator=gen)).to(dtype)
    x = torch.randn(2, 1, 5, 16, generator=gen).to(dtype)
    dA, dBx, C = M._ssm_inputs(p, spec, x, 3)

    def rms(v, w):
        vf = v.float()
        y = vf * torch.rsqrt((vf * vf).mean(-1, keepdim=True) + 1e-6)
        if w is not None:
            y = y * w[:, None, None].float()
        return y.to(dtype)

    dbc = torch.bmm(x.reshape(2, -1, 16), p["x_proj"]).view(2, 1, 5, 11)
    w = (lambda k: p[k]) if form == "weighted" else (lambda k: None)
    dt_low = rms(dbc[..., :3], w("dt_norm"))
    Bm, Cm = rms(dbc[..., 3:7], w("b_norm")), rms(dbc[..., 7:], w("c_norm"))
    dt = torch.logaddexp(torch.bmm(dt_low.reshape(2, -1, 3), p["dt_proj"])
                         .view(2, 1, 5, 16) + p["dt_bias"][:, None, None],
                         torch.zeros((), dtype=dtype))
    A = -torch.exp(p["A_log"].float())
    tol = dict(rtol=1e-6, atol=0) if dtype == torch.float32 else dict(
        rtol=0, atol=0)
    torch.testing.assert_close(C, Cm, **tol)
    torch.testing.assert_close(
        dA, (dt[..., None].float() * A[:, None, None]).exp(), **tol)
    torch.testing.assert_close(
        dBx, (dt * x)[..., None].float() * Bm[..., None, :].float(), **tol)


def test_bcdt_norm_leaves():
    base = {"A_log", "D", "conv_b", "conv_w", "dt_bias", "dt_proj",
            "in_proj", "out_proj", "x_proj"}
    for form in (None, "weightless"):
        p = M.mamba_init(8, SSMSpec(dt_rank=3, bcdt_norm=form))
        assert set(p) == base, form
    p = M.mamba_init(8, SSMSpec(d_state=4, dt_rank=3, bcdt_norm="weighted"))
    assert set(p) == base | {"dt_norm", "b_norm", "c_norm"}
    assert [(p[k].shape, p[k].init) for k in ("dt_norm", "b_norm", "c_norm")
            ] == [((3,), "ones"), ((4,), "ones"), ((4,), "ones")]
    with pytest.raises(ValueError, match="bcdt_norm"):
        M.mamba_init(8, SSMSpec(bcdt_norm="layer"))
    # the field's default leaves the reference's configs as they were
    for arch in ("olmo-1b", "falcon-mamba-7b", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        assert all(b.ssm.bcdt_norm is None for b in cfg.blocks
                   if b.ssm is not None)
        assert not any(str(k).endswith("_norm") and "mixer" in p
                       for p in tree_paths(lm_specs(cfg)) for k in p[-1:])


# ---------------------------------------------------------- remat by layer

def _counted(monkeypatch):
    """``blocks.checkpoint`` wrapped to record each call's weight args."""
    calls = []
    real = B.checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(args[4:])
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(B, "checkpoint", counting)
    return calls


def _loss_and_grads(cfg, params, toks, **kw):
    leaves, td = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, _ = make_loss_fn(cfg, **kw)(td.unflatten(leaves), {"tokens": toks})
    loss.sum().backward()
    return loss.detach(), [x.grad for x in leaves]


def test_remat_by_layer_on_a_period_14_hybrid(monkeypatch):
    cfg = _toy(n_layers=28, period=14, offset=7, d=16)
    segs = B.segments_of(cfg.blocks)
    assert [(len(p), R) for p, R in segs] == [(14, 2)]
    params = _params(cfg)
    toks = torch.randint(0, cfg.vocab, (1, 2, 9),
                         generator=torch.Generator().manual_seed(0))
    want_loss, want = _loss_and_grads(cfg, params, toks)
    for name, remat in REMATS.items():
        calls = _counted(monkeypatch)
        loss, grads = _loss_and_grads(cfg, params, toks, **remat)
        assert torch.equal(loss, want_loss), name
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), name
        assert len(calls) == (28 if remat["remat"] else 0), name
        monkeypatch.undo()


@pytest.mark.parametrize("arch", ["olmo-1b", "falcon-mamba-7b"])
def test_remat_of_a_period_1_stack_is_one_region_a_layer(arch, monkeypatch):
    """For a pattern of one block the regions are those of one repeat:
    ``n_layers`` calls, call r given layer r's views of every leaf of the
    stacked block in leaf order."""
    from repro_torch.models import reduced
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=3,
                                      d_model=32),
                              param_dtype="float32", compute_dtype="float32")
    params = _params(cfg)
    toks = torch.randint(0, cfg.vocab, (1, 2, 9),
                         generator=torch.Generator().manual_seed(1))
    calls = _counted(monkeypatch)
    _loss_and_grads(cfg, params, toks, remat=True)
    stacked = tree_flatten(params["layers"][0][0])[0]
    assert len(calls) == 3
    for r, ws in enumerate(calls):
        assert len(ws) == len(stacked)
        assert all(torch.equal(w, s[:, r]) for w, s in zip(ws, stacked))


# ---------------------------------------------------------------- serving

def test_prefill_then_decode_is_the_full_forward():
    cfg = _toy()
    params = _params(cfg, seed=4)
    one = tree_map(lambda x: x[0], params)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    with torch.no_grad():
        full, _ = lm_apply(params, cfg, toks[None])
    caches = lm_cache_init(cfg, 2, 16, device="cpu")
    S0 = 7
    logits, caches = lm_prefill(one, cfg, toks[:, :S0], caches)
    torch.testing.assert_close(logits, full[0, :, S0 - 1], rtol=1e-4,
                               atol=1e-4)
    for pos in range(S0, toks.shape[1]):
        logits, caches = lm_decode(one, cfg, toks[:, pos], caches, pos)
        torch.testing.assert_close(logits, full[0, :, pos], rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------- config

def test_jamba2_3b_config():
    from repro_torch.launch.train import parse_args
    cfg = get_config("jamba2-3b")
    assert "jamba2-3b" in all_archs() and "jamba2-3b" not in list_archs()
    assert [i for i, b in enumerate(cfg.blocks) if b.kind == "attn"] == [7, 21]
    assert cfg.blocks[7].attn == AttnSpec(n_heads=20, n_kv_heads=1,
                                          head_dim=128, rope_frac=0.0)
    assert all(b.d_ff == 8192 and b.moe is None for b in cfg.blocks)
    assert {b.ssm for b in cfg.blocks if b.kind == "mamba"} == {SSMSpec(
        d_state=16, d_conv=4, expand=2, dt_rank=160, bcdt_norm="weighted")}
    assert [(len(p), R) for p, R in B.segments_of(cfg.blocks)] == [(14, 2)]
    n = sum(math.prod(s.shape) for s in tree_flatten(lm_specs(cfg))[0])
    assert n == 3_029_337_472
    assert parse_args(["--arch", "jamba2-3b"]).arch == "jamba2-3b"
    with pytest.raises(KeyError):
        get_config("jamba2-7b")
