"""The AI21-Jamba family of the benchmark against the program it judges, on
the CPU: the reference's leaves and flat layout are the program's at toy
size and at Jamba2-3B's full size; the configuration file states the
port's own ``jamba2-3b``; at toy widths in float32 (a hybrid of both
mixers, the norms on dt, B and C, one KV head, no positions) the
reference's loss and gradients are the program's, and its first training
steps follow the program's to rounding; the doubling scan is the
sequential one; the counts of weights and FLOPs are the program's; a
toy run with the timed path broken, or the fp8 control in the program's
place, is not correct; the readers of the mixers by kind split
``repro.mixer`` exactly; and a real profile holds each mixer's kind range
inside ``repro.mixer``.
"""
import dataclasses
import json
import math
import time
import types

import numpy as np
import pytest
import torch

from portbench import compare, mixer_kinds, toy, traffic, weights
from portbench import spans as S
from portbench.reference import jamba, mamba
from portbench.reference.train import family, readings
from portbench.run import load_cell, reader, run_cell
from portbench.test_portbench_faults import FAULTS
from portbench.trace import Trace

CELL = "jamba2-3b-sync-sgd-4k"
# the Mamba cell, which runs the same traffic file: its limits are those of
# a model whose bf16 readings are not ruled by single-ulp flips
TIGHT = "mamba7b-sync-sgd-4k"
# two periods of a mamba and an attention layer at toy widths: one KV
# head for 4 query heads
TOY = dict(num_hidden_layers=4, attn_layer_period=2, attn_layer_offset=1,
           hidden_size=64, num_attention_heads=4, num_key_value_heads=1,
           intermediate_size=128, mamba_d_state=8, mamba_dt_rank=4,
           vocab_size=256, vocab=256)
READERS = ("ssm_mixer_ms_per_step", "attn_mixer_ms_per_step")


def full_config():
    return json.loads((toy.ROOT / "portbench" / "configs" /
                       "jamba2-3b.json").read_text())


def toy_cell(limits_of=CELL, **kw):
    """The Jamba cell at toy widths in float32, under the limits of the
    cell ``limits_of``."""
    bench, wl, cfg, job, _ = load_cell(toy.ROOT, CELL)
    limits = load_cell(toy.ROOT, limits_of)[4]
    cfg = dict(cfg, **dict(TOY, **kw), param_dtype="float32",
               compute_dtype="float32")
    job = dict(job, seq_len=32, ring=6, ssm_scan_chunk=8)
    return bench, wl, cfg, job, limits


def _names(tree):
    """The program's leaf paths in the reference's names: the one
    segment's index dropped, the pattern position kept."""
    from repro_torch.tree import tree_paths
    out = []
    for p in tree_paths(tree):
        if p[0] == "layers":
            assert p[1] == 0, p          # one segment
            p = ("layers",) + p[2:]
        out.append(".".join(str(k) for k in p))
    return out


@pytest.mark.parametrize("size", ["toy", "full"])
def test_jamba_leaves_and_layout_match_program(size):
    from repro_torch.core import build_layout
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    from portbench.program import program_config
    from portbench.reference import gossip as G
    cfg = toy_cell()[2] if size == "toy" else full_config()
    specs = family(cfg).leaf_specs(cfg)
    tree = lm_specs(program_config(cfg))
    want = tree_flatten(tree)[0]
    assert [s[0] for s in specs] == _names(tree)
    assert [tuple(s[1]) for s in specs] == [tuple(w.shape) for w in want]
    assert [s[2] for s in specs] == [w.init for w in want]
    assert np.allclose([s[3] for s in specs], [w.scale for w in want])
    lay = build_layout(tree)
    item = 4 if cfg["param_dtype"] == "float32" else 2
    slots, sizes = G.flat_layout([int(np.prod(s[1])) for s in specs], item)
    assert list(lay.bucket_sizes) == sizes
    assert [(s.bucket, s.offset) for s in lay.slots] == slots
    if size == "full":
        # 14 layers a period (attention at position 7), stacked twice
        assert jamba.period(jamba.kinds(cfg)) == 14
        assert sum(math.prod(s[1]) for s in specs) == 3_029_337_472


def test_jamba_config_is_the_programs():
    from repro_torch.configs import get_config
    from portbench.program import program_config
    cfg = full_config()
    want = get_config("jamba2-3b")
    got = program_config(cfg)
    assert dataclasses.replace(got, source=want.source) == want
    assert [i for i, b in enumerate(got.blocks) if b.kind == "attn"] == [7, 21]
    bad = dict(cfg, num_experts=16)
    with pytest.raises(ValueError, match="num_experts"):
        program_config(bad)


def test_jamba_counts_are_the_programs_weights():
    """``matmul_params`` is the program's weights that multiply
    activations (the conv, biases, norms, ``A_log`` and ``D`` do not)."""
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    from portbench.models import jamba as M
    from portbench.program import program_config
    cfg = full_config()
    names = _names(lm_specs(program_config(cfg)))
    leaves = tree_flatten(lm_specs(program_config(cfg)))[0]
    products = ("proj", "wq", "wk", "wv", "wo", "w_gate", "w_in", "w_out",
                "embed")
    want = sum(math.prod(w.shape) for n, w in zip(names, leaves)
               if n.split(".")[-1].endswith(products))
    assert M.matmul_params(cfg) == want
    assert M.mixer_flops_per_token(cfg, 4096) == (
        12 * 2 * 20 * 128 * 4096 + 6 * 26 * 5120 * 16)


def test_jamba_model_loss_matches_program_fp32():
    from repro_torch.models import lm_specs
    from repro_torch.train.loss import make_loss_fn
    from repro_torch.tree import tree_flatten
    from portbench.program import program_config
    from portbench.reference.precision import matmul_fn
    _, _, cfg, job, _ = toy_cell()
    specs = family(cfg).leaf_specs(cfg)
    leaves = weights.make(specs, 5, "cpu", torch.float32)
    # norm scales away from one, so that a misplaced scale shows
    gen = torch.Generator().manual_seed(1)
    for s, x in zip(specs, leaves):
        if s[2] == "ones":
            x.copy_(1 + 0.5 * torch.rand(x.shape, generator=gen))
    toks = traffic.make_ring(job, cfg["vocab"], 5, "cpu")[0, :1]
    pcfg = program_config(cfg)
    td = tree_flatten(lm_specs(pcfg))[1]
    pl = [x.unsqueeze(0).clone().requires_grad_(True) for x in leaves]
    loss_p = make_loss_fn(pcfg, remat=True)(
        td.unflatten(pl), {"tokens": toks})[0].sum()
    loss_p.backward()
    w = {s[0]: x.clone().requires_grad_(True) for s, x in zip(specs, leaves)}
    loss_r = family(cfg).loss(w, toks[0], cfg, matmul_fn("fp32"))
    loss_r.backward()
    assert abs(loss_p.item() - loss_r.item()) < 1e-5
    for s, x in zip(specs, pl):
        g = w[s[0]].grad
        assert torch.allclose(x.grad[0], g, rtol=1e-3, atol=1e-6), s[0]


def test_jamba_reference_steps_follow_program_fp32():
    """In float32 the program's first steps and the reference's differ by
    rounding alone."""
    from portbench.kinds.train import program_readings
    from portbench.program import Program
    _, _, cfg, job, _ = toy_cell()
    specs = family(cfg).leaf_specs(cfg)
    seed = 2 ** 31 + 3
    ring = traffic.make_ring(job, cfg["vocab"], seed, "cpu")
    leaves = weights.make(specs, seed, "cpu", torch.float32)
    prog = Program(cfg, job, leaves, seed=seed, device="cpu")
    got = program_readings(prog, ring, specs, cfg, job, seed, "cpu",
                           torch.float32)
    ref = readings(cfg, job, leaves, ring[:job["checked_steps"]], seed=seed)
    gaps = compare.gaps(dict(got, grad_norms=ref["grad_norms"]), ref)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps


def test_jamba_toy_cell_run_is_correct():
    cell = toy_cell()
    res, _ = run_cell(CELL, 2 ** 31 + 17, 0.2, False, device="cpu",
                      t_start=time.time(), cell=cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("S", [1, 2, 7, 33])
def test_doubling_scan_is_the_sequential_scan(S):
    gen = torch.Generator().manual_seed(S)
    a = torch.rand(2, S, 3, 2, generator=gen, dtype=torch.float64)
    b = torch.randn(2, S, 3, 2, generator=gen, dtype=torch.float64)
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    h1 = jamba._DoublingScan.apply(a1, b1)
    h2 = mamba._Scan.apply(a2, b2)
    assert torch.allclose(h1, h2, rtol=1e-12, atol=1e-12)
    dh = torch.randn(h1.shape, generator=gen, dtype=torch.float64)
    (h1 * dh).sum().backward()
    (h2 * dh).sum().backward()
    assert torch.allclose(a1.grad, a2.grad, rtol=1e-12, atol=1e-12)
    assert torch.allclose(b1.grad, b2.grad, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(jamba._DoublingScan.apply,
                                    (a.requires_grad_(), b.requires_grad_()))


# ------------------------------------- the faults and the control in fp32


@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange"])
def test_jamba_toy_run_with_a_broken_timed_path_is_not_correct(
        monkeypatch, fault):
    """In float32 the Jamba family's comparison sees each planted fault
    under the Mamba cell's limits; the Jamba cell's own, set in bf16 at
    full size, do not see the exchange left out (one-ulp flips of the
    norm scales, PERF.md)."""
    FAULTS[fault](monkeypatch)
    res, _ = run_cell(CELL, 2 ** 31 + 17, 0.2, False, device="cpu",
                      t_start=time.time(), cell=toy_cell(TIGHT))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_jamba_cell_limits_fail_a_broken_timed_path(monkeypatch, fault):
    """The cell's own limits fail a state returned unchanged (its
    momentum after the first step is zero, so ``grad_gap`` reads 1) and
    half the batch, by the first gradient."""
    FAULTS[fault](monkeypatch)
    res, _ = run_cell(CELL, 2 ** 31 + 17, 0.2, False, device="cpu",
                      t_start=time.time(), cell=toy_cell())
    assert not res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    if fault == "unchanged":
        assert checks["grad_gap"]["value"] == 1.0


def test_jamba_toy_control_is_not_correct():
    """The reference with fp8 products, put in the program's place, fails
    the cell's limits on both seeds."""
    _, _, cfg, job, limits = toy_cell()
    specs = family(cfg).leaf_specs(cfg)
    fails = 0
    for seed in (2 ** 31 + 17, 2 ** 31 + 18):
        ring = traffic.make_ring(job, cfg["vocab"], seed, "cpu")[:3]
        leaves = weights.make(specs, seed, "cpu", torch.float32)
        ref = readings(cfg, job, leaves, ring, seed=seed)
        ctl = readings(cfg, job, leaves, ring, seed=seed, precision="fp8")
        ok, _ = compare.judge(
            compare.gaps(dict(ctl, grad_norms=ref["grad_norms"]), ref), limits)
        fails += not ok
    assert fails == 2


# ------------------------------------------------------ the mixers by kind

E = S.Event
WINDOW = (0, 1000)


def _events():
    """A step with a Mamba mixer (its forward, then its backward node) and
    an attention mixer, each inside ``repro.mixer`` and its kind's range,
    and an MLP op outside both."""
    node = S.NODE + "MulBackward0"
    host = [E(S.STEP, 0, 900, 1), E(S.FORWARD, 0, 300, 1),
            E(S.MIXER, 10, 100, 1), E(S.MIXER + ".mamba", 11, 99, 1),
            E("aten::mul", 20, 30, 1, seq=1),
            E(S.MIXER, 110, 200, 1), E(S.MIXER + ".attn", 111, 199, 1),
            E("aten::bmm", 120, 130, 1, seq=2),
            E("aten::mm", 210, 220, 1, seq=3),
            E(S.BACKWARD, 300, 900, 1),
            E(node, 400, 500, 9, seq=1, fwd_thread=1),
            E(node, 600, 700, 9, seq=3, fwd_thread=1)]
    calls = [E("cudaLaunchKernel", t, t + 1, th, corr)
             for corr, t, th in ((1, 25, 1), (2, 125, 1), (3, 215, 1),
                                 (4, 450, 9), (5, 650, 9))]
    device = [E("k", s, s + n, corr=c) for c, s, n in
              ((1, 30, 10), (2, 130, 20), (3, 220, 40), (4, 460, 30),
               (5, 660, 50))]
    return host, calls, device


def test_the_kinds_split_the_mixer():
    host, calls, device = _events()
    whole = S.summarize_events(host, calls, device, WINDOW, 1)
    got = mixer_kinds.split(host, calls, device, WINDOW, 1)
    assert got == pytest.approx({"mamba": 40e-6, "attn": 20e-6})
    assert got["mamba"] + got["attn"] == pytest.approx(
        whole.ms_per_step(whole.device_s, S.MIXER))
    # a model of one kind: the other reads nothing
    only = [e for e in host if e.name != S.MIXER + ".attn"]
    assert mixer_kinds.split(only, calls, device, WINDOW, 1)["attn"] is None


def _ctx(**kw):
    bench, wl, cfg, job, limits = load_cell(toy.ROOT, CELL)
    tr = Trace(steps=2, window_s=1.0, busy_s=0.0, device_events=0,
               kernels={}, gaps=[])
    return types.SimpleNamespace(**dict(dict(
        cfg=cfg, job=job, rows=traffic.replicas(job), trace=tr,
        program=None, steps=[5, 6]), **kw))


@pytest.mark.parametrize("name", READERS)
def test_the_kind_readers_read_nothing_without_device_events(name):
    ctx = _ctx()
    assert reader(toy.ROOT, name)(ctx) is None
    assert ctx.mixer_kinds is None


def test_the_kind_readers_read_an_agreeing_session_once(monkeypatch):
    """A session off the harness's trace is traced again; the one that
    agrees is read for both kinds, once a run; none agreeing reads
    nothing."""
    host, calls, device = _events()
    taken = []

    def trace_steps(prog, job, cfg, rows, k):
        taken.append(k)
        return None, {}
    monkeypatch.setattr(S, "trace_steps", trace_steps)
    monkeypatch.setattr(S, "events_of", lambda prof: (host, calls, device,
                                                      WINDOW))
    offs = iter([0.5, 0.0])
    monkeypatch.setattr(S, "_off", lambda sp, tr: next(offs))
    prog = types.SimpleNamespace(bundle=types.SimpleNamespace(group=None))
    ctx = _ctx(program=prog, steps=[0],
               trace=dataclasses.replace(_ctx().trace, device_events=5,
                                         busy_s=0.1, steps=1))
    got = {n: reader(toy.ROOT, n)(ctx) for n in READERS}
    assert got == pytest.approx({"ssm_mixer_ms_per_step": 40e-6,
                                 "attn_mixer_ms_per_step": 20e-6})
    assert taken == [1, 1]
    monkeypatch.setattr(S, "_off", lambda sp, tr: 1.0)
    ctx = _ctx(program=prog, steps=[0], trace=ctx.trace)
    assert all(reader(toy.ROOT, n)(ctx) is None for n in READERS)
    assert len(taken) == 2 + S.TRIES



def test_a_toy_cells_profile_splits_by_kind():
    """A real CPU profile of the toy hybrid: each kind's range sits inside
    a ``repro.mixer`` range, as many of each as its layers' forwards and
    recomputes, and the backward nodes of a kind's ops are its own (the
    scan's adjoint the Mamba mixer's, a softmax's the attention's)."""
    from portbench.program import Program
    bench, wl, cfg, job, limits = toy_cell()
    dev = torch.device("cpu")
    prog = Program(cfg, job, weights.make(family(cfg).leaf_specs(cfg), 5,
                                          dev, torch.float32),
                   seed=5, device=dev)
    prof, _ = S.trace_steps(prog, job, cfg, traffic.replicas(job), 2)
    host, calls, device, win = S.events_of(prof)
    mixers = [e for e in host if e.name == S.MIXER]
    for kind, name in mixer_kinds.KINDS.items():
        ranges = [e for e in host if e.name == name]
        assert ranges, kind
        assert all(any(m.start <= e.start and e.end <= m.end
                       for m in mixers) for e in ranges), kind
        nodes = {e.name[len(S.NODE):]
                 for e in S.mixer_nodes(mixer_kinds.as_mixer(host, name))}
        assert ("SoftmaxBackward0" in nodes) == (kind == "attn"), kind
        assert ("LogaddexpBackward0" in nodes) == (kind == "mamba"), kind
    assert len(mixers) == sum(sum(e.name == n for e in host)
                              for n in mixer_kinds.KINDS.values())
