"""The benchmark's plain reference against the program it judges, on the
CPU at toy widths: its frozen copies of the schedule, the bucket layout,
the subset and the int8 wire equal the program's bit for bit, its model
losses and gradients equal the program's in float32, and its training
steps follow the program's (sync and int8 async) in float32 to rounding.
"""
import numpy as np
import pytest
import torch

from portbench import toy
from portbench.reference import dense, gossip as G, mamba
from portbench.reference.train import family, readings


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_portbench_schedule_matches_program(p, seed):
    from repro_torch.core.topology import build_schedule
    want = build_schedule(p, "dissemination", num_rotations=2, seed=seed)
    got = G.perms("dissemination", p, 2, seed)
    assert np.array_equal(got, want.perms)
    for t in range(2 * len(got)):
        assert np.array_equal(G.recv_from(got, t), want.recv_from(t))


@pytest.mark.parametrize("nb,frac", [(8, 0.5), (13, 0.5), (13, 0.3), (5, 1.0)])
def test_portbench_subset_matches_program(nb, frac):
    from repro_torch.core.topology import build_subset_schedule
    sub = build_subset_schedule(nb, frac)
    for t in range(-4, 9):
        want = np.ones(nb, bool) if sub is None else sub.selected(t)
        assert np.array_equal(G.subset_mask(nb, frac, t), want)


@pytest.mark.parametrize("name", ["olmo1b-sync-sgd", "mamba7b-sync-sgd-4k"])
@pytest.mark.parametrize("size", ["toy", "full"])
def test_portbench_leaves_and_layout_match_program(name, size):
    from repro_torch.core import build_layout
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten, tree_paths
    from portbench.program import program_config
    from portbench.run import load_cell
    cell = toy.toy_cell(name) if size == "toy" else load_cell(toy.ROOT, name)
    cfg = cell[2]
    specs = family(cfg).leaf_specs(cfg)
    tree = lm_specs(program_config(cfg))
    want = tree_flatten(tree)[0]
    names = [".".join(str(k) for k in p if not isinstance(k, int))
             for p in tree_paths(tree)]
    assert [s[0] for s in specs] == names
    assert [tuple(s[1]) for s in specs] == [tuple(w.shape) for w in want]
    assert [s[2] for s in specs] == [w.init for w in want]
    assert np.allclose([s[3] for s in specs], [w.scale for w in want])
    lay = build_layout(tree)
    item = 4 if cfg["param_dtype"] == "float32" else 2
    slots, sizes = G.flat_layout([int(np.prod(s[1])) for s in specs], item)
    assert list(lay.bucket_sizes) == sizes
    assert [(s.bucket, s.offset) for s in lay.slots] == slots


def test_portbench_configs_are_the_programs():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm_specs
    from repro_torch.tree import tree_flatten
    from portbench.program import program_config
    from portbench.run import load_cell
    for name, arch, layers in (("olmo1b-sync-sgd", "olmo-1b", 16),
                               ("mamba7b-sync-sgd-4k", "falcon-mamba-7b", 4)):
        want = get_config(arch)
        want = dataclasses.replace(want, blocks=want.blocks[:layers])
        got = program_config(load_cell(toy.ROOT, name)[2])
        shapes = lambda c: [(s.shape, s.dtype, s.init)  # noqa: E731
                            for s in tree_flatten(lm_specs(c))[0]]
        assert shapes(got) == shapes(want)
        assert (got.norm, got.tie_embeddings, got.param_dtype,
                got.compute_dtype) == (want.norm, want.tie_embeddings,
                                       want.param_dtype, want.compute_dtype)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_portbench_int8_wire_matches_program(seed):
    from repro_torch.kernels.quantize import encode_wire, wire_key
    gen = torch.Generator().manual_seed(seed % 1000)
    x = (torch.randn(3, 128 * 40, generator=gen) * 0.02).to(torch.bfloat16)
    x[1, :128] = 0
    for t, b in ((0, 0), (5, 3)):
        keys = wire_key(t, np.arange(3), b, seed)
        want = encode_wire(x, "int8", keys=keys)
        for r in range(3):
            assert G.wire_key(t, r, b, seed) == int(keys[r])
            q, s = G.encode_int8(x[r], int(keys[r]), chunk=128 * 16)
            assert torch.equal(q, want["q"][r])
            assert torch.equal(s, want["s"][r])


@pytest.mark.parametrize("name", ["olmo1b-sync-sgd", "mamba7b-sync-sgd-4k"])
def test_portbench_model_loss_matches_program_fp32(name):
    from repro_torch.models import lm_specs
    from repro_torch.train.loss import make_loss_fn
    from repro_torch.tree import tree_flatten
    from portbench import traffic, weights
    from portbench.program import program_config
    from portbench.reference.precision import matmul_fn
    _, _, cfg, job, _ = toy.toy_cell(name)
    specs = family(cfg).leaf_specs(cfg)
    leaves = weights.make(specs, 5, "cpu", torch.float32)
    toks = traffic.make_ring(job, cfg["vocab"], 5, "cpu")[0, :1]
    pcfg = program_config(cfg)
    td = tree_flatten(lm_specs(pcfg))[1]
    pl = [x.unsqueeze(0).clone().requires_grad_(True) for x in leaves]
    loss_p = make_loss_fn(pcfg)(td.unflatten(pl), {"tokens": toks})[0].sum()
    loss_p.backward()
    w = {s[0]: x.clone().requires_grad_(True) for s, x in zip(specs, leaves)}
    loss_r = family(cfg).loss(w, toks[0], cfg, matmul_fn("fp32"))
    loss_r.backward()
    assert abs(loss_p.item() - loss_r.item()) < 1e-5
    for s, x in zip(specs, pl):
        g = w[s[0]].grad
        assert torch.allclose(x.grad[0], g, rtol=1e-3, atol=1e-6), s[0]


@pytest.mark.parametrize("name", ["olmo1b-sync-sgd", "olmo1b-async-int8",
                                  "mamba7b-sync-sgd-4k"])
def test_portbench_reference_steps_follow_program_fp32(name):
    """In float32 the program's first steps and the reference's differ by
    rounding alone, the int8 payloads included."""
    from portbench import compare, traffic, weights
    from portbench.kinds.train import program_readings
    from portbench.program import Program
    from portbench.reference.train import protocol
    _, _, cfg, job, _ = toy.toy_cell(name)
    specs = family(cfg).leaf_specs(cfg)
    seed = 2 ** 31 + 3
    ring = traffic.make_ring(job, cfg["vocab"], seed, "cpu")
    leaves = weights.make(specs, seed, "cpu", torch.float32)
    prog = Program(cfg, job, leaves, seed=seed, device="cpu")
    pay = protocol(job).checked_payloads(
        job, len(prog.bundle.layout.bucket_sizes), seed)
    got = program_readings(prog, ring, specs, cfg, job, seed, "cpu",
                           torch.float32, payloads=pay)
    ref = readings(cfg, job, leaves, ring[:job["checked_steps"]], seed=seed,
                   payloads=pay)
    gaps = compare.gaps(dict(got, grad_norms=ref["grad_norms"]), ref)
    assert bool(pay) == (name == "olmo1b-async-int8")
    assert gaps.get("wire_gap", 0.0) == 0.0, gaps
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps


def test_portbench_scan_backward_is_the_recurrences():
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(2, 7, 3, 2, generator=gen, dtype=torch.float64)
    b = torch.randn(2, 7, 3, 2, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(mamba._Scan.apply,
                                    (a.requires_grad_(), b.requires_grad_()))
    assert dense.leaf_specs  # both families import without the program
