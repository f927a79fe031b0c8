"""The benchmark's own arithmetic, checked once against the program's
counter: a step's model FLOPs (``yardstick.train_flops_per_step``) equal
what ``repro_torch.launch.counting`` counts on the meta device for one
train step without remat (every matrix product forward and backward) at
a reduced size, and the fused sweep's bytes follow the subset schedule."""
import dataclasses

import pytest

from portbench import toy, yardstick
from portbench.program import program_config


@pytest.mark.parametrize("name", ["olmo1b-sync-sgd", "mamba7b-sync-sgd-4k"])
def test_portbench_flops_match_the_programs_count(name):
    from repro_torch.launch.dryrun import trace_train
    _, _, cfg, job, _ = toy.toy_cell(name)
    job = dict(job, bundle=dict(job["bundle"], dp=1), rows=2, seq_len=16)
    pcfg = dataclasses.replace(program_config(cfg))
    counted = trace_train(pcfg, 1, job["seq_len"], job["rows"],
                          device="meta", remat=False).counts.flops
    assert counted == yardstick.train_flops_per_step(cfg, job)


def test_portbench_full_size_flops():
    """olmo-1b: 1,176.8 M matmul weights, 129 TFLOP a 16,384-token step."""
    from portbench.models import dense
    from portbench.run import load_cell
    _, _, cfg, job, _ = load_cell(toy.ROOT, "olmo1b-sync-sgd")
    assert dense.matmul_params(cfg) == 1_176_764_416
    assert round(yardstick.train_flops_per_step(cfg, job) / 1e12, 1) == 128.9


def test_portbench_fused_bytes_follow_the_subset():
    from portbench.run import load_cell
    _, _, cfg, sync, _ = load_cell(toy.ROOT, "olmo1b-sync-sgd")
    _, _, _, asy, _ = load_cell(toy.ROOT, "olmo1b-async-int8")
    sizes = yardstick.buckets(cfg)
    total = 4 * sum(sizes)
    assert yardstick.fused_sgd_bytes(cfg, sync, 7) == 12 * total
    both = (yardstick.fused_sgd_bytes(cfg, asy, 4)
            + yardstick.fused_sgd_bytes(cfg, asy, 5))
    # two steps consume complementary halves of the buckets
    assert abs(both - (2 * 10 * total + total * (1 + 4 / 128))) <= 2
