"""``chip_smoke.py``'s phases of long-sequence training and the dense
members, run here on the CPU at toy size: the same functions the card run
calls (``mamba_train_run``, ``sweep_check``, ``mamba_remat_run``,
``dense_train_run``, ``serve_run``, ``dense_agree_run``), with reduced fp32
configs and the kernels' plain versions. They check the control flow,
shapes and arguments before a card call; the card-only assertions (launch
counts, the kernel against its plain version, peaks, times) stay in the
card wrappers. On the CPU no wrapper launches a kernel, so every count
reads 0.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """These tensors are tiny: one intra-op thread keeps a test from
    contending with the other test workers for the cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(arch, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return dataclasses.replace(reduced(get_config(arch), **kw),
                               param_dtype="float32", compute_dtype="float32")


def _no_launches(rec, cs):
    assert rec["launches"] == dict.fromkeys(cs.KERNELS, 0)


def test_mamba_train_phase(cs):
    cfg = _small("falcon-mamba-7b")
    rec, bundle, tr = cs.mamba_train_run(cfg, "cpu", batch=1, seq=32,
                                         steps=2, chunk=8)
    assert rec["remat"] and rec["scan"] == "chunked 8"
    assert len(rec["losses"]) == 2 and all(map(math.isfinite, rec["losses"]))
    assert abs(rec["losses"][0] - math.log(cfg.vocab)) <= 1.0
    assert rec["num_buckets"] == bundle.layout.num_buckets
    assert rec["bucket_sizes_max"] == max(bundle.layout.bucket_sizes)
    assert rec["peak_mem_gb"] is None and rec["tokens_per_s"] > 0
    assert cs._finite_buckets(tr)
    _no_launches(rec, cs)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("n", [1000, 1283])
def test_sweep_check_phase(cs, n, alpha):
    out = cs.sweep_check("cpu", n, lr=0.1, alpha=alpha, chunk=256)
    assert not out["over_int32"] and out["partner"] == bool(alpha)
    assert out["whole"] == {"elements": n, "equal": True, "max_abs_err": 0.0}
    assert out["tail"]["elements"] == n - 3 and out["tail"]["equal"]


def test_mamba_remat_phase(cs):
    cfg = _small("falcon-mamba-7b")
    cases = cs.mamba_remat_run(cfg, "cpu", batch=1, seq=32, steps=2, chunk=8)
    assert sorted(cases) == sorted((s, r) for s in ("assoc", "chunked8")
                                   for r in ("off", "on", "dots"))
    out = cs._remat_summary(cases)
    for scan in ("assoc", "chunked8"):
        assert sorted(out[scan]) == ["dots", "off", "on"]
        for name, r in out[scan].items():
            assert r["params_equal_remat_off"], (scan, name)
            assert r["losses"] == out[scan]["off"]["losses"]
    assert torch.is_grad_enabled()
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b"])
def test_dense_train_phase(cs, arch):
    cfg = _small(arch)
    rec, bundle, tr = cs.dense_train_run(cfg, "cpu", seq=16, per_replica=1,
                                         steps=2)
    assert rec["dp"] == cs.DP and not rec["remat"]
    assert bundle.fused and all(map(math.isfinite, rec["losses"]))
    _no_launches(rec, cs)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "internlm2-20b",
                                  "qwen3-0.6b", "falcon-mamba-7b"])
def test_serve_phase(cs, arch):
    cfg = _small(arch)
    res, out = cs.serve_run(cfg, "cpu", batch=2, prompt=12, new=4,
                            max_seq=32)
    assert out.shape == (2, 4) and res["generate_equal"]
    assert res["image_tokens"] == (8 if cfg.vision else 0)
    assert res["prefill_logits_finite"]
    assert res["lm_apply_max_abs_diff"] <= res["lm_apply_bound"]
    assert res["peak_mem_gb"] is None and "device_busy_ms" not in res
    _no_launches(res, cs)


def test_dense_agree_phase(cs):
    """The card wrapper's checks themselves, CPU against CPU."""
    res = cs.phase_dense_agree("cpu")
    assert sorted(res) == sorted(["olmo-1b", "stablelm-1.6b", "internlm2-20b",
                                  "llava-next-mistral-7b", "falcon-mamba-7b"])
    assert "serve" not in res["falcon-mamba-7b"]
    for name, r in res.items():
        np.testing.assert_array_equal(r["train"]["cuda"], r["train"]["cpu"])
        if "serve" in r:
            assert r["serve"] == {"card_vs_cpu_max_abs_err": 0.0,
                                  "tokens_equal_cpu": True}
