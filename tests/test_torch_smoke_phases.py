"""``chip_smoke.py``'s phases of long-sequence training, the dense members
and the encoder-decoder and routed-MoE family, run here on the CPU at toy
size: the same functions the card run calls (``mamba_train_run``,
``sweep_check``, ``mamba_remat_run``, ``dense_train_run``, ``serve_run``,
``dense_agree_run``, ``eval_run``, ``jamba_train_run``,
``jamba_remat_pair``, ``combine_check``, and the launch tooling's
``dryrun_check_run``, ``comm_accounting_run``, ``mix_flat_run``,
``examples_run``), with reduced fp32 configs and the kernels' plain
versions. They check the control flow,
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
                                  "qwen3-0.6b", "falcon-mamba-7b",
                                  "whisper-base", "jamba-v0.1-52b",
                                  "kimi-k2-1t-a32b"])
def test_serve_phase(cs, arch):
    cfg = _small(arch)
    moe = any(b.moe is not None for b in cfg.blocks)
    res, out = cs.serve_run(cfg, "cpu", batch=2, prompt=12, new=4,
                            max_seq=32, combine_check=(
                                cs.combine_check(cfg, "cpu") if moe
                                else None))
    assert out.shape == (2, 4) and res["generate_equal"]
    assert res["image_tokens"] == (8 if cfg.vision else 0)
    assert res["audio_frames"] == (16 if cfg.encoder else 0)
    assert ("prefill_encoder_ms" in res) == (cfg.encoder is not None)
    assert ("moe_dropped_frac" in res) == moe
    if moe:
        assert res["combine_check"]["bit_equal"]
        assert res["combine_check"]["top_k"] == 2
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


def test_whisper_train_phase(cs):
    """[whisper_train]'s body: the Trainer feeds seeded frames every step."""
    cfg = _small("whisper-base")
    rec, bundle, tr = cs.dense_train_run(cfg, "cpu", seq=16, per_replica=1,
                                         steps=2)
    assert rec["dp"] == cs.DP and bundle.fused
    assert all(map(math.isfinite, rec["losses"]))
    batch = tr._batch(0)
    assert tuple(batch["audio_frames"].shape) == (cs.DP, 1, 16, cfg.d_model)
    _no_launches(rec, cs)


def test_jamba_eval_phase(cs):
    cfg = _small("jamba-v0.1-52b")
    res, forward = cs.eval_run(cfg, "cpu", forwards=2, b=1, seq=16)
    assert res["mamba_layers"] == 2 and res["peak_mem_gb"] is None
    assert all(map(math.isfinite, res["losses"]))
    assert res["moe_aux"] > 0 and 0 <= res["moe_dropped_frac"] <= 1
    _no_launches(res, cs)


def test_jamba_train_phase(cs):
    """[jamba_train]'s bodies: the counted run on the plan of mesh
    (2, 1, 1), and plain remat against save_moe_combine bit for bit."""
    cfg = _small("jamba-v0.1-52b")
    sizes = dict(dp=2, seq=16, per_replica=1, chunk=8)
    rec, bundle, tr = cs.jamba_train_run(cfg, "cpu", steps=2, **sizes)
    assert rec["remat"] and rec["dist_mode"] == cfg.dist_mode
    assert bundle.dp == 2 and bundle.fused
    assert all(map(math.isfinite, rec["losses"]))
    _no_launches(rec, cs)
    pair = cs.jamba_remat_pair(cfg, "cpu", **sizes)
    assert pair["params_bit_equal"]
    assert pair["remat"]["losses"] == pair["save_moe_combine"]["losses"]
    assert not torch.are_deterministic_algorithms_enabled()


def test_encdec_moe_agree_phase(cs):
    """The card wrapper's checks themselves, CPU against CPU."""
    res = cs.phase_dense_agree("cpu", models=cs._encdec_moe_models(),
                               tag="encdec_moe_agree")
    assert sorted(res) == ["jamba-v0.1-52b", "kimi-k2-1t-a32b",
                           "whisper-base"]
    for name, r in res.items():
        np.testing.assert_array_equal(r["train"]["cuda"], r["train"]["cpu"])
        assert r["serve"] == {"card_vs_cpu_max_abs_err": 0.0,
                              "tokens_equal_cpu": True}


# ---------------------------------------------- MLA and the MTP head

DEEPSEEK = "deepseek-v3-671b"


def test_deepseek_eval_phase(cs):
    """[deepseek_eval]'s body: each forward's CE and the MTP head's."""
    cfg = _small(DEEPSEEK, n_layers=4)
    res, forward = cs.eval_run(cfg, "cpu", forwards=2, b=1, seq=16)
    assert res["mamba_layers"] == 0 and res["peak_mem_gb"] is None
    assert len(res["ces"]) == 2 and all(map(math.isfinite, res["losses"]))
    assert math.isfinite(res["mtp_ce"]) and res["losses"][-1] > res["ce"]
    assert abs(res["ces"][0] - math.log(cfg.vocab)) <= 1.0
    assert res["moe_aux"] > 0 and 0 <= res["moe_dropped_frac"] <= 1
    _no_launches(res, cs)


def test_serve_deepseek_phase(cs):
    """[serve_deepseek]'s body on the latent cache, and its bytes per token
    and layer beside the MHA cache of the same heads."""
    cfg = _small(DEEPSEEK, n_layers=4)
    res, out = cs.serve_run(cfg, "cpu", batch=2, prompt=12, new=4,
                            max_seq=32,
                            combine_check=cs.combine_check(cfg, "cpu"))
    assert out.shape == (2, 4) and res["generate_equal"]
    assert res["combine_check"]["bit_equal"]
    assert 0 <= res["moe_dropped_frac"] <= 1 and "mtp_logits" not in res
    assert res["lm_apply_max_abs_diff"] <= res["lm_apply_bound"]
    _no_launches(res, cs)
    assert cs.mla_cache_bytes(cfg) == {
        "cache_bytes_per_token_layer": (16 + 8) * 4,
        "mha_cache_bytes_per_token_layer": 4 * (16 + 8 + 16) * 4,
        "mha_over_mla": 640 / 96}
    from repro_torch.configs import get_config
    full = cs.mla_cache_bytes(get_config(DEEPSEEK))
    assert full["cache_bytes_per_token_layer"] == (512 + 64) * 2
    assert full["mha_cache_bytes_per_token_layer"] == 128 * 320 * 2


def test_decode_bytes_leave_out_the_mtp_head(cs):
    """The decode bound counts what a step reads: not the MTP head; an
    MLA layer writes one latent and one RoPE key per sequence."""
    from repro_torch.models import lm_cache_init, lm_init
    cfg = _small(DEEPSEEK, n_layers=4)
    params = lm_init(cfg, seed=0, device="cpu")
    cache = lm_cache_init(cfg, 2, 32, device="cpu")
    stack = {k: v for k, v in params.items() if k != "mtp"}
    got = cs._decode_bytes(cfg, params, cache, 2)
    assert got == cs._decode_bytes(cfg, stack, cache, 2)
    assert got == (cs._tree_bytes(stack) + cs._tree_bytes(cache)
                   + 4 * 2 * (16 + 8) * 4 + 2 * cfg.vocab * 4)
    qwen = _small("qwen3-0.6b")
    qp = lm_init(qwen, seed=0, device="cpu")
    assert cs._decode_params(qp) == qp


def test_deepseek_train_phase(cs):
    """[deepseek_train]'s body: 1 layer with the MTP head on the fsdp plan
    of mesh (2, 1, 1), each step's CE and MTP CE recorded."""
    cfg = dataclasses.replace(_small(DEEPSEEK, n_layers=1), dist_mode="fsdp")
    rec, bundle, tr = cs.deepseek_train_run(cfg, "cpu", dp=2, seq=16,
                                            per_replica=1, steps=2)
    assert rec["dist_mode"] == "fsdp" and bundle.dp == 2 and bundle.fused
    assert not rec["remat"] and rec["num_buckets"] == \
        bundle.layout.num_buckets
    assert len(rec["mtp_ces"]) == 2 and all(map(math.isfinite,
                                                rec["losses"]))
    assert all(loss > ce for loss, ce in zip(rec["losses"], rec["ces"]))
    assert abs(rec["ces"][0] - math.log(cfg.vocab)) <= 1.0
    assert cs._finite_buckets(tr)
    _no_launches(rec, cs)


def test_deepseek_agree_phase(cs):
    """The card wrapper's checks themselves, CPU against CPU."""
    res = cs.phase_dense_agree("cpu", models=cs._deepseek_models(),
                               tag="deepseek_agree")
    assert sorted(res) == [DEEPSEEK]
    r = res[DEEPSEEK]
    np.testing.assert_array_equal(r["train"]["cuda"], r["train"]["cpu"])
    assert r["serve"] == {"card_vs_cpu_max_abs_err": 0.0,
                          "tokens_equal_cpu": True}


# ------------------------------------------------- the launch tooling

def test_dryrun_check_phase(cs):
    out = cs.dryrun_check_run(_small("qwen3-0.6b"), "cpu", dp=2, seq=16,
                              per_replica=1, batch=2, max_seq=32)
    assert sorted(out) == ["decode", "train"]
    for kind, r in out.items():
        assert r["flops_equal"] and r["op_bytes_equal"], kind
        assert r["flops"]["meta"] > 0 and r["op_bytes"]["meta"] > 0
        # the CPU run's live peak is the meta one, storage for storage
        assert r["device_counted_peak_bytes"] == r["meta_peak_bytes"], kind
        assert r["measured_peak_bytes"] is None and r["measured_ms"] > 0
        assert r["launches"] == dict.fromkeys(cs.KERNELS, 0)


def test_comm_accounting_phase(cs):
    import repro_torch.core.gossip as gossip_mod
    orig = gossip_mod.exchange
    with cs._bucket_bytes(cs.AGREE_BUCKET_BYTES):
        out = cs.comm_accounting_run(_small("qwen3-0.6b"), "cpu", seq=8,
                                     per_replica=1)
    assert gossip_mod.exchange is orig
    sync, wired = out["sync_fp32"], out["async_int8_sub0.5"]
    assert sync["exchanges"] == sync["num_buckets"] > 1
    assert sync["equal_raw_bytes"] and sync["equal_sent_bytes_at"]
    assert wired["divides"] and wired["equal_sent_bytes_at"]
    assert wired["steps"] > 1 and wired["exchanges"] > 0


def test_mix_flat_phase(cs):
    out = cs.mix_flat_run("cpu", 1000 + 77, _small("qwen3-0.6b"))
    for k in ("bfloat16", "float32"):
        r = out[k]
        assert r["equal"] and r["input_untouched"] and r["launches"] == 0
    assert out["tree"]["equal"] and out["tree"]["launches"] == 0
    assert out["tree"]["leaves"] > 1


def test_examples_phase(cs):
    out = cs.examples_run("cpu", quick_steps=3, gva_steps=3,
                          protocols="gossip,agd")
    assert math.isfinite(out["quickstart"]["final_loss"])
    assert sorted(out["gossip_vs_agd"]) == ["agd", "gossip"]
    assert out["serve_batched"]["shape"] == [4, 24]


def test_fsdp_ranks_phases(cs):
    """[fsdp_ranks] and [fsdp_ranks_agree] at toy size: four gloo ranks of
    the (1, 2, 2) fsdp mesh on the CPU, each holding its stretches; the
    bytes their in-replica collectives receive equal the padded count,
    the stretch sweep equals the plain version, and the ranks agree with
    the stacked run, their checkpoints crossing both ways bit for bit."""
    ranks = dict(cs.FSDP_RANKS, reduced=dict(d_model=32), seq=8, steps=2)
    agree = dict(cs.FSDP_AGREE, reduced=dict(d_model=32), seq=8, steps=2)
    out = cs.fsdp_ranks_run("cpu", ranks=ranks, agree=agree)
    assert cs._ranks_failed(out, "fsdp_ranks") is None
    rec = cs.check_fsdp_ranks(out, "cpu")
    assert rec["world"] == 4 and rec["mesh"] == [1, 2, 2]
    assert rec["num_buckets"] >= 1 and rec["tokens_per_rank"] == 8
    for moved, r in zip(rec["bytes_per_step_by_rank"],
                        (r["ranks"] for r, _ in out["ranks"])):
        assert moved["all_gather"] > 0 and moved["reduce_scatter"] > 0
        # the layout's LANE padding: the padded count is at least the
        # dry run's count over the unpadded params
        assert moved["all_gather"] >= r["count_per_step"]["all-gather_bytes"]
    assert rec["peak_mem_gb_by_rank"] == [None] * 4
    agreed = cs.check_fsdp_agree(out)
    assert agreed["rank_file_restores_in_stacked_bit_equal"]
    assert agreed["stacked_file_restores_in_ranks_bit_equal"]
    assert agreed["max_abs_diff_params"] <= 2e-4
    assert cs._refusal([({"error": "RuntimeError: ProcessGroupGloo does "
                                   "not support send of CUDA tensors"},
                         {})]) is not None


def test_leaf_ranks_phases(cs):
    """[leaf_ranks] and [leaf_ranks_agree] at toy size: four gloo ranks of
    the (1, 2, 2) fsdp mesh on the CPU, each holding its piece of every
    leaf; the bytes their per-leaf gathers and reduce-scatters receive
    equal the padded pieces' bytes (at least the dry run's count, which
    they equal where no piece is padded), the kernel's plain version on
    each rank's largest piece is bit-equal, and the per-leaf sgd and lars
    runs agree with the stacked per-leaf run, lars's trust ratios within
    rtol 2e-6, the checkpoints crossing both ways bit for bit."""
    ranks = dict(cs.LEAF_RANKS, reduced=dict(d_model=32), seq=8, steps=2)
    agree = dict(cs.LEAF_AGREE, reduced=dict(d_model=32), seq=8, steps=2)
    out = cs.leaf_ranks_run("cpu", ranks=ranks, agree=agree)
    assert cs._ranks_failed(out, "leaf_ranks") is None
    rec = cs.check_leaf_ranks(out, "cpu")
    assert rec["world"] == 4 and rec["mesh"] == [1, 2, 2]
    assert rec["engine"] == "per-leaf" and rec["tokens_per_rank"] == 8
    # the pieces tile the replica once
    assert sum(rec["piece_elements_by_rank"]) == sum(
        int(np.prod(s)) for s in out["pieces"].leaf_shapes)
    for moved in rec["bytes_per_step_by_rank"]:
        assert moved["all_gather"] >= rec["count_per_step"][
            "all-gather_bytes"] > 0
        assert moved["reduce_scatter"] >= rec["count_per_step"][
            "reduce-scatter_bytes"] > 0
    assert rec["peak_mem_gb_by_rank"] == [None] * 4
    assert all(m["equal"] and m["launches"] == 0
               for m in rec["mix_by_rank"])
    agreed = cs.check_leaf_agree(out)
    assert agreed["rank_file_restores_in_stacked_bit_equal"]
    assert agreed["stacked_file_restores_in_ranks_bit_equal"]
    assert agreed["lars"]["trust_ratios"] > 0
    assert agreed["sgd"]["max_abs_diff_params"] <= 2e-4


def test_moe_ranks_phases(cs):
    """[moe_ranks], [moe_ranks_agree] and [serve_ranks] at toy size: four
    gloo ranks of the (1, 2, 2) fsdp mesh on the CPU running reduced
    jamba. Under expert parallelism each rank runs its 2 of 4 experts and
    the bytes of every collective equal the count from the leaf shapes,
    with and without it; the reduced runs agree with the stacked ones and
    remat changes no bit; served over the ranks, the weights' one gather
    equals its count, every rank returns the one-process engine's tokens
    and the logits agree."""
    small = dict(reduced=dict(d_model=32))
    ranks = dict(cs.MOE_RANKS, seq=8, **small)
    agree = dict(cs.MOE_AGREE, seq=8, **small)
    serve = dict(cs.SERVE_RANKS, batch=4, prompt=6, new=3, max_seq=16,
                 small=dict(cs.SERVE_RANKS["small"], **small), **small)
    out = cs.moe_ranks_run("cpu", ranks=ranks, agree=agree, serve=serve)
    assert cs._ranks_failed(out, "moe_ranks") is None
    rec = cs.check_moe_ranks(out, "cpu")
    assert rec["world"] == 4 and rec["n_experts"] == 4
    assert rec["ep"]["experts_a_rank"] == 2
    assert rec["whole"]["experts_a_rank"] == 4
    for ep, whole in zip(rec["ep"]["bytes_per_step_by_rank"],
                         rec["whole"]["bytes_per_step_by_rank"]):
        assert ep["model_sum"] > 0 == whole["model_sum"]
        assert ep["all_gather"] < whole["all_gather"]
        assert ep["batch_gather"] > whole["batch_gather"] > 0
    agreed = cs.check_moe_agree(out)
    assert agreed["model_collectives_per_step"]["leaf"] == {
        "partial_sum": 1, "grad_sum": 1}
    assert agreed["model_collectives_per_step"]["leaf_save"] == {
        "partial_sum": 2, "grad_sum": 1}
    served = cs.check_serve_ranks(out, "cpu")
    for tag in ("full", "small"):
        assert served[tag]["experts_a_rank"] == [2]
        assert served[tag]["greedy_tokens_equal"] == \
            served[tag]["greedy_tokens"]


def test_serve_seq_ranks_phase(cs):
    """[serve_seq_ranks] at toy size: four gloo ranks of the (1, 2, 2)
    fsdp mesh on the CPU serving batch 1 of reduced qwen3 (full cache and
    a windowed ring) and deepseek-v3 over the sequence-parallel cache:
    every rank holds half of every attention / MLA leaf, the combine's
    bytes a token equal the count from the shapes, and every rank returns
    the one-process engine's tokens and logits."""
    tiny = dict(reduced=dict(d_model=32), prompt=6, new=3, max_seq=16)
    runs = tuple(dict(run, **tiny, **({"window": 8} if "shape" in run
                                      else {}))
                 for run in cs.SERVE_SEQ_RANKS["runs"])
    out = cs.seq_ranks_run("cpu", serve=dict(cs.SERVE_SEQ_RANKS, runs=runs))
    assert cs._ranks_failed(out, "serve_seq_ranks") is None
    rec = cs.check_serve_seq_ranks(out, "cpu")
    assert rec["world"] == 4 and rec["mesh"] == [1, 2, 2]
    splits = {"qwen3_decode_32k": [16], "qwen3_long_500k": [8],
              "deepseek_v3": [16], "qwen3_decode_32k/small": [32],
              "qwen3_long_500k/small": [16], "deepseek_v3/small": [32]}
    assert set(rec) - {"world", "mesh"} == set(splits)
    for tag, lengths in splits.items():
        row = rec[tag]
        assert row["split_lengths"] == lengths and row["batch"] == 1
        assert 2 * row["cache_bytes_rank"] == row["cache_bytes_whole"]
        assert row["greedy_tokens_equal"] == row["greedy_tokens"]
        assert row["peak_mem_gb_by_rank"] == [None] * 4
    assert rec["deepseek_v3/small"]["logits_max_abs_diff"] <= 1e-5
