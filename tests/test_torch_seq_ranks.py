"""The sequence-parallel decode cache over the batch group: serving over a
process mesh when the batch does not split over the batch group (the
reference's ``kv_seq`` on ``data``, ``src/repro/serve/step.py:1-8``),
the port's gloo ranks (CPU) against the reference's sharded serve
bundles and against the port in one process.

One subprocess runs the reference with 4 forced host devices: its
``make_prefill_step`` / ``make_decode_step`` bundles, ``jitted(
donate_cache=False)`` on ``make_smoke_mesh(2, 2)`` fsdp, so XLA places
the cache by ``cache_specs``. It asserts that those specs put ``kv_seq``
on ``data`` and the batch on nothing (nothing on either where the
cache length does not divide), and holds its sharded logits against its
own unsharded ``lm_decode`` within 2e-4.

The port runs one world of 4 processes on the (1, 2, 2) fsdp mesh
(``tests/test_torch_moe_ranks.py``'s harness), reduced fp32, ``d_model``
32, on the reference's weights:

* qwen3-0.6b, batch 1, ``max_seq`` 16 (8 positions a rank), prompt 6,
  then 3 decode steps (positions 6-8 cross from rank 0's stretch into
  rank 1's);
* qwen3-0.6b through ``with_sliding_window(cfg, 8)`` (long_500k's
  variant): an 8-slot ring, 4 a rank, position 8 wrapping to slot 0;
* deepseek-v3, 2 layers: MLA's ``c_kv`` / ``k_rope`` stretches;
* jamba-v0.1-52b at 6 layers (layer 4 attention): the SSM state whole,
  the attention stretch, the experts over the model group;
* qwen3-0.6b at batch 3, ``max_seq`` 15: nothing splits, every leaf is
  whole and every rank serves every row.

Every rank's prefill and decode logits within 2e-4 of the reference's
and bit-equal across ranks; the cache leaves' stretch shapes; the
stretches concatenated in batch order equal the one-process port's cache
bit for bit where prefill wrote last and within 2e-4 where decode did;
the engine's greedy tokens equal the one-process engine's.
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

from test_torch_moe_ranks import TOL, _spawn, plan  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
D, PROMPT, NEW, GEN = 32, 6, 3, 5  # width, prompt, decode steps, engine
# name: (arch, layers, window, batch, max_seq)
CONFIGS = {
    "qwen3": ("qwen3-0.6b", 2, None, 1, 16),
    "qwen3_window": ("qwen3-0.6b", 2, 8, 1, 16),
    "deepseek": ("deepseek-v3-671b", 2, None, 1, 16),
    "jamba": ("jamba-v0.1-52b", 6, None, 1, 16),
    "qwen3_whole": ("qwen3-0.6b", 2, None, 3, 15),
}
SPLIT = {"qwen3", "qwen3_window", "deepseek", "jamba"}

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, with_sliding_window
from repro.launch.mesh import make_smoke_mesh
from repro.models import lm_cache_init, lm_decode, lm_init, lm_prefill, reduced
from repro.models.layers import ax_names
from repro.serve.step import cache_axes, make_decode_step, make_prefill_step
from repro.train import make_distribution

configs = json.loads(sys.argv[2])
D, PROMPT, NEW = (int(a) for a in sys.argv[3:6])
dist = make_distribution(make_smoke_mesh(2, 2), "fsdp")
out = {}
for name, (arch, layers, window, B, max_seq, split) in configs.items():
    cfg = dataclasses.replace(
        reduced(get_config(arch), d_model=D, n_layers=layers),
        param_dtype="float32", compute_dtype="float32", dist_mode="fsdp")
    if window:
        cfg = with_sliding_window(cfg, window)
    params, axes = lm_init(jax.random.key(0), cfg)[:2]
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (B, PROMPT + NEW)).astype(np.int32)
    kw = dict(param_shapes=params, param_axes=axes,
              cache_shapes=lm_cache_init(cfg, B, max_seq))
    pre = make_prefill_step(cfg, dist, **kw)
    dec = make_decode_step(cfg, dist, **kw)
    # the plan: kv_seq on data where it splits, the batch on nothing
    specs = jax.tree.leaves(pre.cache_specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    anns = jax.tree.leaves(cache_axes(cfg))
    for spec, ann in zip(specs, anns):
        names = ax_names(ann)
        assert spec[names.index("batch")] is None, (name, spec)
        if "kv_seq" in names:
            want = "data" if split else None
            assert spec[names.index("kv_seq")] == want, (name, spec)
    prefill = pre.jitted(donate_cache=False)
    decode = dec.jitted(donate_cache=False)
    plain_pre = jax.jit(lambda p, t, c: lm_prefill(p, cfg, t, c))
    plain_dec = jax.jit(lambda p, t, c, pos: lm_decode(p, cfg, t, c, pos))
    logits, cache = prefill(params, lm_cache_init(cfg, B, max_seq),
                            jnp.asarray(toks[:, :PROMPT]))
    want, wcache = plain_pre(params, jnp.asarray(toks[:, :PROMPT]),
                             lm_cache_init(cfg, B, max_seq))
    served = [np.asarray(logits)]
    plain = [np.asarray(want)]
    for t in range(PROMPT, PROMPT + NEW):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        want, wcache = plain_dec(params, jnp.asarray(toks[:, t]), wcache,
                                 jnp.int32(t))
        served.append(np.asarray(logits))
        plain.append(np.asarray(want))
    for leaf, spec in zip(jax.tree.leaves(cache), specs):
        assert leaf.sharding.spec == spec, (name, leaf.sharding.spec, spec)
    for g, w in zip(served, plain):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)
    out[name] = {"init": jax.tree.map(np.asarray, params), "tokens": toks,
                 "served": served,
                 "specs": [tuple(None if d is None else str(d) for d in s)
                           for s in specs]}
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
print("REF_OK")
"""


def _cfg(name):
    from repro_torch.configs import get_config, with_sliding_window
    from repro_torch.models import reduced
    arch, layers, window, _, _ = CONFIGS[name]
    cfg = dataclasses.replace(
        reduced(get_config(arch), d_model=D, n_layers=layers),
        param_dtype="float32", compute_dtype="float32", dist_mode="fsdp")
    return with_sliding_window(cfg, window) if window else cfg


def _leaves(tree):
    from repro_torch.tree import tree_flatten
    return tree_flatten(tree)[0]


def _kv_dims(cfg):
    """Per cache leaf, in flatten order: the dim of its ``kv_seq`` axis,
    or None (the SSM state, cross-attention memory)."""
    from repro_torch.models.layers import ax_names
    from repro_torch.serve.step import cache_axes
    dims = []
    for ann in _leaves(cache_axes(cfg)):
        names = ax_names(ann)
        dims.append(names.index("kv_seq") if "kv_seq" in names else None)
    return dims


def _load(spec, name):
    from repro_torch.checkpoint import params_from_numpy
    with open(spec["ref"], "rb") as fh:
        ref = pickle.load(fh)[name]
    return ref, params_from_numpy(ref["init"], device="cpu")


def task_seq(dist, group, spec):
    """Each configuration over the ranks from the reference's weights:
    the serve steps' logits (prefill, then ``NEW`` decode steps) on the
    rank's cache from ``rank_cache_init``, the cache after them, and the
    engine's greedy tokens."""
    from repro_torch.models import lm_axes
    from repro_torch.serve import ServingEngine
    from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                        rank_cache_init, rank_serving_params,
                                        serve_pieces)
    out = {"batch_index": group.batch_index,
           "model_index": group.model_index}
    for name, (_, _, _, B, max_seq) in CONFIGS.items():
        cfg = _cfg(name)
        ref, init = _load(spec, name)
        pieces = serve_pieces(cfg, dist).cut_pieces(init, group.shard)
        weights = rank_serving_params(cfg, dist, pieces, group)
        toks = torch.from_numpy(ref["tokens"].astype(np.int64))
        with torch.inference_mode():
            cache = rank_cache_init(cfg, dist, group, B, max_seq,
                                    device="cpu")
            kw = dict(param_shapes=weights, param_axes=lm_axes(cfg),
                      cache_shapes=cache, group=group, max_seq=max_seq)
            logits, cache = make_prefill_step(cfg, dist, **kw).step_fn(
                weights, cache, toks[:, :PROMPT])
            served = [logits.numpy().copy()]
            decode = make_decode_step(cfg, dist, **kw).step_fn
            for t in range(PROMPT, PROMPT + NEW):
                logits, cache = decode(weights, cache, toks[:, t],
                                       torch.tensor(t))
                served.append(logits.numpy().copy())
        engine = ServingEngine(cfg, pieces, max_seq, device="cpu",
                               dist=dist, group=group)
        out[name] = {"logits": served,
                     "cache": [x.numpy().copy() for x in _leaves(cache)],
                     "tokens": engine.generate(ref["tokens"][:, :PROMPT],
                                               GEN)}
    return out


def _one_process(ref, init, name):
    """The port in one process on the same weights and tokens: the
    logits and cache of the same steps, and the engine's greedy
    tokens."""
    from repro_torch.models import lm_cache_init, lm_decode, lm_prefill
    from repro_torch.serve import ServingEngine
    cfg = _cfg(name)
    _, _, _, B, max_seq = CONFIGS[name]
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    with torch.inference_mode():
        logits, cache = lm_prefill(init, cfg, toks[:, :PROMPT],
                                   lm_cache_init(cfg, B, max_seq,
                                                 device="cpu"))
        served = [logits.numpy().copy()]
        for t in range(PROMPT, PROMPT + NEW):
            logits, cache = lm_decode(init, cfg, toks[:, t], cache,
                                      torch.tensor(t))
            served.append(logits.numpy().copy())
    tokens = ServingEngine(cfg, init, max_seq, device="cpu").generate(
        ref["tokens"][:, :PROMPT], GEN)
    return {"logits": served, "tokens": tokens,
            "cache": [x.numpy().copy() for x in _leaves(cache)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, then the world of 4 ranks; the port in
    one process last."""
    import json
    tmp = tmp_path_factory.mktemp("seq_ranks")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_out = tmp / "ref.pkl"
    configs = {k: [*v, k in SPLIT] for k, v in CONFIGS.items()}
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF, str(ref_out), json.dumps(configs),
         *map(str, (D, PROMPT, NEW))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF_OK" in log, log[-3000:]
    with open(ref_out, "rb") as fh:  # written by the subprocess above
        res = {"ref": pickle.load(fh)}
    res["ranks"] = _spawn(tmp, "seq", ["seq"], module="test_torch_seq_ranks",
                          mode="fsdp", ref=str(ref_out))
    torch.set_num_threads(1)
    res["one"] = {name: _one_process(*_load({"ref": str(ref_out)}, name),
                                     name) for name in CONFIGS}
    return res


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_reference_places_kv_seq_on_data(runs, name):
    """The reference's cache specs under its plan: the batch on nothing;
    ``kv_seq`` on ``data`` where the cache length divides, else on
    nothing (asserted in the subprocess, and recorded)."""
    dims = _kv_dims(_cfg(name))
    specs = runs["ref"][name]["specs"]
    assert len(specs) == len(dims)
    kv = [s[d] for s, d in zip(specs, dims) if d is not None]
    assert kv and set(kv) == {"data" if name in SPLIT else None}
    assert all(s[1] is None for s in specs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_the_reference(runs, name):
    """Every rank's prefill and decode logits, the global batch's, within
    2e-4 of the reference's sharded serve bundle."""
    want = runs["ref"][name]["served"]
    B = CONFIGS[name][3]
    for r in runs["ranks"]:
        got = r[name]["logits"]
        assert len(got) == len(want) == NEW + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.shape[0] == B
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ranks_agree_bit_for_bit(runs, name):
    """Every rank holds the same logits, bit for bit (the combine runs in
    batch order on the same gathered bits), and returns the same
    tokens."""
    r0 = runs["ranks"][0][name]
    for r in runs["ranks"][1:]:
        assert all(np.array_equal(a, b) for a, b in
                   zip(r[name]["logits"], r0["logits"]))
        assert np.array_equal(r[name]["tokens"], r0["tokens"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_leaves_hold_the_stretches(runs, name):
    """A rank's attention and MLA leaves hold ``L / 2`` positions on
    ``kv_seq`` where the plan splits them, the whole ``L`` where it does
    not; the SSM leaves are whole on every rank."""
    dims = _kv_dims(_cfg(name))
    whole = runs["one"][name]["cache"]
    for r in runs["ranks"]:
        got = r[name]["cache"]
        assert len(got) == len(whole) == len(dims)
        for g, w, d in zip(got, whole, dims):
            want = list(w.shape)
            if d is not None and name in SPLIT:
                want[d] //= 2
            assert list(g.shape) == want


def _decoded(cfg, L):
    """The slots of a cache of ``L`` positions that the decode steps
    wrote last (the window's ring, or the clamped full cache)."""
    window = next(b.attn.window if b.attn is not None else b.mla.window
                  for b in cfg.blocks if b.kind in ("attn", "mla"))
    return sorted({p % L if window is not None else min(p, L - 1)
                   for p in range(PROMPT, PROMPT + NEW)})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stretches_equal_the_one_process_cache(runs, name):
    """The ranks' stretches, concatenated in batch order (for each model
    index), equal the one-process port's cache after the same steps: bit
    for bit where prefill wrote last (or nothing did), within 2e-4 on
    the decoded slots; the whole leaves within 2e-4."""
    cfg = _cfg(name)
    dims = _kv_dims(cfg)
    one = runs["one"][name]["cache"]
    ranks = runs["ranks"]
    for m in sorted({r["model_index"] for r in ranks}):
        rows = sorted((r for r in ranks if r["model_index"] == m),
                      key=lambda r: r["batch_index"])
        for i, (w, d) in enumerate(zip(one, dims)):
            parts = [r[name]["cache"][i] for r in rows]
            if d is None:
                for g in parts:
                    np.testing.assert_allclose(g, w, **TOL)
                continue
            g = (np.concatenate(parts, axis=d) if name in SPLIT
                 else parts[0])
            assert g.shape == w.shape
            dec = _decoded(cfg, w.shape[d])
            kept = [t for t in range(w.shape[d]) if t not in dec]
            assert np.array_equal(np.take(g, kept, axis=d),
                                  np.take(w, kept, axis=d)), (name, i)
            np.testing.assert_allclose(np.take(g, dec, axis=d),
                                       np.take(w, dec, axis=d), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_tokens_equal_one_process(runs, name):
    """``ServingEngine(dist=, group=)``'s greedy tokens, on every rank,
    equal the one-process engine's on the same weights."""
    want = runs["one"][name]["tokens"]
    assert want.shape == (CONFIGS[name][3], GEN)
    for r in runs["ranks"]:
        assert np.array_equal(r[name]["tokens"], want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_process_port_matches_the_reference(runs, name):
    """The port in one process on the same weights within 2e-4 of the
    reference's sharded bundle: the baseline the ranks are held to."""
    for g, w in zip(runs["one"][name]["logits"],
                    runs["ref"][name]["served"]):
        np.testing.assert_allclose(g, w, **TOL)


# ------------------------------------------- the plan, in one process

def _table_group(rank):
    """Rank ``rank``'s place on the (1, 2, 2) fsdp mesh, with no world
    (no collective runs)."""
    from repro_torch.core.replica_group import mesh_tables
    return mesh_tables(plan("fsdp")).group(rank, "gloo", "cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_rank_cache_init_follows_the_plan(name, rank):
    """``rank_cache_init``: where the batch does not split, every row and
    the stretch of each leaf whose length the batch group divides
    (``seq_shards``' lengths), every other leaf whole; where it splits
    (batch 4), the rank's 2 rows with the whole length."""
    from repro_torch.models import lm_cache_init
    from repro_torch.models.attention import cache_len
    from repro_torch.serve.step import rank_cache_init, seq_shards
    cfg, dist, group = _cfg(name), plan("fsdp"), _table_group(rank)
    _, _, _, B, max_seq = CONFIGS[name]
    seq = seq_shards(cfg, dist, group, B, max_seq)
    lengths = {cache_len(max_seq, (b.attn or b.mla).window)
               for b in cfg.blocks if b.kind in ("attn", "mla")}
    assert seq.split == (lengths if name in SPLIT else frozenset())
    got = _leaves(rank_cache_init(cfg, dist, group, B, max_seq,
                                  device="cpu"))
    whole = _leaves(lm_cache_init(cfg, B, max_seq, device="meta"))
    for g, w, d in zip(got, whole, _kv_dims(cfg)):
        want = list(w.shape)
        if d is not None and want[d] in seq.split:
            want[d] //= 2
        assert list(g.shape) == want and not g.any()
    assert seq_shards(cfg, dist, group, 4, max_seq) is None
    split = _leaves(rank_cache_init(cfg, dist, group, 4, max_seq,
                                    device="cpu"))
    assert [tuple(x.shape) for x in split] == [
        tuple(x.shape) for x in _leaves(lm_cache_init(cfg, 2, max_seq,
                                                      device="meta"))]


def test_a_step_that_cannot_split_needs_max_seq():
    """A serve step over a group whose batch does not split refuses to
    run without the cache's ``max_seq`` (the stretches' global length
    cannot be read from the rank's cache)."""
    from repro_torch.models import lm_axes, lm_init
    from repro_torch.serve.step import make_decode_step, rank_cache_init
    cfg, dist, group = _cfg("qwen3"), plan("fsdp"), _table_group(0)
    params = lm_init(cfg, seed=0, device="cpu")
    cache = rank_cache_init(cfg, dist, group, 1, 16, device="cpu")
    step = make_decode_step(cfg, dist, param_shapes=params,
                            param_axes=lm_axes(cfg), cache_shapes=cache,
                            group=group).step_fn
    with pytest.raises(ValueError, match="max_seq"):
        step(params, cache, torch.zeros(1, dtype=torch.int64),
             torch.tensor(6))


@pytest.mark.parametrize("S,L", [(6, 16), (12, 16), (16, 16), (20, 8),
                                 (9, 8), (6, 8)])
def test_prefill_writes_each_stretch_of_the_whole_write(S, L):
    """``_cache_write_seq`` into the two stretches of a cache of ``L``
    positions (a ring where ``S > L``) writes, concatenated, exactly what
    the whole-length write writes, and leaves the rest as it was."""
    from repro_torch.models.blocks import _cache_write_seq
    gen = torch.Generator().manual_seed(S * 31 + L)
    full = torch.randn(1, 2, S, 3, generator=gen)
    whole = torch.full((1, 2, L, 3), 7.0)
    _cache_write_seq(whole, full, 2)
    parts = [torch.full((1, 2, L // 2, 3), 7.0) for _ in range(2)]
    for b, part in enumerate(parts):
        _cache_write_seq(part, full, 2, b * L // 2, L)
    assert torch.equal(torch.cat(parts, 2), whole)
