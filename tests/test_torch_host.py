"""Host-side logic of the port against the reference, bit for bit:
gossip schedules, the bucket slot table, pack/unpack, synthetic batches,
the ring rotation and the float32 learning-rate schedule."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.buckets import PackedParams as RefPacked  # noqa: E402
from repro.core.buckets import build_layout as ref_build_layout  # noqa: E402
from repro.core.shuffle import RingShardRotation as RefRotation  # noqa: E402
from repro.core.topology import build_schedule as ref_build_schedule  # noqa: E402
from repro.data import ShardedTokenDataset as RefDataset  # noqa: E402
from repro.data import make_replica_batches as ref_batches  # noqa: E402
from repro.models import lm_init as ref_lm_init  # noqa: E402
from repro.models import reduced as ref_reduced  # noqa: E402
from repro.optim.schedules import step_decay as ref_step_decay  # noqa: E402
from repro_torch.checkpoint import array_to_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import PackedParams, build_layout, build_schedule  # noqa: E402
from repro_torch.data import (RingShardRotation, ShardedTokenDataset,  # noqa: E402
                              make_replica_batches)
from repro_torch.models import lm_specs, reduced  # noqa: E402
from repro_torch.optim import step_decay  # noqa: E402
from repro_torch.tree import tree_map, tree_paths  # noqa: E402


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("topology", ["dissemination", "hypercube"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("num_rotations,seed", [(1, 0), (2, 0), (3, 11)])
def test_recv_from_tables_bit_exact(topology, p, num_rotations, seed):
    if p == 1:  # gossip needs a partner: both packages refuse p = 1
        for build in (ref_build_schedule, build_schedule):
            with pytest.raises(ValueError):
                build(p, topology=topology)
        return
    ref = ref_build_schedule(p, topology=topology, num_rotations=num_rotations,
                             seed=seed)
    got = build_schedule(p, topology=topology, num_rotations=num_rotations,
                         seed=seed)
    assert got.period == ref.period
    np.testing.assert_array_equal(got.perms, ref.perms)
    for t in range(2 * ref.period):
        np.testing.assert_array_equal(got.recv_from(t), ref.recv_from(t))
        np.testing.assert_array_equal(got.send_to(t), ref.send_to(t))


# ---------------------------------------------------------------- buckets

def _ref_cfg(full: bool):
    cfg = ref_get_config("qwen3-0.6b")
    if full:
        return cfg
    return dataclasses.replace(ref_reduced(cfg), param_dtype="float32",
                               compute_dtype="float32")


def _port_cfg(full: bool):
    cfg = get_config("qwen3-0.6b")
    if full:
        return cfg
    return dataclasses.replace(reduced(cfg), param_dtype="float32",
                               compute_dtype="float32")


def _table(layout):
    return ([(s.index, s.bucket, s.offset, s.size, tuple(s.shape), s.dtype)
             for s in layout.slots],
            tuple(layout.bucket_sizes), tuple(layout.bucket_dtypes))


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full_width"])
def test_slot_table_matches_reference(full):
    """The reference's build_layout on jax.ShapeDtypeStructs (nothing
    allocated), the port's on the same structs and on its own ParamSpecs:
    one slot table."""
    shapes = jax.eval_shape(lambda: ref_lm_init(jax.random.key(0),
                                                _ref_cfg(full))[0])
    ref = ref_build_layout(shapes)
    from_structs = build_layout(shapes)
    from_specs = build_layout(lm_specs(_port_cfg(full)))
    assert _table(from_structs) == _table(ref)
    assert _table(from_specs) == _table(ref)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]] \
        == tree_paths(lm_specs(_port_cfg(full)))
    if full:  # the main path's layout: one bucket per stacked leaf
        assert ref.num_buckets == 13
        assert sum(s.size for s in ref.slots) == 596_049_920
        assert min(ref.bucket_sizes) == 1024
        assert max(ref.bucket_sizes) == 155_582_464


def test_slot_table_skips_the_replica_axis():
    rng = np.random.default_rng(3)
    tree = {"w1": rng.normal(size=(4, 5, 3)).astype(np.float32),
            "w2": [rng.normal(size=(4, 130)).astype(np.float32),
                   rng.normal(size=(4, 2, 7, 11)).astype(np.float32)],
            "b": rng.normal(size=(4, 1)).astype(np.float32)}
    for target in (1 << 10, 32 << 20):
        ref = ref_build_layout(tree, skip_leading=1, target_bucket_bytes=target)
        got = build_layout(tree, skip_leading=1, target_bucket_bytes=target)
        assert _table(got) == _table(ref)


def test_pack_unpack_round_trip_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"w1": rng.normal(size=(3, 5, 3)).astype(np.float32),
            "w2": rng.normal(size=(3, 130)).astype(np.float32),
            "w3": rng.normal(size=(3, 2, 7, 11)).astype(np.float32),
            "h": rng.normal(size=(3, 64)).astype(jnp.bfloat16)}
    ref = RefPacked.pack(jax.tree.map(jnp.asarray, tree), skip_leading=1)
    ttree = tree_map(lambda a: array_to_torch(a, "cpu"), tree)
    got = PackedParams.pack(ttree, skip_leading=1)
    assert got.layout.num_buckets == ref.layout.num_buckets
    for b, rb in zip(got.buckets, ref.buckets):
        assert b.shape == rb.shape
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(rb, np.float32))
    back = got.unpack()
    storages = {b.untyped_storage().data_ptr() for b in got.buckets}
    for k in tree:
        assert back[k].dtype == ttree[k].dtype
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      ttree[k].float().numpy())
        assert back[k].untyped_storage().data_ptr() in storages  # a view
    # one replica broadcast to three: every row equals the single replica
    one = tree_map(lambda t: t[0], ttree)
    bcast = PackedParams.pack(one, got.layout, lead=(3,))
    for b in bcast.buckets:
        assert torch.equal(b[0], b[2])


def test_unpack_views_give_packed_gradients():
    """Backward through unpack() views writes packed gradients into the
    bucket, zero in the alignment padding."""
    tree = {"a": torch.randn(2, 3, 5), "b": torch.randn(2, 130)}
    packed = PackedParams.pack(tree, skip_leading=1)
    for b in packed.buckets:
        b.requires_grad_(True)
    leaves = packed.unpack()
    (leaves["a"].sum() * 2 + (leaves["b"] ** 2).sum()).backward()
    g = PackedParams([b.grad for b in packed.buckets], packed.layout).unpack()
    assert torch.equal(g["a"], torch.full((2, 3, 5), 2.0))
    assert torch.equal(g["b"], 2 * tree["b"])
    n_used = sum(s.size for s in packed.layout.slots)
    n_all = sum(packed.layout.bucket_sizes)
    nonzero = sum(int((b.grad != 0).sum()) for b in packed.buckets)
    assert nonzero <= 2 * n_used < 2 * n_all


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("dp", [1, 4])
def test_synthetic_batches_identical(dp):
    ref = RefDataset(vocab=512, seq_len=16, n_shards=dp, batch_per_shard=2,
                     seed=3)
    got = ShardedTokenDataset(vocab=512, seq_len=16, n_shards=dp,
                              batch_per_shard=2, seed=3)
    for step in range(5):
        np.testing.assert_array_equal(make_replica_batches(got, step, dp)["tokens"],
                                      ref_batches(ref, step, dp)["tokens"])


def test_ring_rotation_identical():
    for p in (1, 3, 8):
        ref, got = RefRotation(p), RingShardRotation(p)
        for step in range(-2, 10):
            np.testing.assert_array_equal(got.assignment(step),
                                          ref.assignment(step))


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("lr,decay,every", [(0.1, 0.1, 3), (0.3, 0.5, 2),
                                            (1.0, 0.7, 1)])
def test_step_decay_float32(lr, decay, every):
    """Equal float32 values while decay^k needs no rounding of its own
    (k = step // every <= 1: every run the main path makes); beyond, XLA:CPU's
    float32 pow is not correctly rounded and the two differ by <= 2 ulp."""
    ref = jax.jit(ref_step_decay(lr, decay, every))
    got = step_decay(lr, decay, every)
    for step in range(0, 12 * every):
        want = np.float32(ref(jnp.int32(step)))
        have = np.float32(got(step))
        assert float(have) == got(step)  # a Python float that IS the float32
        if step // every <= 1:
            assert have == want, (step, have, want)
        else:
            assert abs(float(have) - float(want)) <= 2 * np.spacing(want)
