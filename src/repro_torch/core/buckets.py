"""Bucketed persistent-buffer packing, flat layout.

Port of ``repro/core/buckets.py`` for ``shard_axes=()`` (``LeafSlot``,
``BucketLayout``, ``build_layout``, ``PackedParams``). The parameter tree is
packed ONCE into a few dtype-homogeneous, LANE-aligned, size-balanced flat
buckets by the reference's greedy bin-packing (largest leaf first onto the
emptiest bucket), so the slot table is identical to the reference's.

In PyTorch a bucket is a ``(dp, stride)`` tensor (replica axis first) and
the autograd leaf. ``PackedParams.unpack()`` hands the model views
(``bucket.split(...)`` pieces viewed as ``(dp, *shape)``), so one backward
writes PACKED gradients into ``bucket.grad`` — the counterpart of the reference's unpack
transpose — and the gossip mix and the optimizer sweep whole buckets.

Shard-local (fsdp / tensor-parallel) layouts wait for a later slice
(ROADMAP A.12).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import TreeDef, tree_flatten

__all__ = ["LANE", "DEFAULT_BUCKET_BYTES", "LeafSlot", "BucketLayout",
           "PackedParams", "build_layout", "dtype_name", "torch_dtype"]

LANE = 128                       # alignment quantum (the reference's lane)
DEFAULT_BUCKET_BYTES = 32 << 20  # ~32 MiB buckets


def dtype_name(dt) -> str:
    """Canonical dtype name of a torch, numpy or JAX dtype ("bfloat16")."""
    if isinstance(dt, torch.dtype):
        return str(dt).rsplit(".", 1)[-1]
    return np.dtype(dt).name


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _align_up(n: int, q: int) -> int:
    return -(-n // q) * q


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the bucket set (per-replica elements)."""

    index: int                 # position in the flattened leaf order
    bucket: int                # bucket id
    offset: int                # LANE-aligned start element in the bucket
    size: int                  # element count (unpadded)
    shape: Tuple[int, ...]     # leaf shape without leading (replica) axes
    dtype: str


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static packing plan."""

    treedef: TreeDef
    slots: Tuple[LeafSlot, ...]         # sorted by leaf index
    bucket_sizes: Tuple[int, ...]       # padded elements per bucket
    bucket_dtypes: Tuple[str, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def num_leaves(self) -> int:
        return self.treedef.num_leaves

    def pack(self, tree, *, lead: Tuple[int, ...] | None = None,
             device=None) -> Tuple[torch.Tensor, ...]:
        """Pack ``tree`` (torch tensors with per-replica shapes, optionally
        under shared leading axes) into fresh zero-padded bucket tensors.
        ``lead`` gives the buckets' leading axes; leaves without them are
        broadcast (every replica gets the same values). An init-time cost,
        never per step."""
        leaves = self.treedef.flatten_up_to(tree)
        found = None
        for slot in self.slots:
            shp = tuple(leaves[slot.index].shape)
            cut = len(shp) - len(slot.shape)
            if cut < 0 or shp[cut:] != slot.shape:
                raise ValueError(f"leaf {slot.index} shape {shp} does not end "
                                 f"with layout shape {slot.shape}")
            if cut and found is None:
                found = shp[:cut]
            elif cut and shp[:cut] != found:
                raise ValueError(f"inconsistent leading axes {shp[:cut]} vs "
                                 f"{found}")
        lead = tuple(lead) if lead is not None else (found or ())
        if device is None:
            device = leaves[0].device
        buckets = tuple(torch.zeros(lead + (n,), dtype=torch_dtype(dt),
                                    device=device)
                        for n, dt in zip(self.bucket_sizes, self.bucket_dtypes))
        with torch.no_grad():
            for slot in self.slots:
                leaf = leaves[slot.index]
                flat = leaf.reshape(tuple(leaf.shape[:leaf.dim() - len(slot.shape)])
                                    + (slot.size,))
                buckets[slot.bucket][..., slot.offset:slot.offset + slot.size
                                     ].copy_(flat)
        return buckets

    @functools.cached_property
    def segments(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Per bucket, its flat dim cut into consecutive (slot position or
        -1 for padding, length) segments, in offset order."""
        out = []
        for b, total in enumerate(self.bucket_sizes):
            segs, cur = [], 0
            for i, s in sorted(((i, s) for i, s in enumerate(self.slots)
                                if s.bucket == b), key=lambda x: x[1].offset):
                if s.offset > cur:
                    segs.append((-1, s.offset - cur))
                segs.append((i, s.size))
                cur = s.offset + s.size
            if total > cur:
                segs.append((-1, total - cur))
            out.append(tuple(segs))
        return tuple(out)

    @functools.cached_property
    def _row_slot_tables(self) -> dict:
        return {}

    def row_slots(self, bucket: int, device) -> Tuple[torch.Tensor, int]:
        """``(table, count)`` of bucket ``bucket``: for each LANE row of one
        replica, the position of its slot among the bucket's ``count``
        slots in offset order, or ``count`` for a padding row, as an int64
        tensor on ``device`` (made on first use). Slots start at LANE
        multiples and gaps are zero, so a row never holds two slots."""
        key = (bucket, str(device))
        if key not in self._row_slot_tables:
            slots = sorted((s for s in self.slots if s.bucket == bucket),
                           key=lambda s: s.offset)
            table = np.full(self.bucket_sizes[bucket] // LANE, len(slots),
                            np.int64)
            for k, s in enumerate(slots):
                table[s.offset // LANE:-(-(s.offset + s.size) // LANE)] = k
            self._row_slot_tables[key] = (torch.as_tensor(table,
                                                          device=device),
                                          len(slots))
        return self._row_slot_tables[key]

    def unpack(self, buckets: Sequence[torch.Tensor]):
        """Leaf tree of views into the buckets (split + view, no copy). One
        ``split`` per bucket, so backward assembles each bucket's gradient
        in one pass (a concatenation), however many leaves it holds."""
        if len(buckets) != self.num_buckets:
            raise ValueError(f"{len(buckets)} buckets given, layout has "
                             f"{self.num_buckets}")
        leaves = [None] * len(self.slots)
        for b, segs in zip(buckets, self.segments):
            parts = b.split([n for _, n in segs], dim=-1)
            for (i, _), part in zip(segs, parts):
                if i >= 0:
                    leaves[i] = part.view(tuple(b.shape[:-1])
                                          + self.slots[i].shape)
        return self.treedef.unflatten(leaves)


def build_layout(tree, *, skip_leading: int = 0,
                 target_bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> BucketLayout:
    """Greedy size-balanced bin-packing of ``tree``'s leaves into
    dtype-homogeneous LANE-aligned buckets, exactly as the reference's
    ``build_layout`` with no shard axes. Leaves may be tensors, arrays or
    any object with ``.shape`` and ``.dtype``; ``skip_leading`` drops that
    many leading axes (the replica axis) so the layout describes one
    replica."""
    leaves, treedef = tree_flatten(tree)
    entries = []  # (index, shape, dtype, size)
    for i, leaf in enumerate(leaves):
        shape = tuple(int(s) for s in tuple(leaf.shape)[skip_leading:])
        size = int(np.prod(shape)) if shape else 1
        entries.append((i, shape, dtype_name(leaf.dtype), size))

    by_dtype: dict = {}
    for e in entries:
        by_dtype.setdefault(e[2], []).append(e)

    slots: list = []
    bucket_sizes: list = []
    bucket_dtypes: list = []
    for dtype in sorted(by_dtype):
        group = by_dtype[dtype]
        item = torch_dtype(dtype).itemsize
        total = sum(_align_up(e[3], LANE) for e in group)
        n_buckets = max(1, math.ceil(total * item / target_bucket_bytes))
        n_buckets = min(n_buckets, len(group))
        base = len(bucket_sizes)
        fills = [0] * n_buckets
        # largest-first onto the emptiest bucket: balanced to ~1 leaf
        for idx, shape, dt, size in sorted(group, key=lambda e: (-e[3], e[0])):
            b = int(np.argmin(fills))
            slots.append(LeafSlot(index=idx, bucket=base + b, offset=fills[b],
                                  size=size, shape=shape, dtype=dt))
            fills[b] = _align_up(fills[b] + size, LANE)
        bucket_sizes.extend(max(f, LANE) for f in fills)
        bucket_dtypes.extend([dtype] * n_buckets)

    slots.sort(key=lambda s: s.index)
    return BucketLayout(treedef=treedef, slots=tuple(slots),
                        bucket_sizes=tuple(bucket_sizes),
                        bucket_dtypes=tuple(bucket_dtypes))


class PackedParams:
    """The bucket tensors plus their layout; ``unpack()`` gives the named
    leaf tree as views. Indexing and ``len`` reach the buckets, so a ring
    slot reads the same whether it is a ``PackedParams`` (the fp32
    full-participation wire) or a list of wire payloads."""

    __slots__ = ("buckets", "layout")

    def __init__(self, buckets: Sequence[torch.Tensor], layout: BucketLayout):
        self.buckets = list(buckets)
        self.layout = layout

    @classmethod
    def pack(cls, tree, layout: BucketLayout | None = None, *,
             skip_leading: int = 0, lead: Tuple[int, ...] | None = None,
             device=None) -> "PackedParams":
        if layout is None:
            layout = build_layout(tree, skip_leading=skip_leading)
        return cls(layout.pack(tree, lead=lead, device=device), layout)

    def unpack(self) -> Any:
        return self.layout.unpack(self.buckets)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.buckets[i]

    def __len__(self) -> int:
        return len(self.buckets)

    def __repr__(self) -> str:
        return (f"PackedParams(buckets={self.layout.num_buckets}, "
                f"leaves={self.layout.num_leaves}, "
                f"dtypes={sorted(set(self.layout.bucket_dtypes))})")
