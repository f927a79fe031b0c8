"""Bucketed persistent-buffer packing, flat and shard-local layouts.

Port of ``repro/core/buckets.py`` (``LeafSlot``, ``BucketLayout``,
``_leaf_pieces``, ``build_layout``, ``PackedParams``,
``packed_param_specs``, ``check_layout_mesh``). The parameter tree is
packed ONCE into a few dtype-homogeneous, LANE-aligned, size-balanced flat
buckets by the reference's greedy bin-packing (largest leaf first onto the
emptiest bucket), so the slot table is identical to the reference's.

In PyTorch a bucket is a ``(dp, num_shards * stride)`` tensor (replica
axis first) and the autograd leaf. ``PackedParams.unpack()`` hands the
model the leaves, so one backward writes PACKED gradients into
``bucket.grad`` (the counterpart of the reference's unpack transpose), and
the gossip mix and the optimizer sweep whole buckets.

**Flat layouts** (no shard axes) give one slot per leaf, and ``unpack`` is
views (one ``split`` per bucket, each piece viewed as ``(dp, *shape)``), no
copy.

**Shard-local (hierarchical) layouts**: when the distribution shards
leaves inside a replica (fsdp's FSDP+TP over ``data``/``model``, or
replica-mode tensor parallelism), ``build_layout(shard_axes=...,
shard_axis_sizes=..., shard_specs=...)`` keys the layout by ``(leaf,
shard)``: each of the ``num_shards`` in-replica positions owns one
LANE-aligned piece of every leaf, its block under the leaf's
``PartitionSpec`` sub-chunked over the axes the leaf does not use, so the
pieces partition the leaf exactly. A bucket is ``num_shards`` equal
``stride``-sized chunks end to end: shard ``s`` occupies ``[s * stride,
(s + 1) * stride)`` of each row, the global bucket the reference's
``packed_param_specs`` describes. On one device the whole bucket lives in
one tensor, so the engines run over it unchanged; ``unpack`` assembles
each leaf from its pieces (one ``split`` per bucket, then a ``cat`` of a
block's chunks and a nested ``cat`` of the blocks along each sharded dim),
a copy whose backward scatters the leaf's gradient back into the packed
bucket gradient.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch.mesh_spec import PartitionSpec as P
from repro_torch.tree import TreeDef, tree_flatten

__all__ = ["LANE", "DEFAULT_BUCKET_BYTES", "LeafSlot", "BucketLayout",
           "PackedParams", "build_layout", "packed_param_specs",
           "check_layout_mesh", "dtype_name", "torch_dtype"]

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
    """Where one piece of one leaf lives inside the bucket set (per-replica
    elements). Flat layouts have one whole-leaf slot per leaf; shard-local
    layouts one slot per ``(leaf, shard)``."""

    index: int                 # position in the flattened leaf order
    bucket: int                # bucket id
    offset: int                # LANE-aligned start element within the shard
    size: int                  # element count of this piece (unpadded)
    shape: Tuple[int, ...]     # block shape (the leaf's when unsharded)
    dtype: str
    shard: int = 0             # linearized in-replica shard position
    factors: Tuple[int, ...] = ()   # blocks per dim; () means all ones
    block: Tuple[int, ...] = ()     # this piece's block coordinates
    chunk_start: int = 0       # flat start of this piece within its block

    def leaf_shape(self) -> Tuple[int, ...]:
        if not self.factors:
            return self.shape
        return tuple(b * f for b, f in zip(self.shape, self.factors))


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static packing plan."""

    treedef: TreeDef
    slots: Tuple[LeafSlot, ...]         # sorted by (leaf index, shard)
    bucket_sizes: Tuple[int, ...]       # padded elements per bucket, all
                                        # shards: num_shards * stride
    bucket_dtypes: Tuple[str, ...]
    num_shards: int = 1                 # in-replica positions
    shard_axes: Tuple[str, ...] = ()    # in-replica mesh axes, row-major
    shard_axis_sizes: Tuple[int, ...] = ()
    bucket_strides: Tuple[int, ...] = ()  # per-shard elements per bucket;
                                          # () means bucket_sizes (flat)

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def num_leaves(self) -> int:
        return self.treedef.num_leaves

    @property
    def strides(self) -> Tuple[int, ...]:
        """Per-shard bucket lengths (``bucket_sizes`` for flat layouts)."""
        return self.bucket_strides or self.bucket_sizes

    @property
    def hierarchical(self) -> bool:
        return self.num_shards > 1

    def global_offset(self, slot: LeafSlot) -> int:
        """Element offset of ``slot`` within its bucket's full row."""
        return slot.shard * self.strides[slot.bucket] + slot.offset

    @functools.cached_property
    def by_leaf(self) -> Tuple[Tuple[int, ...], ...]:
        """Per leaf, the positions in ``slots`` of its pieces."""
        groups: list = [[] for _ in range(self.num_leaves)]
        for i, s in enumerate(self.slots):
            groups[s.index].append(i)
        return tuple(tuple(g) for g in groups)

    @functools.cached_property
    def leaf_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-replica shape of every leaf, in leaf order."""
        return tuple(self.slots[g[0]].leaf_shape() for g in self.by_leaf)

    @functools.cached_property
    def leaf_dtypes(self) -> Tuple[str, ...]:
        return tuple(self.slots[g[0]].dtype for g in self.by_leaf)

    def pack(self, tree, *, lead: Tuple[int, ...] | None = None,
             device=None) -> Tuple[torch.Tensor, ...]:
        """Pack ``tree`` (torch tensors with per-replica shapes, optionally
        under shared leading axes) into fresh zero-padded bucket tensors.
        ``lead`` gives the buckets' leading axes; leaves without them are
        broadcast (every replica gets the same values). An init-time cost,
        never per step."""
        leaves = self.treedef.flatten_up_to(tree)
        found = None
        for i, want in enumerate(self.leaf_shapes):
            shp = tuple(leaves[i].shape)
            cut = len(shp) - len(want)
            if cut < 0 or shp[cut:] != want:
                raise ValueError(f"leaf {i} shape {shp} does not end with "
                                 f"layout shape {want}")
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
        self.pack_into(buckets, tree)
        return buckets

    def pack_into(self, buckets: Sequence[torch.Tensor], tree) -> None:
        """Write every leaf of ``tree`` into its pieces of the existing
        ``buckets``, in place (padding untouched)."""
        leaves = self.treedef.flatten_up_to(tree)
        with torch.no_grad():
            for b, table in enumerate(self.block_table):
                for idx, blocks in table:
                    for block in blocks:
                        self._write_block(buckets[b], leaves[idx], block)

    @functools.cached_property
    def block_table(self) -> Tuple[Tuple[Tuple[int, Tuple[Tuple[
            LeafSlot, ...], ...]], ...], ...]:
        """Per bucket, its leaves in leaf order, each as ``(leaf index,
        blocks)``: a block is the slots of one block of the leaf, in flat
        order (one slot unless the block is chunked over unused axes). A
        leaf's pieces all lie in one bucket."""
        table: list = [[] for _ in range(self.num_buckets)]
        for group in self.by_leaf:
            slots = [self.slots[i] for i in group]
            blocks: dict = {}
            for s in sorted(slots, key=lambda s: (s.block, s.chunk_start)):
                blocks.setdefault(s.block, []).append(s)
            table[slots[0].bucket].append(
                (slots[0].index, tuple(tuple(v) for v in blocks.values())))
        return tuple(tuple(t) for t in table)

    @staticmethod
    def _block_of(leaf: torch.Tensor, slot: LeafSlot) -> torch.Tensor:
        """The view of ``leaf`` (any leading axes) that ``slot``'s block
        covers."""
        if not slot.factors:
            return leaf
        nl = leaf.dim() - len(slot.shape)
        return leaf[(slice(None),) * nl + tuple(
            slice(c * b, (c + 1) * b) for c, b in zip(slot.block, slot.shape))]

    def _piece(self, bucket: torch.Tensor, slot: LeafSlot) -> torch.Tensor:
        start = self.global_offset(slot)
        return bucket[..., start:start + slot.size]

    def _write_block(self, bucket, leaf, block) -> None:
        """Copy one block of ``leaf`` into its pieces of ``bucket``."""
        src = self._block_of(leaf, block[0])
        if len(block) == 1:   # one piece: a strided copy, no staging
            dst = self._piece(bucket, block[0])
            dst.view(tuple(dst.shape[:-1]) + block[0].shape).copy_(src)
            return
        flat = src.reshape(tuple(src.shape[:src.dim() - len(block[0].shape)])
                           + (-1,))
        for s in block:
            self._piece(bucket, s).copy_(
                flat[..., s.chunk_start:s.chunk_start + s.size])

    def _read_leaf(self, bucket, idx: int, blocks) -> torch.Tensor:
        """A fresh leaf ``idx`` assembled from its pieces in ``bucket``."""
        lead = tuple(bucket.shape[:-1])
        out = bucket.new_empty(lead + self.leaf_shapes[idx])
        for block in blocks:
            parts = [self._piece(bucket, s) for s in block]
            src = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            self._block_of(out, block[0]).copy_(
                src.view(lead + block[0].shape))
        return out

    @functools.cached_property
    def segments(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Per bucket, its flat row cut into consecutive (slot position or
        -1 for padding, length) segments, in global-offset order."""
        out = []
        for b, total in enumerate(self.bucket_sizes):
            segs, cur = [], 0
            for i, s in sorted(((i, s) for i, s in enumerate(self.slots)
                                if s.bucket == b),
                               key=lambda x: self.global_offset(x[1])):
                start = self.global_offset(s)
                if start > cur:
                    segs.append((-1, start - cur))
                segs.append((i, s.size))
                cur = start + s.size
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
        slots in global-offset order, or ``count`` for a padding row, as an
        int64 tensor on ``device`` (made on first use). Slots start at
        LANE multiples and gaps are zero, so a row never holds two
        slots."""
        key = (bucket, str(device))
        if key not in self._row_slot_tables:
            slots = sorted((s for s in self.slots if s.bucket == bucket),
                           key=self.global_offset)
            table = np.full(self.bucket_sizes[bucket] // LANE, len(slots),
                            np.int64)
            for k, s in enumerate(slots):
                g = self.global_offset(s)
                table[g // LANE:-(-(g + s.size) // LANE)] = k
            self._row_slot_tables[key] = (torch.as_tensor(table,
                                                          device=device),
                                          len(slots))
        return self._row_slot_tables[key]

    def unpack(self, buckets: Sequence[torch.Tensor]):
        """The leaf tree of ``buckets``. A flat layout's leaves are views of
        the buckets (one ``split`` per bucket, so backward assembles each
        bucket's gradient in one concatenation); a shard-local layout's are
        assembled copies (``_Assemble``, one per bucket, whose backward
        copies each leaf's gradient into one packed bucket gradient), so
        writing into them does not reach the buckets."""
        if len(buckets) != self.num_buckets:
            raise ValueError(f"{len(buckets)} buckets given, layout has "
                             f"{self.num_buckets}")
        leaves = [None] * self.num_leaves
        if self.hierarchical:
            for b, bucket in enumerate(buckets):
                outs = _Assemble.apply(bucket, self, b)
                for (idx, _), out in zip(self.block_table[b], outs):
                    leaves[idx] = out
            return self.treedef.unflatten(leaves)
        for b, segs in zip(buckets, self.segments):
            parts = b.split([n for _, n in segs], dim=-1)
            for (i, _), part in zip(segs, parts):
                if i >= 0:
                    slot = self.slots[i]
                    leaves[slot.index] = part.view(tuple(b.shape[:-1])
                                                   + slot.shape)
        return self.treedef.unflatten(leaves)


class _Assemble(torch.autograd.Function):
    """The leaves of one shard-local bucket. Forward copies each piece into
    its block of a fresh leaf (a strided copy per piece); backward copies
    each leaf gradient's blocks into one packed bucket gradient, zero on
    the padding and on the pieces of leaves that got no gradient: one pass
    over the bytes each way, where ``cat``/``split`` would stage the
    non-contiguous blocks once more."""

    @staticmethod
    def forward(ctx, bucket, layout: BucketLayout, b: int):
        ctx.set_materialize_grads(False)
        ctx.layout, ctx.b = layout, b
        ctx.meta = (tuple(bucket.shape), bucket.dtype, bucket.device)
        return tuple(layout._read_leaf(bucket, idx, blocks)
                     for idx, blocks in layout.block_table[b])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        layout, b = ctx.layout, ctx.b
        shape, dtype, device = ctx.meta
        gb = torch.empty(shape, dtype=dtype, device=device)
        cur = 0
        for i, n in layout.segments[b]:
            if i < 0:
                gb[..., cur:cur + n].zero_()
            cur += n
        for (_, blocks), g in zip(layout.block_table[b], grads):
            for block in blocks:
                if g is None:
                    for s in block:
                        layout._piece(gb, s).zero_()
                else:
                    layout._write_block(gb, g, block)
        return gb, None, None


def _leaf_pieces(shape: Tuple[int, ...], spec, shard_axes: Tuple[str, ...],
                 shard_axis_sizes: Tuple[int, ...]) -> list:
    """Partition one leaf across the ``num_shards`` in-replica positions.

    ``spec`` is the leaf's in-replica ``PartitionSpec`` (no replica entry;
    None = replicated). Dims the spec shards become the block
    decomposition; the axes the leaf does not use chunk each block's flat
    element range into near-equal parts, so the pieces tile the leaf
    exactly once. Returns, per linearized shard index, None (an empty
    piece) or ``(block_shape, factors, block_coords, chunk_start,
    piece_size)``."""
    sizes = dict(zip(shard_axes, shard_axis_sizes))
    dims = list(spec) if spec is not None else []
    dims = dims + [None] * (len(shape) - len(dims))
    factors, dim_axes, used = [], [], []
    for size, entry in zip(shape, dims):
        axes = (tuple(entry) if isinstance(entry, tuple)
                else (entry,) if entry else ())
        for a in axes:
            if a not in sizes:
                raise ValueError(
                    f"leaf spec uses mesh axis {a!r} which is not an "
                    f"in-replica shard axis {shard_axes}")
        f = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if size % f:
            raise ValueError(
                f"dim of size {size} not divisible by its {f}-way sharding")
        factors.append(f)
        dim_axes.append(axes)
        used.extend(axes)
    unused = tuple(a for a in shard_axes if a not in used)
    n_chunks = int(np.prod([sizes[a] for a in unused])) if unused else 1
    block_shape = tuple(s // f for s, f in zip(shape, factors))
    block_elems = int(np.prod(block_shape)) if block_shape else 1

    pieces = []
    num_shards = int(np.prod(shard_axis_sizes)) if shard_axis_sizes else 1
    for s in range(num_shards):
        coords, rem = {}, s   # the shard's coordinate per axis, row-major
        for a, n in zip(reversed(shard_axes), reversed(shard_axis_sizes)):
            coords[a] = rem % n
            rem //= n
        block = tuple(
            int(np.ravel_multi_index(tuple(coords[a] for a in axes),
                                     tuple(sizes[a] for a in axes)))
            if axes else 0 for axes in dim_axes)
        r = (int(np.ravel_multi_index(tuple(coords[a] for a in unused),
                                      tuple(sizes[a] for a in unused)))
             if unused else 0)
        base, extra = divmod(block_elems, n_chunks)
        start = r * base + min(r, extra)
        size = base + (1 if r < extra else 0)
        pieces.append(None if size == 0
                      else (block_shape, tuple(factors), block, start, size))
    return pieces


def build_layout(tree, *, skip_leading: int = 0,
                 target_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 shard_axes: Sequence[str] = (),
                 shard_axis_sizes: Sequence[int] = (),
                 shard_specs=None) -> BucketLayout:
    """Greedy size-balanced bin-packing of ``tree``'s leaves into
    dtype-homogeneous LANE-aligned buckets, exactly as the reference's
    ``build_layout``. Leaves may be tensors, arrays or any object with
    ``.shape`` and ``.dtype``; ``skip_leading`` drops that many leading
    axes (the replica axis) so the layout describes one replica.

    ``shard_axes`` / ``shard_axis_sizes`` name the in-replica mesh axes and
    their sizes, and ``shard_specs`` is a tree matching ``tree`` of
    in-replica ``PartitionSpec``s (dims after the skipped leading axes;
    None = replicated). Each leaf is then partitioned across the
    ``prod(shard_axis_sizes)`` positions (``_leaf_pieces``) and every
    position's pieces are bin-packed into its own LANE-aligned stretch of
    each bucket: the same bucket for all shards of a leaf, per-shard
    offsets. With no shard axes this is the flat layout."""
    shard_axes = tuple(shard_axes)
    shard_axis_sizes = tuple(int(n) for n in shard_axis_sizes)
    if len(shard_axes) != len(shard_axis_sizes):
        raise ValueError("shard_axes and shard_axis_sizes must match")
    num_shards = int(np.prod(shard_axis_sizes)) if shard_axis_sizes else 1
    if num_shards > 1 and shard_specs is None:
        raise ValueError("hierarchical layouts need shard_specs (the "
                         "in-replica PartitionSpec per leaf)")

    leaves, treedef = tree_flatten(tree)
    spec_leaves = (treedef.flatten_up_to(shard_specs) if num_shards > 1
                   else [None] * len(leaves))
    entries = []  # (index, shape, dtype, size, pieces)
    for i, leaf in enumerate(leaves):
        shape = tuple(int(s) for s in tuple(leaf.shape)[skip_leading:])
        size = int(np.prod(shape)) if shape else 1
        if num_shards > 1:
            pieces = _leaf_pieces(shape, spec_leaves[i], shard_axes,
                                  shard_axis_sizes)
        else:
            pieces = [(shape, (), (), 0, size)]
        entries.append((i, shape, dtype_name(leaf.dtype), size, pieces))

    by_dtype: dict = {}
    for e in entries:
        by_dtype.setdefault(e[2], []).append(e)

    slots: list = []
    bucket_sizes: list = []
    bucket_dtypes: list = []
    bucket_strides: list = []
    for dtype in sorted(by_dtype):
        group = by_dtype[dtype]
        item = torch_dtype(dtype).itemsize
        # the per-position footprint sets the bucket count: a bucket is
        # about the target bytes on each position, not summed over shards
        weight = {e[0]: max(p[4] if p else 0 for p in e[4]) for e in group}
        total = sum(_align_up(weight[e[0]], LANE) for e in group)
        n_buckets = max(1, math.ceil(total * item / target_bucket_bytes))
        n_buckets = min(n_buckets, len(group))
        base = len(bucket_sizes)
        fills = [[0] * num_shards for _ in range(n_buckets)]
        # largest-first onto the emptiest bucket: balanced to ~1 leaf
        for idx, shape, dt, size, pieces in sorted(
                group, key=lambda e: (-weight[e[0]], e[0])):
            b = int(np.argmin([max(f) for f in fills]))
            for s, piece in enumerate(pieces):
                if piece is None:
                    continue
                blk_shape, factors, block, chunk_start, psize = piece
                offset = fills[b][s]
                slots.append(LeafSlot(
                    index=idx, bucket=base + b, offset=offset, size=psize,
                    shape=blk_shape, dtype=dt, shard=s, factors=factors,
                    block=block, chunk_start=chunk_start))
                fills[b][s] = _align_up(offset + psize, LANE)
        for f in fills:
            stride = max(max(f), LANE)
            bucket_strides.append(stride)
            bucket_sizes.append(stride * num_shards)
        bucket_dtypes.extend([dtype] * n_buckets)

    slots.sort(key=lambda s: (s.index, s.shard))
    return BucketLayout(treedef=treedef, slots=tuple(slots),
                        bucket_sizes=tuple(bucket_sizes),
                        bucket_dtypes=tuple(bucket_dtypes),
                        num_shards=num_shards, shard_axes=shard_axes,
                        shard_axis_sizes=shard_axis_sizes,
                        bucket_strides=tuple(bucket_strides))


class PackedParams:
    """The bucket tensors plus their layout; ``unpack()`` gives the named
    leaf tree (views of the buckets under a flat layout). Indexing and ``len`` reach the buckets, so a ring
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


def packed_param_specs(layout: BucketLayout, dp_axes: Sequence[str]
                       ) -> PackedParams:
    """The ``PartitionSpec`` of every bucket, ``(dp, size)``: the replica
    axes on the leading dim; a shard-local layout's flat dim over its
    in-replica axes (the bucket is ``num_shards`` stride-sized chunks in
    the mesh's row-major position order, so each position's block is its
    own shard bytes)."""
    dp_axes = tuple(dp_axes)
    overlap = set(dp_axes) & set(layout.shard_axes)
    if overlap:
        raise ValueError(
            f"replica axes {sorted(overlap)} also appear as in-replica shard "
            "axes of this layout; rebuild the layout for this distribution")
    front = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if dp_axes else None
    if layout.num_shards > 1:
        sh = layout.shard_axes
        inner = sh if len(sh) > 1 else sh[0]
    else:
        inner = None
    return PackedParams([P(front, inner)] * layout.num_buckets, layout)


def check_layout_mesh(layout: BucketLayout, mesh) -> None:
    """Validate a layout against ``mesh`` (a ``mesh_spec.MeshSpec``): every
    shard axis must exist with the size the layout was built for. A flat
    layout asserts nothing about the in-replica axes."""
    for a, n in zip(layout.shard_axes, layout.shard_axis_sizes):
        if a not in mesh.shape:
            raise ValueError(f"layout shard axis {a!r} not in mesh axes "
                             f"{tuple(mesh.axis_names)}")
        if int(mesh.shape[a]) != n:
            raise ValueError(
                f"layout built for {a}={n} but mesh has {a}="
                f"{int(mesh.shape[a])}; rebuild the layout for this mesh")
