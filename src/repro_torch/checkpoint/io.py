"""Checkpointing: a state tree <-> npz with a json manifest.

Port of ``repro/checkpoint/io.py`` (``save_state``, ``restore_state``,
``checkpoint_exists``, ``read_manifest``) in its exact on-disk format, so a
file written by either package restores in the other:

    arrays.npz      ``a{i}`` = the leaf of the i-th key, keys sorted
    manifest.json   ``version`` 1, ``step``, ``keys`` (sorted), ``dtypes``,
                    ``shapes`` and the caller's ``metadata``

A key is the leaf's path as ``jax.tree_util.keystr`` prints it
(``['params']['blocks'][0]['attn']['wq']``, ``['inbox']['slots'][1]``);
``None`` is an empty subtree and writes no key. bf16 and float8_e4m3fn
leaves are staged as float32 (every such value is exact in float32) with
their true dtype recorded under the ml_dtypes name the reference restores
by. The port keeps ``opt["step"]`` and the ring's ``t`` as host ints where
the reference keeps 0-d int32 arrays: they are written as 0-d int32 and
restored as ints.

A per-leaf state (the params, the moments and the ring's slots as trees
of tensors) is written leaf by leaf; ``PackedParams`` nodes (the params,
the optimizer's moments and, under the fp32 full-participation wire, the
inbox ring's slots) are written through their leaf view, so a packed and
a per-leaf state of the same model write the same keys and either
restores into the other's template, whatever their layouts (flat or
shard-local). Every bucket is pulled to the host first and unpacked
there, so no second copy exists on the device. Restore re-packs
into the template's layout, on the template's device, and a bucket the
template holds as an autograd leaf is one again (the engines update in
place). A compressed wire's ring slots are per-bucket payloads (a bucket
shaped tensor, or ``{"q", "s"}``) and are written as they are.

**Under a replica group** (one process per mesh position, ``group=``)
``save_state`` gathers every rank's rows and stretches to rank 0 (one
``gather`` of raw bits per tensor over the world, from the host under
gloo, then each replica's row and each stretch put in its place: shard s
at ``s * stride`` of the bucket, and of a wire payload's scales), and rank
0 writes exactly the files a stacked run of the same plan writes; the
ranks return after it has written. Rank 0 holds the stacked state while
it writes, as a stacked run does. ``restore_state`` reads the file one
leaf at a time, and of each leaf only the rank's replica row (a seek into
the npy): a ``PackedParams`` packs just the rank's pieces of that row
(``BucketLayout.pack(shard=...)``), a wire ring's payload keeps just the
shard's chunk, and no tensor of the stacked state is made. The buckets of
a ``PackedParams`` and of a wire ring's slots are stretches; the leaves of
a per-leaf tree and the ring's ``valid`` are rows, except on a per-leaf
rank of a plan that shards inside a replica (``pieces=``, its bundle's
piece table): there every tree with the model's structure (the params,
the moments, the ring's slots) holds the rank's pieces, which the save
places at their block coordinates and the restore cuts from the row.

The inbox ring (``{"slots", "valid", "t"}``) adapts on restore as the
reference's does: a shallower checkpoint is mask-padded (the new back slots
copy the newest payload and start invalid), a deeper one is truncated to
its oldest slots, a legacy bare inbox restores as one valid slot with
``t`` the manifest step, and a ring of another wire format (the key sets
differ only under ``['inbox']``) resets to the template's bootstrap with
``t`` the manifest step.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core.buckets import (PackedParams, as_bits, dtype_name,
                                      torch_dtype)
from repro_torch.tree import keystr, tree_flatten, tree_map

__all__ = ["save_state", "restore_state", "checkpoint_exists",
           "read_manifest"]

_RING_KEYS = frozenset(("slots", "valid", "t"))
_SLOT_KEY_RE = re.compile(r"\['inbox'\]\['slots'\]\[(\d+)\]")
_STAGED = ("bfloat16", "float8_e4m3fn")   # no numpy dtype: written as f32


def _is_ring(node) -> bool:
    return (isinstance(node, dict) and set(node) == _RING_KEYS
            and isinstance(node["slots"], (tuple, list)))


def _is_int(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def _leaves(node, path: Tuple) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf in JAX's order, a ``PackedParams``
    expanded into its leaf view."""
    if node is None:
        return
    if isinstance(node, PackedParams):
        td = node.layout.treedef
        for sub, leaf in zip(td.paths(), td.flatten_up_to(node.unpack())):
            yield path + sub, leaf
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, path + (i,))
    else:
        yield path, node


def _host(node):
    """``node`` with every tensor pulled to the host (buckets whole, before
    any unpacking)."""
    if isinstance(node, PackedParams):
        return PackedParams([b.detach().cpu() for b in node.buckets],
                            node.layout)
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_host(v) for v in node)
    return node


def _staged(leaf) -> Tuple[np.ndarray, str]:
    """(the array written, the dtype recorded) of one host leaf."""
    if isinstance(leaf, torch.Tensor):
        name = dtype_name(leaf.dtype)
        return (leaf.float() if name in _STAGED else leaf).numpy(), name
    if _is_int(leaf):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.asarray(leaf)
    name = arr.dtype.name
    return (arr.astype(np.float32) if name in _STAGED else arr), name


def checkpoint_exists(path: str) -> bool:
    """True when ``path`` holds a complete checkpoint (manifest + arrays)."""
    return (os.path.isfile(os.path.join(path, "manifest.json"))
            and os.path.isfile(os.path.join(path, "arrays.npz")))


def read_manifest(path: str) -> Dict:
    """The manifest alone (step, keys, metadata), no arrays loaded."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _is_pieces(node, pieces) -> bool:
    """True when ``node`` is a per-leaf rank's tree of pieces: a container
    with the model tree's structure under a piece table ``pieces``."""
    return (pieces is not None and isinstance(node, (dict, list, tuple))
            and tree_flatten(node)[1] == pieces.treedef)


def _map_rank(node, fn, pieces=None, stretch: bool = False):
    """``node`` with ``fn(x, stretch, leaf)`` applied to every tensor and
    array in a fixed order (ints kept): ``stretch`` is True for the buckets
    of a ``PackedParams`` and the per-bucket payloads of a wire ring's
    slot; ``leaf`` is the leaf index of a piece of a per-leaf rank's tree
    (``_is_pieces``), else None."""
    if node is None or _is_int(node):
        return node
    if isinstance(node, PackedParams):
        return PackedParams([fn(b, True, None) for b in node.buckets],
                            node.layout)
    if _is_ring(node):
        return {"slots": tuple(_map_rank(sl, fn, pieces, isinstance(sl, list))
                               for sl in node["slots"]),
                "valid": fn(node["valid"], False, None), "t": node["t"]}
    if _is_pieces(node, pieces):
        td = pieces.treedef
        return td.unflatten([fn(x, False, i) for i, x in
                             enumerate(td.flatten_up_to(node))])
    if isinstance(node, dict):
        return {k: _map_rank(node[k], fn, pieces, stretch)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_map_rank(v, fn, pieces, stretch) for v in node)
    return fn(node, stretch, None)


def _gathered(state, group, pieces=None):
    """The stacked state on rank 0's host from every rank's part (None on
    the other ranks): per tensor one ``gather`` to rank 0 over the world
    (from the host under gloo, whose gather takes no CUDA tensor), then
    replica q's row is the parts of ``group.mesh_ranks[q]`` in shard order
    (a row's own tensor where it is not a stretch; a per-leaf rank's
    pieces, sent padded to the leaf's longest, each placed at its block
    coordinates)."""
    def gather(x, stretch, leaf):
        arr = isinstance(x, np.ndarray)
        t = torch.from_numpy(np.ascontiguousarray(x)) if arr else x.detach()
        t = t.cpu() if group.backend == "gloo" else t.to(group.device)
        if leaf is not None:
            t = pieces.padded_piece(t, leaf)
        bits = as_bits(t)
        parts = ([torch.empty_like(bits) for _ in range(group.world_size)]
                 if group.rank == 0 else None)
        tdist.gather(bits, parts, dst=0)
        if group.rank != 0:
            return None
        parts = [p.view(t.dtype).reshape(t.shape).cpu() for p in parts]
        if leaf is not None:
            rows = [pieces.place_pieces(leaf, [parts[r] for r in ranks])
                    for ranks in group.mesh_ranks]
        else:
            rows = [torch.cat([parts[r] for r in
                               (ranks if stretch else ranks[:1])], -1)
                    for ranks in group.mesh_ranks]
        out = torch.cat(rows, dim=0)
        return out.numpy() if arr else out

    return _map_rank(state, gather, pieces)


def save_state(path: str, state, metadata: Optional[Dict] = None,
               step: Optional[int] = None, group=None,
               pieces=None) -> None:
    """Write ``state`` under ``path``. The arrays stream into the npz one at
    a time (``np.savez``'s zip64 layout), so the host holds the pulled
    state and one staged leaf, never a staged copy of all of it. Under a
    replica ``group`` every rank calls it: rank 0 writes the stacked state
    of all ranks, and every rank returns once the files are written.
    ``pieces`` is a per-leaf rank's piece table (``bundle.pieces``): its
    trees hold pieces of the leaves."""
    if group is not None:
        with torch.no_grad():
            full = _gathered(state, group, pieces)
        if group.rank == 0:
            _write(path, full, metadata, step)
        tdist.barrier()
        return
    _write(path, state, metadata, step)


def _write(path: str, state, metadata: Optional[Dict],
           step: Optional[int]) -> None:
    os.makedirs(path, exist_ok=True)
    with torch.no_grad():
        keyed = {keystr(p): leaf for p, leaf in _leaves(_host(state), ())}
    names = sorted(keyed)
    dtypes, shapes = {}, {}
    with zipfile.ZipFile(os.path.join(path, "arrays.npz"), "w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, k in enumerate(names):
            arr, dtypes[k] = _staged(keyed[k])
            shapes[k] = list(arr.shape)
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    manifest = {"version": 1, "step": step, "keys": names, "dtypes": dtypes,
                "shapes": shapes, "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _specs(node, path: Tuple, lift, pieces=None, stretch: bool = False
           ) -> Dict[str, Tuple[int, ...]]:
    """Key -> the file's shape of every leaf ``node`` restores: a
    ``PackedParams``'s leaves and a tree of pieces' leaves from their
    layout (nothing unpacked or gathered), every shape through
    ``lift(shape, stretch)`` (a rank's to the stacked one's)."""
    if node is None:
        return {}
    if isinstance(node, PackedParams):
        lead, lay = tuple(node.buckets[0].shape[:-1]), node.layout
        return {keystr(path + sub): lift(lead + shp, False) for sub, shp in
                zip(lay.treedef.paths(), lay.leaf_shapes)}
    out = {}
    if _is_ring(node):
        for i, sl in enumerate(node["slots"]):
            out.update(_specs(sl, path + ("slots", i), lift, pieces,
                              isinstance(sl, list)))
        out.update(_specs(node["valid"], path + ("valid",), lift))
        out.update(_specs(node["t"], path + ("t",), lift))
    elif _is_pieces(node, pieces):
        td = pieces.treedef
        for sub, x, shp in zip(td.paths(), td.flatten_up_to(node),
                               pieces.leaf_shapes):
            out[keystr(path + sub)] = lift(tuple(x.shape[:1]) + shp, False)
    elif isinstance(node, dict):
        for k in sorted(node):
            out.update(_specs(node[k], path + (k,), lift, pieces, stretch))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            out.update(_specs(v, path + (i,), lift, pieces, stretch))
    else:
        out[keystr(path)] = (() if _is_int(node)
                             else lift(tuple(np.shape(node)), stretch))
    return out


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(dtype).to(device)


def _fill(node, path: Tuple, read: Callable[..., np.ndarray],
          pieces=None, stretch: bool = False):
    """A fresh copy of the template ``node`` holding the file's values;
    ``read(key, n)`` gives a leaf (with ``n``, a stretch ``n`` long;
    ``read(key, leaf=i)`` the rank's piece of leaf i of ``pieces``)."""
    if node is None:
        return None
    if isinstance(node, PackedParams):
        lay, ref = node.layout, node.buckets[0]
        leaves = [_tensor(read(keystr(path + sub)), torch_dtype(dt), "cpu")
                  for sub, dt in zip(lay.treedef.paths(), lay.leaf_dtypes)]
        buckets = lay.pack(lay.treedef.unflatten(leaves),
                           lead=tuple(ref.shape[:-1]), device=ref.device,
                           shard=node.shard)
        for b, t in zip(buckets, node.buckets):
            b.requires_grad_(t.requires_grad)
        return PackedParams(buckets, lay, node.group)
    if _is_ring(node):
        return {"slots": tuple(_fill(sl, path + ("slots", i), read, pieces,
                                     isinstance(sl, list))
                               for i, sl in enumerate(node["slots"])),
                "valid": _fill(node["valid"], path + ("valid",), read),
                "t": _fill(node["t"], path + ("t",), read)}
    if _is_pieces(node, pieces):
        td = pieces.treedef
        return td.unflatten([_tensor(read(keystr(path + sub), leaf=i),
                                     x.dtype, x.device).requires_grad_(
                                         x.requires_grad)
                             for i, (sub, x) in enumerate(
                                 zip(td.paths(), td.flatten_up_to(node)))])
    if isinstance(node, dict):
        return {k: _fill(v, path + (k,), read, pieces, stretch)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, path + (i,), read, pieces, stretch)
                          for i, v in enumerate(node))
    if _is_int(node):
        return int(read(keystr(path)))
    arr = read(keystr(path), node.shape[-1] if stretch else None)
    if isinstance(node, torch.Tensor):
        return _tensor(arr, node.dtype, node.device).requires_grad_(
            node.requires_grad)
    return np.array(arr, dtype=np.asarray(node).dtype)


def _read_member(zf: zipfile.ZipFile, name: str, row: Optional[int]
                 ) -> np.ndarray:
    """The array of npz member ``name``, or with ``row`` only that row
    (``(1, ...)``, its bytes alone read: a seek past the rows before it).
    A 0-d array is read whole."""
    with zf.open(name + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version ==
                       (1, 0) else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if row is None or not shape or fortran:
            f.seek(0)
            arr = np.lib.format.read_array(f, allow_pickle=False)
            return arr if row is None or not shape else arr[row:row + 1]
        size = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize
        f.seek(f.tell() + row * size)
        buf = bytearray(f.read(size))
    return np.frombuffer(buf, dtype).reshape((1,) + tuple(shape[1:]))


def _ckpt_ring_depth(names) -> Optional[Tuple[int, bool]]:
    """(slot count, legacy?) of the file's inbox, None without one. A
    legacy inbox is a bare param tree with no ring keys."""
    slot_idx, has_inbox = set(), False
    for key in names:
        if key.startswith("['inbox']"):
            has_inbox = True
            m = _SLOT_KEY_RE.match(key)
            if m:
                slot_idx.add(int(m.group(1)))
    if not has_inbox:
        return None
    if not slot_idx:
        return 1, True
    return max(slot_idx) + 1, False


def _copy_slot(slot):
    if isinstance(slot, PackedParams):
        return PackedParams([b.clone() for b in slot.buckets], slot.layout)
    if isinstance(slot, dict):   # a per-leaf slot: a param tree
        return tree_map(lambda x: x.clone(), slot)
    return [{k: v.clone() for k, v in p.items()} if isinstance(p, dict)
            else p.clone() for p in slot]


def _adapt_ring(ring: Dict, k_t: int) -> Dict:
    """Resize a restored ring to depth ``k_t``: mask-pad a shallower one
    (copies of the newest payload, invalid), truncate a deeper one to its
    oldest slots."""
    slots, valid = list(ring["slots"]), ring["valid"]
    k_c = len(slots)
    if k_c < k_t:
        slots += [_copy_slot(slots[-1]) for _ in range(k_t - k_c)]
        valid = np.concatenate(
            [valid, np.zeros((valid.shape[0], k_t - k_c), valid.dtype)], 1)
    elif k_c > k_t:
        slots = slots[:k_t]
        valid = np.ascontiguousarray(valid[:, :k_t])
    return {"slots": tuple(slots), "valid": valid, "t": ring["t"]}


def restore_state(path: str, template, group=None,
                  pieces=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (keys and shapes
    checked, dtypes and devices the template's). Returns (state,
    manifest). Under a replica ``group`` the template is the rank's state
    and the file a stacked one: of every leaf the rank reads its replica's
    row, and of a stretch its shard's chunk, of a leaf of a per-leaf
    rank's trees (``pieces``, the bundle's piece table) its piece; a ring
    reset to another wire's bootstrap keeps the template's own."""
    with torch.no_grad():
        return _restore(path, template, group, pieces)


def _stacked_shape(group):
    """``lift`` for ``_specs``: a rank's shape to its stacked counterpart
    (dp rows; a stretch ``num_shards`` times as long), or as it is."""
    def lift(shape, stretch):
        if group is None:
            return shape
        shape = (group.dp,) + shape[1:]
        if stretch:
            shape = shape[:-1] + (shape[-1] * group.num_shards,)
        return shape
    return lift


def _restore(path: str, template, group=None,
             pieces=None) -> Tuple[Any, Dict]:
    manifest = read_manifest(path)
    names = manifest["keys"]
    shapes = {k: tuple(v) for k, v in manifest["shapes"].items()}
    step = int(manifest.get("step") or 0)

    tpl, ring_adapt = template, None   # ring_adapt: (depth, legacy?, dp)
    ring_t = (template["inbox"] if isinstance(template, dict)
              and _is_ring(template.get("inbox")) else None)
    depth = _ckpt_ring_depth(names) if ring_t is not None else None
    if depth is not None:
        k_c, legacy = depth
        k_t, dp = len(ring_t["slots"]), int(np.shape(ring_t["valid"])[0])
        if legacy:
            tpl = dict(template, inbox=ring_t["slots"][0])
            ring_adapt = (k_t, True, dp)
        elif k_c != k_t:
            tpl = dict(template, inbox={
                "slots": tuple(ring_t["slots"][min(i, k_t - 1)]
                               for i in range(k_c)),
                "valid": np.zeros((dp, k_c), np.float32),
                "t": ring_t["t"]})
            ring_adapt = (k_t, False, dp)
    want = _specs(tpl, (), _stacked_shape(group), pieces)
    ring_reset = False
    if set(want) != set(names):
        rest = {k for k in want if not k.startswith("['inbox']")}
        if ring_t is not None and rest == {
                k for k in names if not k.startswith("['inbox']")}:
            # another wire format's ring: restore the rest, reset the ring
            ring_reset, ring_adapt = True, None
            tpl = {k: v for k, v in tpl.items() if k != "inbox"}
            want = {k: want[k] for k in rest}
        else:
            missing = sorted(set(want) - set(names))[:5]
            extra = sorted(set(names) - set(want))[:5]
            raise ValueError(f"checkpoint/template mismatch; "
                             f"missing={missing} extra={extra}")
    for k, shp in want.items():
        if shapes[k] != shp:
            raise ValueError(f"shape mismatch at {k}: {shapes[k]} vs {shp}")

    index = {k: f"a{i}" for i, k in enumerate(names)}
    row = group.replica if group is not None else None
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as zf:
        def read(key, n=None, leaf=None):
            arr = _read_member(zf, index[key], row)
            if leaf is not None:   # a per-leaf rank's piece
                return pieces.piece(torch.from_numpy(arr), leaf,
                                    group.shard).numpy()
            if n is None or group is None:
                return arr
            return np.ascontiguousarray(
                arr[..., group.shard * n:(group.shard + 1) * n])
        restored = _fill(tpl, (), read, pieces)
    if ring_adapt is not None:
        k_t, legacy, dp = ring_adapt
        ring = restored["inbox"]
        if legacy:
            # the legacy inbox always mixed: one valid slot, t = the step
            ring = {"slots": (ring,), "valid": np.ones((dp, 1), np.float32),
                    "t": step}
        restored["inbox"] = _adapt_ring(ring, k_t)
    if ring_reset:
        restored["inbox"] = {
            "slots": ring_t["slots"],
            "valid": np.zeros(np.shape(ring_t["valid"]), np.float32),
            "t": step}
    return restored, manifest
