"""What an eager step does, op by op: FLOPs, op bytes, live-storage peak.

No reference counterpart: the reference's dry run reads XLA's
``cost_analysis()`` and ``memory_analysis()`` of the compiled program. The
port runs eagerly, so ``CountingMode``, a ``TorchDispatchMode``, watches
every aten op the step dispatches (forward, backward and remat's
recompute alike) on whatever device its tensors live: on ``meta`` nothing
is allocated or computed and the counts are a prediction; on ``cuda`` the
same counts come from the run itself.

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (matrix products and
  attention; elementwise ops count none), two per multiply-add.
* **Op bytes**: over every op, the bytes of its tensor inputs plus those of
  its outputs. This is the eager program's HBM traffic model: each aten op
  reads its inputs from device memory and writes its outputs there, nothing
  stays on chip between ops. An input counts its elements, at most its
  storage's bytes (an expanded zero-stride input reads its storage once).
  A view (``func.is_view``, or an op such as ``_unsafe_view`` whose
  outputs all share an input's storage without writing it) moves nothing
  and counts 0. An op that writes an argument in place (its schema marks
  it written) counts the written tensor once as written and, for an
  elementwise op (``add_``, ``mul_``), once as read; ``copy_`` does not
  read it; an indexed write (``index_copy_``, ``index_put_``,
  ``scatter_add_``, ...) reads its other arguments and writes as many bytes
  as its largest source of the written dtype, not the whole tensor. A copy
  from the host (an input on the CPU, an output elsewhere: a schedule's
  index table made on first use) is a transfer, not device traffic, and
  counts 0, so a step counts the same bytes on ``meta``, ``cuda`` and the
  CPU.
* **Live peak**: the bytes of every storage alive, at its largest after any
  op. A storage lives from the op that first outputs it until it dies,
  which a weak reference to its (preserved) Python storage object reports
  exactly, so tensors that autograd saves stay counted after their Python
  wrappers are gone. Storages that existed before the mode (the arguments
  passed to it, and any constant an op reads first) count as live at
  entry (``entry_bytes``). Only storages on the traced device count (a
  host tensor an op copies from is not device memory).
* **Ops by name**: calls, bytes and FLOPs per aten op (``top``).

Every size is a Python int, so a petabyte of meta scores counts exactly.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["Counts", "CountingMode"]


@dataclasses.dataclass
class Counts:
    """One counted run. ``by_op`` maps an aten op's name to ``[calls,
    bytes, flops]``."""

    flops: int = 0
    op_bytes: int = 0
    entry_bytes: int = 0
    peak_bytes: int = 0
    n_ops: int = 0
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def temp_bytes(self) -> int:
        """The peak above what was live at entry."""
        return self.peak_bytes - self.entry_bytes

    def top(self, k: int = 16) -> List[Tuple[str, int, int, int]]:
        """The ``k`` ops moving the most bytes: ``(name, calls, bytes,
        flops)``."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][1])[:k]
        return [(name, c, b, f) for name, (c, b, f) in rows]

    def as_dict(self, k: int = 16) -> Dict[str, Any]:
        return {"flops": self.flops, "op_bytes": self.op_bytes,
                "entry_bytes": self.entry_bytes,
                "peak_bytes": self.peak_bytes, "n_ops": self.n_ops,
                "top_ops": [{"op": n, "calls": c, "bytes": b, "flops": f}
                            for n, c, b, f in self.top(k)]}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _read(t: torch.Tensor) -> int:
    return min(_nbytes(t), int(t.untyped_storage().nbytes()))


# indexed writes: only the indexed part of the written tensor moves
_INDEXED = frozenset({
    "index_copy_", "index_put_", "_index_put_impl_", "index_add_",
    "index_fill_", "index_reduce_", "scatter_", "scatter_add_",
    "scatter_reduce_", "masked_scatter_", "put_"})

_WRITTEN: Dict[Any, Tuple[Tuple[int, str], ...]] = {}


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors ``func`` writes in place (schema ``alias_info``
    ``is_write``: ``self`` of an in-place op, ``out=``)."""
    spec = _WRITTEN.get(func)
    if spec is None:
        spec = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                     if a.alias_info is not None and a.alias_info.is_write)
        _WRITTEN[func] = spec
    out: List[torch.Tensor] = []
    for i, name in spec:
        v = args[i] if i < len(args) else kwargs.get(name)
        out.extend(_tensors(v))
    return out


def _op_bytes(func, args, kwargs, ins, outs) -> int:
    written = _written(func, args, kwargs)
    if not written:
        if func.is_view:
            return 0
        held = {id(t.untyped_storage()) for t in ins}
        if outs and all(id(t.untyped_storage()) in held for t in outs):
            return 0          # a view the schema does not declare
        return sum(_read(t) for t in ins) + sum(_nbytes(t) for t in outs)
    wid = {id(t) for t in written}
    others = [t for t in ins if id(t) not in wid]
    name = func._schema.name.split("::")[-1]
    if name in _INDEXED:
        src = [_nbytes(t) for t in others if t.dtype == written[0].dtype]
        return (sum(_read(t) for t in others)
                + min(sum(_nbytes(t) for t in written), max(src, default=0)))
    if name == "copy_":
        return sum(_read(t) for t in others) + sum(_nbytes(t)
                                                    for t in written)
    return sum(_read(t) for t in ins) + sum(_nbytes(t) for t in written)


class CountingMode(TorchDispatchMode):
    """``with CountingMode(args) as m: step()``, then ``m.counts``.
    ``args`` is any nest of tensors alive at entry (the step's state and
    batch): their storages are the entry bytes. ``device`` is the traced
    device's type (default: that of the first tensor in ``args``)."""

    def __init__(self, args: Any = (), device: str | None = None) -> None:
        super().__init__()
        self.counts = Counts()
        self._args = args
        if device is None:
            first = _tensors(args)
            device = first[0].device.type if first else "cpu"
        self._device = torch.device(device).type
        self._live: Dict[int, Tuple[int, weakref.ref]] = {}
        self._bytes = 0

    # ------------------------------------------------------ storage lives
    def _died(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self._bytes -= entry[0]

    def _see(self, t: torch.Tensor, at_entry: bool) -> None:
        if t.device.type != self._device:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = int(st.nbytes())
        self._live[key] = (n, weakref.ref(st, lambda _r, k=key: self._died(k)))
        self._bytes += n
        if at_entry:
            self.counts.entry_bytes += n

    def __enter__(self):
        for t in _tensors(self._args):
            self._see(t, True)
        self._args = None
        self.counts.peak_bytes = self._bytes
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._live.clear()   # drop the weak references' callbacks
        return out

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in ins:
            self._see(t, True)
        transfer = (any(t.device.type == "cpu" for t in ins)
                    and any(t.device.type != "cpu" for t in outs))
        nbytes = 0 if transfer else _op_bytes(func, args, kwargs, ins, outs)
        for t in outs:
            self._see(t, False)
        flops = 0
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        c = self.counts
        c.n_ops += 1
        c.op_bytes += nbytes
        c.flops += flops
        row = c.by_op.setdefault(str(packet), [0, 0, 0])
        row[0] += 1
        row[1] += nbytes
        row[2] += flops
        if self._bytes > c.peak_bytes:
            c.peak_bytes = self._bytes
        return out
