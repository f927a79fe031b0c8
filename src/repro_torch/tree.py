"""Nested-container helpers with JAX's pytree leaf order.

No module of the reference holds these: it uses ``jax.tree_util``. The port
keeps parameters as plain nested dicts and lists of tensors, and flattens
them in JAX's order (dict keys sorted, lists and tuples in order, ``None``
an empty subtree) so that ``core.buckets.build_layout`` sees the leaves in
the reference's order and builds the same slot table. ``keystr`` names a
leaf's path as ``jax.tree_util.keystr`` does, the checkpoint's key.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["TreeDef", "tree_flatten", "tree_map", "tree_paths", "keystr"]

_LEAF = "*"


def _structure(x):
    if isinstance(x, dict):
        return ("dict", tuple((k, _structure(x[k])) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_structure(v) for v in x))
    if x is None:
        return ("none", ())
    return _LEAF


def _count(s) -> int:
    if s == _LEAF:
        return 1
    kind, kids = s
    if kind == "dict":
        return sum(_count(v) for _, v in kids)
    return sum(_count(v) for v in kids)


class TreeDef:
    """The structure of a nested container, without its leaves."""

    def __init__(self, structure) -> None:
        self._s = structure

    @property
    def num_leaves(self) -> int:
        return _count(self._s)

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._s == other._s

    def __hash__(self) -> int:
        return hash(self._s)

    def flatten_up_to(self, tree) -> List[Any]:
        """Leaves of ``tree`` in this structure's order (``tree`` must have
        this structure, its leaves may be anything)."""
        out: List[Any] = []
        _flatten_into(self._s, tree, out)
        return out

    def unflatten(self, leaves: Sequence[Any]):
        return _build(self._s, iter(leaves))

    def paths(self) -> List[Tuple[Any, ...]]:
        """Key path of every leaf, in leaf order."""
        out: List[Tuple[Any, ...]] = []
        _paths_into(self._s, (), out)
        return out


# Module-level recursions: a nested function that calls itself sits in a
# reference cycle with its closure, which would keep the leaves it captured
# (a decode cache of tens of GB) alive until the cycle collector runs.
def _flatten_into(s, x, out: List[Any]) -> None:
    if s == _LEAF:
        out.append(x)
        return
    kind, kids = s
    if kind == "none":
        return
    if kind == "dict":
        if not isinstance(x, dict) or sorted(x) != [k for k, _ in kids]:
            raise ValueError("tree does not match the layout's structure")
        for k, sub in kids:
            _flatten_into(sub, x[k], out)
        return
    if not isinstance(x, (list, tuple)) or len(x) != len(kids):
        raise ValueError("tree does not match the layout's structure")
    for sub, v in zip(kids, x):
        _flatten_into(sub, v, out)


def _build(s, it):
    if s == _LEAF:
        return next(it)
    kind, kids = s
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in kids}
    vals = [_build(sub, it) for sub in kids]
    return tuple(vals) if kind == "tuple" else vals


def _paths_into(s, prefix: Tuple[Any, ...], out: List) -> None:
    if s == _LEAF:
        out.append(prefix)
        return
    kind, kids = s
    if kind == "dict":
        for k, sub in kids:
            _paths_into(sub, prefix + (k,), out)
    elif kind != "none":
        for i, sub in enumerate(kids):
            _paths_into(sub, prefix + (i,), out)


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    td = TreeDef(_structure(tree))
    return td.flatten_up_to(tree), td


def tree_paths(tree) -> List[Tuple[Any, ...]]:
    return TreeDef(_structure(tree)).paths()


def tree_map(fn: Callable, tree, *rest):
    leaves, td = tree_flatten(tree)
    others = [td.flatten_up_to(r) for r in rest]
    return td.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def keystr(path: Sequence[Any]) -> str:
    """``jax.tree_util.keystr`` of a key path: ``['name']`` for a dict key,
    ``[i]`` for a list or tuple index (both are the key's ``repr``)."""
    return "".join(f"[{k!r}]" for k in path)
