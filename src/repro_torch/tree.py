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

        def walk(s, x):
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
                    walk(sub, x[k])
                return
            if not isinstance(x, (list, tuple)) or len(x) != len(kids):
                raise ValueError("tree does not match the layout's structure")
            for sub, v in zip(kids, x):
                walk(sub, v)

        walk(self._s, tree)
        return out

    def unflatten(self, leaves: Sequence[Any]):
        it = iter(leaves)

        def build(s):
            if s == _LEAF:
                return next(it)
            kind, kids = s
            if kind == "none":
                return None
            if kind == "dict":
                return {k: build(sub) for k, sub in kids}
            vals = [build(sub) for sub in kids]
            return tuple(vals) if kind == "tuple" else vals

        return build(self._s)

    def paths(self) -> List[Tuple[Any, ...]]:
        """Key path of every leaf, in leaf order."""
        out: List[Tuple[Any, ...]] = []

        def walk(s, prefix):
            if s == _LEAF:
                out.append(prefix)
                return
            kind, kids = s
            if kind == "dict":
                for k, sub in kids:
                    walk(sub, prefix + (k,))
            elif kind != "none":
                for i, sub in enumerate(kids):
                    walk(sub, prefix + (i,))

        walk(self._s, ())
        return out


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
