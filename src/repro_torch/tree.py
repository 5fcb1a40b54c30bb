"""Trees of tensors — nested dicts, tuples, lists and named tuples — and
the order of their leaves: dict keys sorted, sequences in order, None
empty.  It is the order in which JAX flattens the same pytree, so the
optimizer pairs each gradient with its parameter by it and a checkpoint
numbers its leaves by it, as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

__all__ = ["leaves", "unflatten", "tree_map"]


def _iter(tree) -> Iterator[Any]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _iter(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _iter(t)
    elif tree is not None:
        yield tree


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return list(_iter(tree))


def unflatten(tree, values: Iterable[Any]):
    """A tree of ``tree``'s structure (its dicts keep their key order)
    holding ``values``, taken in the order of :func:`leaves`."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = dict.fromkeys(t)
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    return build(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
