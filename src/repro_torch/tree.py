"""Nested containers of tensors, walked in the reference's pytree order.

The reference's training state is a JAX pytree: dicts (keys in sorted
order), NamedTuples (``AdamWState``: fields in order) and lists.  This
module walks the same containers in the same order and names each leaf
with the path string that ``repro.train.checkpoint._flatten_with_paths``
gives it: dict keys as they are, NamedTuple fields with a leading ``.``
(``str`` of JAX's ``GetAttrKey``), sequence positions as numbers, joined
by ``/`` -- e.g. ``opt/.mu/layers/attn/wq``.  ``None`` holds no leaf, as
in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_paths(tree) -> Tuple[List[str], List[Any], Callable]:
    """(paths, leaves, unflatten): ``unflatten(new_leaves)`` rebuilds the
    tree's containers around ``new_leaves``, given in ``leaves``'s
    order."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node, prefix):
        def sub(name):
            return f"{prefix}/{name}" if prefix else name
        if isinstance(node, dict):
            keys = sorted(node)
            builds = [walk(node[k], sub(str(k))) for k in keys]
            return lambda it: {k: b(it) for k, b in zip(keys, builds)}
        if _is_namedtuple(node):
            builds = [walk(getattr(node, f), sub("." + f))
                      for f in node._fields]
            return lambda it: type(node)(*(b(it) for b in builds))
        if isinstance(node, (list, tuple)):
            builds = [walk(v, sub(str(i))) for i, v in enumerate(node)]
            return lambda it: type(node)(b(it) for b in builds)
        if node is None:
            return lambda it: None
        paths.append(prefix)
        leaves.append(node)
        return lambda it: next(it)

    build = walk(tree, "")

    def unflatten(new_leaves):
        new_leaves = list(new_leaves)
        if len(new_leaves) != len(leaves):
            raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                             f"{len(leaves)}")
        return build(iter(new_leaves))

    return paths, leaves, unflatten


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[1]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the leaves of ``rest``,
    trees of the same structure, in the same order)."""
    _, ls, unflatten = flatten_with_paths(tree)
    others = [flatten_with_paths(t)[1] for t in rest]
    return unflatten(fn(*xs) for xs in zip(ls, *others))
