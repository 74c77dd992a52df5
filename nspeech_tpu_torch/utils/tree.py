"""Nested dict/list trees of tensors (the parameter, batch-norm and
optimizer trees), with the leaf order of ``jax.tree_util``: dict keys
sorted, list items in order."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def named_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs, the path ``/``-joined keys and list indices
    (``/encoder/convs/0/conv/bias``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in named_leaves(x, f"{prefix}/{i}")]
    return [(prefix, tree)]
