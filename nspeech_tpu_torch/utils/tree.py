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


def named_leaves(tree):
    """``(path, leaf)`` pairs, the path ``/``-joined keys and list indices
    (``/encoder/convs/0/conv/bias``), in ``tree_leaves`` order."""
    return [("".join(f"/{k}" for k in path), leaf)
            for path, leaf in leaves_with_path(tree)]


def leaves_with_path(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs in ``tree_leaves`` order, the path a tuple of
    dict keys and list indices (``jax.tree_util.tree_flatten_with_path``'s
    order)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in leaves_with_path(x, prefix + (i,))]
    return [(prefix, tree)]


def keystr(path: tuple) -> str:
    """A path of :func:`leaves_with_path` as ``jax.tree_util.keystr``
    writes it: ``['decoder_prenet']['layers'][0]['kernel']``."""
    return "".join(f"[{k!r}]" for k in path)
