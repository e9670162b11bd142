"""Nested containers of tensors — the port's counterpart of the pytrees the
reference hands to ``jax.tree``: dicts, lists, tuples and NamedTuples, with
every other object a leaf.

Leaves are visited in ``jax.tree``'s order (a dict's keys sorted), and
:func:`flatten_with_path` names each leaf as the reference's checkpoint
does (``repro/ckpt/checkpoint.py:_flatten``): the path's parts joined by
:data:`SEP`, a dict key as itself, a sequence index as its number, a
NamedTuple field as ``.<name>``.
"""

from __future__ import annotations

SEP = "\x1d"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(name, child)`` pairs of a container in ``jax.tree`` order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in tree_leaves(child)]


def flatten_with_path(tree, prefix: tuple = ()) -> dict:
    """``{path key: leaf}`` in leaf order, keys as the reference's
    checkpoint writes them."""
    kids = _children(tree)
    if kids is None:
        return {SEP.join(prefix): tree}
    out = {}
    for name, child in kids:
        out.update(flatten_with_path(child, prefix + (name,)))
    return out


def tree_map_with_path(fn, tree, prefix: tuple = ()):
    """``fn(path key, leaf)`` over the leaves; returns a tree of the same
    structure."""
    kids = _children(tree)
    if kids is None:
        return fn(SEP.join(prefix), tree)
    mapped = {name: tree_map_with_path(fn, child, prefix + (name,))
              for name, child in kids}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(mapped[f".{f}"] for f in tree._fields))
    return type(tree)(mapped[str(i)] for i in range(len(tree)))
