"""Nested-dict parameter trees in ``jax.tree.flatten`` order.

JAX flattens a dict with its keys sorted at every level; the port keeps
that order everywhere a tree is walked, so a leaf's position (and hence
its slice of the (n, P) arena) is the same in both packages."""
from __future__ import annotations


def tree_items(tree, prefix=()):
    """[(path tuple, leaf), ...] with dict keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_items(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(paths, leaves):
    """Inverse of :func:`tree_items`: rebuild the nested dict."""
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    items = tree_items(tree)
    others = [tree_leaves(r) for r in rest]
    leaves = [fn(leaf, *(o[i] for o in others))
              for i, (_, leaf) in enumerate(items)]
    return tree_unflatten([p for p, _ in items], leaves)
