"""Params and optimizer trees: nested dicts and tuples of tensors, walked
in the reference's ``jax.tree_util`` order (dict keys sorted;
``core/unified.iter_leaves`` names each leaf with its ``keystr`` path)."""

from __future__ import annotations

from typing import Any

from repro_torch.core.unified import iter_leaves


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``;
    dicts keep ``tree``'s key order, sequences become tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves in the reference's ``tree_leaves`` order."""
    return [leaf for _, leaf in iter_leaves(tree)]


def from_leaves(like: Any, values) -> Any:
    """The tree of ``like``'s structure whose leaves, in ``leaves`` order,
    are ``values``."""
    by_path = dict(zip((path for path, _ in iter_leaves(like)), values))

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(build(v, f"{prefix}[{i}]") for i, v in enumerate(tree))
        return by_path[prefix]

    return build(like, "")
