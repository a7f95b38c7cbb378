"""Nested-dict trees: the port's stand-in for ``jax.tree_util``.

``repro`` keeps parameters, gradients and optimizer state as pytrees of
nested dicts; JAX flattens dicts in SORTED key order and names leaves
with ``keystr`` paths such as ``"['lstm_0']['wx']"``. The arena layout,
the packed wire messages and the §5.5 dispatch all follow that leaf
order, so the port flattens the same way. Anything that is not a dict
(a tensor, a ``LeafState``) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable

Treedef = Any   # None for a leaf, or a tuple of (key, Treedef) pairs


def flatten_with_paths(tree: Any, prefix: str = ""
                       ) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out: list[tuple[str, Any]] = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    return [(prefix, tree)]


def structure(tree: Any) -> Treedef:
    """Hashable description of the dict nesting (usable as a cache key)."""
    if isinstance(tree, dict):
        return tuple((k, structure(tree[k])) for k in sorted(tree))
    return None


def flatten(tree: Any) -> tuple[list, Treedef]:
    return [leaf for _, leaf in flatten_with_paths(tree)], structure(tree)


def unflatten(treedef: Treedef, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        return {k: build(sub) for k, sub in d}
    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of ``tree`` (and same-shaped ``rest``)."""
    leaves, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
