"""Trees of tensors as nested mappings, the form of the port's model
parameters and optimizer moments, walked in the JAX package's order: a
mapping's keys sorted, as ``jax.tree.leaves`` flattens a dict."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping


def leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in JAX's flatten order (an empty mapping has
    none)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of its structure
    in ``rest``, as a tree of ``tree``'s structure."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(template, flat) -> Any:
    """A tree of ``template``'s structure (and key order) holding
    ``flat``'s items in ``leaves`` order."""
    it = iter(flat)

    def build(t):
        if not isinstance(t, Mapping):
            return next(it)
        kids = {k: build(t[k]) for k in sorted(t)}
        return {k: kids[k] for k in t}

    return build(template)
