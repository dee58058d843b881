"""Checkpointing: trees of tensors <-> .npz with path-encoded keys.

The JAX package's format: one ``.npz`` of leaves keyed by their path in
the tree ("A", "pacer/lam", "tenants/spend", ...), plus
``path + ".manifest.json"`` holding ``step`` and the ``keys`` in tree
order. A tree is nested mappings and dataclasses (``RouterState``,
``PacerState``, ...) over tensors or numpy arrays; None subtrees (an
absent tenant table) are skipped, as a JAX ``None`` leaf is.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        return ((str(k), v) for k, v in tree.items())
    return ((f.name, getattr(tree, f.name))
            for f in dataclasses.fields(tree))


def _is_leaf(tree) -> bool:
    return not (isinstance(tree, Mapping) or dataclasses.is_dataclass(tree))


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in tree order, None subtrees skipped."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from _flatten(child, f"{prefix}/{name}" if prefix else name)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree``'s leaves to ``path`` (.npz; numpy appends the
    suffix when it is missing) and the manifest beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    np.savez(path, **arrays)
    with open(path + ".manifest.json", "w") as f:
        json.dump({"step": step, "keys": list(arrays)}, f)


def load_checkpoint(path: str, template: Any) -> Any:
    """Restore into the structure of ``template``: each leaf is read by
    its path, must have the template leaf's shape, and comes back as the
    template leaf's kind (a tensor of its dtype on its device, or a numpy
    array of its dtype). Keys the template lacks are ignored."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def build(tree, prefix):
        if tree is None:
            return None
        if _is_leaf(tree):
            arr = data[prefix]
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(
                    f"checkpoint leaf {prefix!r}: shape {arr.shape} != "
                    f"template {tuple(tree.shape)}")
            if isinstance(tree, torch.Tensor):
                return torch.as_tensor(arr, device=tree.device).to(tree.dtype)
            return arr.astype(np.asarray(tree).dtype)
        kids = {name: build(child, f"{prefix}/{name}" if prefix else name)
                for name, child in _children(tree)}
        if isinstance(tree, Mapping):
            return kids
        return dataclasses.replace(tree, **kids)

    with data:
        return build(template, "")
