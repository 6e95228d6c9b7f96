"""Nested dict/list trees of tensors: the parameter trees, the Adam
moments and the batches that the stages, the checkpoints and the mesh walk
(the port's counterpart of `jax.tree_util` for these trees)."""

from __future__ import annotations

from typing import Any

import torch


def tree_map(fn, tree: Any) -> Any:
    """`fn` on every tensor leaf of a dict/list tree; ints kept as they are
    (tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree) if torch.is_tensor(tree) else tree


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of a dict/list tree, in its order."""
    out = []
    tree_map(out.append, tree)
    return out
