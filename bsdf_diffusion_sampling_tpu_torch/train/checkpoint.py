"""Read and write `.npz` checkpoints in the JAX package's format
(counterpart of its `train/checkpoint.py:26-57`).

Format: one `.npz`; every array leaf of a nested dict/list tree stored under
its `jax.tree_util.keystr` path (`['base']['net'][0]['w']`), plus
`__step__`. The reader rebuilds the tree from the key paths alone, so it
needs no template; the writer produces files that the JAX `load_pytree`
reads. Plain Python ints in a tree (the PE band count) are hyperparameters
that the JAX package keeps in the tree's structure (`Static`), not leaves,
so they are not stored.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

_TOKEN = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(\d+))\]")


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree: Any, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    elif isinstance(tree, int):
        return
    else:
        if torch.is_tensor(tree):
            tree = tree.detach().cpu().numpy()
        yield _keystr(path), np.asarray(tree)


def _parse(key: str) -> list:
    parts, pos = [], 0
    for m in _TOKEN.finditer(key):
        if m.start() != pos:
            raise ValueError(f"unsupported checkpoint key {key!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"unsupported checkpoint key {key!r}")
    return parts


def _listify(node):
    """Turn dicts keyed 0..n-1 by list indices back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices with gaps: {sorted(node)}")
        return [node[i] for i in range(len(node))]
    return node


def save_pytree(path: str, tree: Any, step: int = 0) -> None:
    """Write `tree` (dicts/lists of tensors or arrays) atomically."""
    payload = dict(_flatten(tree))
    payload["__step__"] = np.asarray(step)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str):
    """Returns (tree of numpy arrays, step)."""
    root: dict = {}
    with np.load(path) as data:
        step = int(data["__step__"])
        for key in data.files:
            if key == "__step__":
                continue
            *head, last = _parse(key)
            node = root
            for p in head:
                node = node.setdefault(p, {})
            node[last] = data[key]
    return _listify(root), step
