"""Read and write `.npz` checkpoints in the JAX package's format
(counterpart of its `train/checkpoint.py:26-57`).

Format: one `.npz`; every array leaf of a nested dict/list tree stored under
its `jax.tree_util.keystr` path (`['base']['net'][0]['w']`), plus
`__step__`. The reader rebuilds the tree from the key paths alone, so it
needs no template; the writer produces files that the JAX `load_pytree`
reads. Plain Python ints in a tree (the PE band count) are hyperparameters
that the JAX package keeps in the tree's structure (`Static`), not leaves,
so they are not stored. A named-tuple field is a `.name` token in a key
path; it reads back as an `Attr` key, a `str` that writes back as `.name`.

A stage file is a whole training state under the key paths that `keystr`
gives the JAX package's `TrainState(params, opt_state, step)` with
`optax.adam`: `.params[...]`, `.opt_state[0].count`, `.opt_state[0].mu[...]`,
`.opt_state[0].nu[...]` and `.step`. `torch.optim.Adam` keeps a float
`step` for each parameter where optax keeps one int32 `count`; they are
the same number, and the writer checks that every parameter has it. So a
stage file written by either package resumes in the other.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

from bsdf_diffusion_sampling_tpu_torch.core.tree import tree_leaves, tree_map

_TOKEN = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(\d+))\]|\.([A-Za-z_]\w*)")


class Attr(str):
    """A named-tuple field in a key path (`.name`); equal to its plain name."""


def _keystr(path) -> str:
    return "".join(f".{k}" if isinstance(k, Attr) else f"[{k!r}]" for k in path)


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
        if m.group(3) is not None:
            parts.append(Attr(m.group(3)))
        else:
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


def save_train_state(path: str, params: Any, optimizer: torch.optim.Adam, step: int) -> None:
    """Write (params, Adam state, step) as the JAX package's
    `TrainState(params, optax.adam(...).init(params), step)` is written."""
    state = [optimizer.state.get(p, {}) for p in tree_leaves(params)]
    counts = {float(s["step"]) if s else 0.0 for s in state}
    if len(counts) != 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(counts)}")

    def moment(key):
        return tree_map(lambda p: optimizer.state[p][key] if optimizer.state.get(p) else torch.zeros_like(p), params)

    tree = {Attr("params"): params,
            Attr("opt_state"): [{Attr("count"): np.int32(counts.pop()), Attr("mu"): moment("exp_avg"),
                                 Attr("nu"): moment("exp_avg_sq")}],
            Attr("step"): np.int32(step)}
    save_pytree(path, tree, step=step)


def load_train_state(path: str, params: Any, optimizer: torch.optim.Adam) -> int:
    """Read a stage file of either package into `params` (in place) and
    `optimizer`, whose parameters are `params`' leaves. Returns the saved
    step (`__step__`, the iterations completed)."""
    tree, step = load_pytree(path)
    adam = tree["opt_state"][0]
    count = int(adam["count"])

    def put(dst, key_path, src):
        for k in key_path:
            src = src[k]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {_keystr(key_path)} has shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        return torch.as_tensor(src, dtype=dst.dtype).to(dst.device)

    def walk(node, key_path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, key_path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, key_path + (i,))
        elif torch.is_tensor(node):
            yield key_path, node

    with torch.no_grad():
        for key_path, p in walk(params):
            p.copy_(put(p, key_path, tree["params"]))
            optimizer.state.pop(p, None)
            if count:
                optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": put(p, key_path, adam["mu"]),
                                      "exp_avg_sq": put(p, key_path, adam["nu"])}
    return step
