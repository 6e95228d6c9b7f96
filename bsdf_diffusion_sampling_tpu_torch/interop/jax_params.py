"""Weight carry-over from the JAX package's parameter trees.

The JAX package keeps parameters as dicts/lists of arrays with weights in
the `(in, out)` layout (`y = x @ W`), and the PE band count as a `Static`
in the tree's structure. The port keeps the same trees and the same layout,
with no transpose: arrays become float32 tensors on the chosen device, and
a `Static`-like object (anything with a `.value`) becomes its plain int.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, device="cuda") -> Any:
    """The same tree with every array (numpy, or a tensor anywhere) as a
    float32 tensor on `device`, and every int or `Static` as an int."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if isinstance(tree, (int, np.integer)):
        return int(tree)
    if torch.is_tensor(tree):
        return tree.to(device=device, dtype=torch.float32)
    if hasattr(tree, "value") and not hasattr(tree, "dtype"):
        return int(tree.value)
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)
