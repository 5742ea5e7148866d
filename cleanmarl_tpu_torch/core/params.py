"""Parameter trees: nested dicts/lists/tuples of tensors in the JAX
package's layout, plus the bridge from the JAX package's params.

``from_numpy_tree`` takes the JAX params as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's params;
``opt_state_from_numpy`` does the same for an optax Adam state (the
moments and the update count), so both packages then compute the same
thing.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def from_numpy_tree(tree, device) -> Any:
    """numpy (or array-like) leaves → float32/int tensors on ``device``,
    keeping the tree shape."""
    def conv(x):
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(conv, tree)


def opt_state_from_numpy(np_state, device) -> dict:
    """An optax ``adam`` state tree (optionally chained with
    ``clip_by_global_norm`` and a schedule), as numpy → the port's
    optimizer state ``{"count", "mu", "nu"}`` (``core/optim.py``)."""
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu") and hasattr(s, "count"):
            found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(np_state)
    if len(found) != 1:
        raise ValueError("expected exactly one Adam state in the optax tree")
    s = found[0]
    return {
        "count": int(np.asarray(s.count)),
        "mu": from_numpy_tree(s.mu, device),
        "nu": from_numpy_tree(s.nu, device),
    }
