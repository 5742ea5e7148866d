"""Parameter trees: nested dicts/lists/tuples (and dataclass records such
as ``types.Transition``) of tensors in the JAX package's layout, plus the
bridge from the JAX package's params.

``from_numpy_tree`` takes the JAX params as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the port's params;
``opt_state_from_numpy`` does the same for the optax state of any
optimizer the port carries (its trees and the update count), so both
packages then compute the same thing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def value_and_grad(loss_fn: Callable, params, *args):
    """``loss_fn(params, *args) -> (loss, aux)`` → (loss, aux, grads), all
    detached; ``grads`` has the tree shape of ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tuple(a.detach() for a in aux), tree_unflatten(params, grads)


def from_numpy_tree(tree, device) -> Any:
    """numpy (or array-like) leaves → float32/int tensors on ``device``,
    keeping the tree shape."""
    def conv(x):
        a = np.asarray(x)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(conv, tree)


def opt_state_from_numpy(np_state, device, name: str = "adam",
                         count: Optional[int] = None) -> dict:
    """The optax state of ``cleanmarl_tpu``'s ``make_optimizer(name, ...)``
    (with or without ``clip_by_global_norm`` and the schedule), as numpy →
    the port's state for ``core/optim.py``'s ``make_optimizer(name, ...)``.

    Each stateful transform's trees come from the optax state of its class
    (``Transform.optax_state``, in chain order). The count is the one optax
    keeps: ``ScaleByScheduleState.count`` under the schedule, else the
    transform's own (``count``, or adan's ``t``). Where optax keeps none
    (``rmsprop`` or ``sgd`` without a schedule, for instance) it is the
    number of updates taken, which the caller passes as ``count``; a
    ``count`` given where optax keeps one must equal it."""
    from cleanmarl_tpu_torch.core import optim

    opt = optim.make_optimizer(name, 1.0)
    found = []

    def walk(s):
        if hasattr(s, "_fields"):
            if type(s).__name__ == "MaskedState":
                walk(s.inner_state)
            else:
                found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(np_state)
    fields, rest = {}, iter(found)
    for t in opt.transforms:
        if t.optax_state is None:
            continue
        s = next((s for s in rest if type(s).__name__ == t.optax_state), None)
        if s is None:
            raise ValueError(f"no {t.optax_state} in the optax state of {name!r}")
        fields.update({f: from_numpy_tree(getattr(s, f), device) for f in t.fields})

    def kept(s):
        if type(s).__name__ == "WeightDecaySchedule":     # optax never advances it
            return None
        for f in ("count", "t"):
            if f in s._fields:
                return int(np.asarray(getattr(s, f)))
        return None
    held = {c for c in map(kept, found) if c is not None}
    if len(held) > 1:
        raise ValueError(f"the optax state of {name!r} holds several counts: {sorted(held)}")
    if held:
        kept_count = held.pop()
        if count is not None and count != kept_count:
            raise ValueError(f"count={count}, but the optax state of {name!r} counts "
                             f"{kept_count} updates")
        count = kept_count
    elif count is None:
        raise ValueError(f"optax keeps no update count for {name!r} here: pass count=, the "
                         f"number of updates taken")
    for s in found:
        if "is_initial_step" in s._fields and bool(np.asarray(s.is_initial_step)) != (count == 0):
            raise ValueError(f"count={count} disagrees with the optax state's "
                             f"is_initial_step={bool(np.asarray(s.is_initial_step))}")
    return opt.layout(count, fields)
