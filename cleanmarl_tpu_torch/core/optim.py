"""Optimizer by name with optional global-norm clipping and linear LR
anneal (port of ``cleanmarl_tpu/core/optim.py``).

The update is written out over the parameter tree so that it matches
optax step for step, not ``torch.optim``:

- ``clip_by_global_norm``: g ← g where ‖g‖ < max, else (g / ‖g‖)·max
  (``torch.nn.utils.clip_grad_norm_`` scales by max/(‖g‖+1e-6) instead);
- ``adam``: m ← (1−b1)·g + b1·m, v ← (1−b2)·g² + b2·v, bias corrections
  1−b^count with the incremented count, u = m̂ / (√(v̂ + eps_root) + eps);
- the step size −lr, or −lr·(1 − count/anneal_steps) clipped at 0 with
  the pre-increment count (``optax.linear_schedule``).

The state is ``{"count": int, "mu": tree, "nu": tree}``; the count stays
a host integer, so an update never waits for the device.
"""
from __future__ import annotations

import numpy as np
import torch

from cleanmarl_tpu_torch.core.networks import global_norm
from cleanmarl_tpu_torch.core.params import tree_map

SUPPORTED = ("adam",)


class Adam:
    def __init__(self, learning_rate: float, clip_gradients: float = 0.0,
                 anneal_steps: int = 0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.learning_rate = learning_rate
        self.clip = clip_gradients if clip_gradients and clip_gradients > 0 else 0.0
        self.anneal_steps = anneal_steps if anneal_steps and anneal_steps > 0 else 0
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    def step_size(self, count: int) -> float:
        """The learning rate applied at the update whose pre-increment
        count is ``count`` (float32 arithmetic, as optax)."""
        lr = np.float32(self.learning_rate)
        if not self.anneal_steps:
            return float(lr)
        c = np.float32(min(max(count, 0), self.anneal_steps))
        frac = np.float32(1.0) - c / np.float32(self.anneal_steps)
        return float(lr * frac)

    def update(self, grads, state, params):
        """→ (new params, new state)."""
        if self.clip:
            norm = global_norm(grads)
            grads = tree_map(
                lambda g: torch.where(norm < self.clip, g, (g / norm) * self.clip),
                grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g ** 2) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        lr = self.step_size(state["count"])
        new_params = tree_map(
            lambda p, m, v: p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2 + self.eps_root)
                                                      + self.eps)),
            params, mu, nu)
        return new_params, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(name: str, learning_rate: float, clip_gradients: float = 0.0,
                   anneal_steps: int = 0) -> Adam:
    """``anneal_steps > 0`` decays the LR linearly to 0 over that many
    updates. Only ``adam`` is ported; other optax names raise."""
    name = name.lower()
    if name not in SUPPORTED:
        raise ValueError(f"optimizer {name!r} is not ported to cleanmarl_tpu_torch "
                         f"(supported: {', '.join(SUPPORTED)})")
    return Adam(learning_rate, clip_gradients, anneal_steps)
