"""Optimizer by name with optional global-norm clipping and linear LR
anneal (port of ``cleanmarl_tpu/core/optim.py``).

The JAX package takes any optax alias (``getattr(optax, name)(lr)``), with
optax's defaults at the given learning rate, chained after
``clip_by_global_norm`` and under ``optax.linear_schedule`` when
``anneal_steps > 0``. The port carries its own copy of each alias: the
same small transforms (``core/optim_transforms.py``: moments, bias
correction, trace, decayed weights, trust ratio, the learning-rate step)
composed in optax's order, so that each name matches optax (0.2.6) step
for step, not ``torch.optim``, whose formulas differ for most of them:

- ``clip_by_global_norm``: g ← g where ‖g‖ < max, else (g / ‖g‖)·max
  (``torch.nn.utils.clip_grad_norm_`` scales by max/(‖g‖+1e-6) instead);
- the step size −lr, or −lr·(1 − count/anneal_steps) clipped at 0 with
  the pre-increment count (``optax.linear_schedule``);
- then ``p + u``, as ``optax.apply_updates``.

The state is one host-integer ``count`` (updates taken) beside the
transforms' trees: ``{"count", "mu", "nu"}`` for ``adam`` (its layout
since the port began), ``{"count", <name>: {field: tree}}`` for every
other name, the fields named as optax names them. Whatever depends on the
count alone (the schedule, bias corrections, RAdam's rectification,
NovoGrad's first step, Adafactor's decay, ``noisy_sgd``'s variance) is
computed on the host in float32, so an update never waits for the device.
"""
from __future__ import annotations

from typing import List

import torch

from cleanmarl_tpu_torch.core import optim_transforms as T
from cleanmarl_tpu_torch.core.networks import global_norm
from cleanmarl_tpu_torch.core.params import tree_map
from cleanmarl_tpu_torch.core.tracing import span


def _aliases(lr: T.Schedule) -> dict:
    """name → the transforms of ``getattr(optax, name)(lr)`` in optax's
    order (optax/_src/alias.py); weight decays that default to 0 are left
    out (``g + 0·p`` is ``g``)."""
    return {
        # ROADMAP A12's seven
        "adam": lambda: [T.ScaleByAdam(), T.ScaleByLR(lr)],
        "rmsprop": lambda: [T.ScaleByRms(), T.ScaleByLR(lr)],
        "sgd": lambda: [T.ScaleByLR(lr)],
        "adamw": lambda: [T.ScaleByAdam(), T.AddDecayedWeights(1e-4), T.ScaleByLR(lr)],
        "adamax": lambda: [T.ScaleByAdamax(), T.ScaleByLR(lr)],
        "adagrad": lambda: [T.ScaleByRss(), T.ScaleByLR(lr)],
        "nadam": lambda: [T.ScaleByAdam(nesterov=True), T.ScaleByLR(lr)],
        "radam": lambda: [T.ScaleByRadam(), T.ScaleByLR(lr)],
        # the Adam relatives
        "amsgrad": lambda: [T.ScaleByAmsgrad(), T.ScaleByLR(lr)],
        "adabelief": lambda: [T.ScaleByBelief(), T.ScaleByLR(lr)],
        "yogi": lambda: [T.ScaleByYogi(), T.ScaleByLR(lr)],
        "nadamw": lambda: [T.ScaleByAdam(nesterov=True), T.AddDecayedWeights(1e-4),
                           T.ScaleByLR(lr)],
        "adamaxw": lambda: [T.ScaleByAdamax(), T.AddDecayedWeights(1e-4), T.ScaleByLR(lr)],
        "lion": lambda: [T.ScaleByLion(), T.AddDecayedWeights(1e-3), T.ScaleByLR(lr)],
        "adan": lambda: [T.ScaleByAdan(), T.ScaleByLR(lr)],
        "lamb": lambda: [T.ScaleByAdam(eps=1e-6), T.ScaleByTrustRatio(), T.ScaleByLR(lr)],
        "novograd": lambda: [T.ScaleByNovograd(), T.ScaleByLR(lr)],
        # optimism = learning_rate, then scale_by_learning_rate(1.0): -1
        "optimistic_adam": lambda: [T.ScaleByAdam(nesterov=True),
                                    T.ScaleByOptimisticGradient(lr.value, lr.value),
                                    T.Scale(-1.0)],
        "optimistic_adam_v2": lambda: [T.ScaleByAdam(nesterov=True),
                                       T.ScaleByOptimisticGradient(), T.ScaleByLR(lr)],
        "optimistic_gradient_descent": lambda: [T.ScaleByOptimisticGradient(),
                                                T.ScaleByLR(lr)],
        # the rest
        "adadelta": lambda: [T.ScaleByAdadelta(), T.ScaleByLR(lr)],
        "adafactor": lambda: [T.ScaleByFactoredRms(), T.ClipByBlockRms(1.0),
                              T.ScaleByLR(lr, flip_sign=False), T.ScaleByParamBlockRms(),
                              T.Scale(-1)],
        "fromage": lambda: [T.ScaleByTrustRatio(min_norm=1e-6), T.FromageStep(lr),
                            T.FromageDecay(lr)],
        "lars": lambda: [T.ScaleByTrustRatio(trust_coefficient=1e-3), T.ScaleByLR(lr),
                         T.Trace(0.9)],
        "noisy_sgd": lambda: [T.AddNoise(), T.ScaleByLR(lr)],
        "rprop": lambda: [T.ScaleByRprop(lr.value), T.Scale(-1.0)],
        "sign_sgd": lambda: [T.ScaleBySign(), T.ScaleByLR(lr)],
        "sm3": lambda: [T.ScaleBySM3(), T.Scale(-lr.value)],
    }


SUPPORTED = tuple(_aliases(T.Schedule(1.0, 0)))
# optax builds these from a float learning rate only: under the linear
# schedule optimistic_adam raises ValueError, rprop and sm3 TypeError
NO_SCHEDULE = ("optimistic_adam", "rprop", "sm3")
# optax aliases whose update needs the loss value (value_fn / value)
NEED_LOSS = ("lbfgs", "polyak_sgd")


class Optimizer:
    """``init(params) -> state``, ``update(grads, state, params) ->
    (params, state)``, ``step_size(count)``: the learning rate at the
    update whose pre-increment count is ``count``."""

    def __init__(self, name: str, learning_rate: float, clip_gradients: float = 0.0,
                 anneal_steps: int = 0):
        self.name = name
        self.clip = clip_gradients if clip_gradients and clip_gradients > 0 else 0.0
        self.schedule = T.Schedule(learning_rate,
                                   anneal_steps if anneal_steps and anneal_steps > 0 else 0)
        self.transforms: List[T.Transform] = _aliases(self.schedule)[name]()

    def layout(self, count: int, fields: dict) -> dict:
        """The state of ``count`` and the transforms' trees ``fields``;
        adam keeps the flat layout its checkpoints were written in."""
        return {"count": count, **fields} if self.name == "adam" else \
            {"count": count, self.name: fields}

    def trees(self, state) -> dict:
        """The transforms' trees of ``state``, without the count."""
        if self.name == "adam":
            return {k: v for k, v in state.items() if k != "count"}
        return state[self.name]

    def init(self, params) -> dict:
        fields = {}
        for t in self.transforms:
            fields.update(t.init(params))
        return self.layout(0, fields)

    def step_size(self, count: int) -> float:
        return float(self.schedule(count))

    def update(self, grads, state, params):
        """→ (new params, new state)."""
        with span("optim.update"):
            count, fields = state["count"], self.trees(state)
            u = grads
            if self.clip:
                norm = global_norm(u)
                u = tree_map(lambda g: torch.where(norm < self.clip, g, (g / norm) * self.clip),
                             u)
            new = {}
            for t in self.transforms:
                u, s = t.update(u, {f: fields[f] for f in t.fields}, params, count)
                new.update(s)
            return tree_map(lambda p, d: p + d, params, u), self.layout(count + 1, new)


def make_optimizer(name: str, learning_rate: float, clip_gradients: float = 0.0,
                   anneal_steps: int = 0) -> Optimizer:
    """``anneal_steps > 0`` decays the LR linearly to 0 over that many
    updates. Refuses what the JAX package cannot train with: the names in
    ``NO_SCHEDULE`` under a schedule, ``NEED_LOSS``, and names that are no
    optax alias."""
    name = name.lower()
    if name in NEED_LOSS:
        raise ValueError(f"optimizer {name!r} needs the loss value at every update, which "
                         f"make_optimizer's update(grads, state, params) does not pass")
    if name not in SUPPORTED:
        raise ValueError(f"optimizer {name!r} is not an optax alias that cleanmarl_tpu_torch "
                         f"carries (supported: {', '.join(SUPPORTED)})")
    if name in NO_SCHEDULE and anneal_steps and anneal_steps > 0:
        raise ValueError(f"optimizer {name!r} takes a constant learning rate only (optax "
                         f"refuses it under a schedule): turn the LR anneal off "
                         f"(anneal_steps 0, --anneal_lr false)")
    return Optimizer(name, learning_rate, clip_gradients, anneal_steps)
