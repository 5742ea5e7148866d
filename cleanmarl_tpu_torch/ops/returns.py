"""λ-returns / advantages over auto-reset rollout streams (port of
``cleanmarl_tpu/ops/returns.py``).

    G_t = r_t + γ(1−ended_t)·(λ·G_{t+1} + (1−λ)·V_{t+1}),   G_T = V_T

``use_kernel=None`` picks by device: a CUDA tensor goes to the CUDA
kernel (``ops/returns_kernel.py``, one launch for G and A), a CPU tensor
to the plain reverse loop. ``use_kernel=False`` asks for the plain loop
on any device. Inputs are (T, ...) as in the JAX package; a team reward
or flag broadcast over trailing axes (``x[..., None].expand(...)``) is
read in place, not copied.
"""
from __future__ import annotations

import torch

from cleanmarl_tpu_torch.ops.returns_kernel import (
    lambda_returns_kernel, lambda_returns_plain,
)


def _flat_args(rewards, ended, values, bootstrap_value):
    """The dtypes both versions take; layouts stay as they are (the kernel
    wrapper reads an input broadcast over trailing axes through its base,
    ``returns_kernel.repeat_base``, and copies any other non-contiguous one)."""
    return rewards.float(), ended.bool(), values.float(), bootstrap_value.float()


def lambda_advantages(rewards, ended, values, bootstrap_value, gamma, lam,
                      use_kernel: bool | None = None):
    """(G, A) with A_t = G_t − V_t."""
    if use_kernel is None:
        use_kernel = values.is_cuda
    args = _flat_args(rewards, ended, values, bootstrap_value)
    if use_kernel:
        return lambda_returns_kernel(*args, gamma, lam)
    return lambda_returns_plain(*args, gamma, lam)


def lambda_returns(rewards, ended, values, bootstrap_value, gamma: float,
                   lam: float, use_kernel: bool | None = None) -> torch.Tensor:
    """Returns G (T, ...). Time axis is leading."""
    return lambda_advantages(rewards, ended, values, bootstrap_value, gamma,
                             lam, use_kernel)[0]


def nstep_returns(rewards, ended, values, bootstrap_value, gamma: float,
                  n: int) -> torch.Tensor:
    """n-step targets over an auto-reset rollout stream: n sweeps of
    G^{(k)}_t = r_t + γ(1−e_t)·G^{(k−1)}_{t+1} from G^{(0)} = values (the
    window truncates at episode boundaries and bootstraps at the cut)."""
    if n < 1:
        raise ValueError(f"nsteps must be >= 1, got {n}")
    ended_f = ended.to(values.dtype)
    g = values
    for _ in range(n):
        g_next = torch.cat([g[1:], bootstrap_value[None]], dim=0)
        g = rewards + gamma * (1.0 - ended_f) * g_next
    return g
