"""Action selection on the device (port of ``cleanmarl_tpu/core/acting.py``).

ε-greedy takes, with probability ε, a uniform action among the available
ones, else the avail-masked argmax of Q. The coin is one per env, so all
agents of an env explore together; no branch reaches the host.
"""
from __future__ import annotations

import torch

from cleanmarl_tpu_torch.envs.base import categorical


def masked_argmax(q: torch.Tensor, avail: torch.Tensor) -> torch.Tensor:
    """Greedy actions over the available ones (the first maximum on ties).
    q, avail (..., A) → (...) int64."""
    return torch.argmax(torch.where(avail.bool(), q, float("-inf")), dim=-1)


def masked_uniform(generator, avail: torch.Tensor) -> torch.Tensor:
    """Uniform sample over the available actions. avail (..., A) → (...)."""
    return categorical(torch.where(avail.bool(), 0.0, float("-inf")), generator)


def eps_greedy(generator, q: torch.Tensor, avail: torch.Tensor,
               epsilon: float) -> torch.Tensor:
    """q, avail: (num_envs, n_agents, A) → (num_envs, n_agents) int64."""
    explore = torch.rand((q.shape[0],), generator=generator, device=q.device) < epsilon
    random_actions = masked_uniform(generator, avail)
    return torch.where(explore[:, None], random_actions, masked_argmax(q, avail))
