"""Core types shared across envs and algorithms (port of
``cleanmarl_tpu/types.py``).

A ``TimeStep`` here is always batched: every field carries a leading
``num_envs`` axis, because the envs are natively batched tensors
programs rather than per-env functions under vmap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class TimeStep:
    """One batched env step. Shapes: obs (N, n_agents, obs_dim), state
    (N, state_dim), avail (N, n_agents, n_actions) bool, reward (N,) f32,
    done (N,) bool, truncated (N,) bool, info: dict of (N,) f32."""

    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    truncated: torch.Tensor
    info: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "TimeStep":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Transition:
    """A replay transition with the team reward and a shared done flag.
    Shapes per row: obs (n_agents, obs_dim), state (state_dim,), avail
    (n_agents, n_actions) bool, action (n_agents,) int64, reward () f32,
    done () bool, and the next_* fields like their current ones."""

    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor
    next_state: torch.Tensor
    next_avail: torch.Tensor
