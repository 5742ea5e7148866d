"""Environment wrappers (port of ``cleanmarl_tpu/envs/wrappers.py``).

``AgentIDWrapper`` appends a one-hot agent id to each agent's
observation.
"""
from __future__ import annotations

import torch

from cleanmarl_tpu_torch.envs.base import Environment


class AgentIDWrapper(Environment):
    def __init__(self, env: Environment):
        self.env = env
        self.n_agents = env.n_agents
        self.obs_dim = env.obs_dim + env.n_agents
        self.state_dim = env.state_dim
        self.n_actions = env.n_actions
        self.episode_limit = env.episode_limit
        self.device = env.device
        self._eye = torch.eye(self.n_agents, device=self.device)

    def _augment(self, ts):
        eye = self._eye.to(ts.obs.dtype).expand(ts.obs.shape[0], -1, -1)
        return ts.replace(obs=torch.cat([ts.obs, eye], dim=-1))

    def _reset(self, num_envs, generator):
        state, ts = self.env.reset(num_envs, generator)
        return state, self._augment(ts)

    def _step(self, state, actions, generator):
        state, ts = self.env.step(state, actions, generator)
        return state, self._augment(ts)
