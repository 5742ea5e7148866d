"""Host-side PettingZoo adapter (port of
``cleanmarl_tpu/envs/pettingzoo_host.py``, a numpy copy: the port imports
nothing of the JAX package).

For environments that exist only as Python code (any installed
PettingZoo parallel env, e.g. ``pettingzoo.sisl.pursuit_v4``), this
reproduces the reference wrapper's semantics as a numpy host object, and
``envs/external.HostVecEnv`` steps a batch of them for the algorithms:

- obs dict → stacked array, heterogeneous obs flattened and zero-padded
  to the longest;
- global state = concatenation of all raw obs;
- heterogeneous action spaces padded to the longest with avail masks;
- team reward = rewards[agents[0]];
- PettingZoo's empty dicts at termination → the last obs is kept;
- optional one-hot agent-id concat.
"""
from __future__ import annotations

import importlib
from typing import Optional

import numpy as np


class PettingZooHostEnv:
    """One host env with the reference CommonInterface surface."""

    def __init__(self, family: str, env_name: str, agent_ids: bool = False,
                 **kwargs):
        mod = importlib.import_module(f"pettingzoo.{family}.{env_name}")
        self.env = mod.parallel_env(**kwargs)
        self.env.reset()
        self.n_agents = self.env.num_agents
        self.agents = list(self.env.agents)
        self.agent_ids = agent_ids
        self._act_spaces = [self.env.action_space(a) for a in self.agents]
        self._obs_spaces = [self.env.observation_space(a) for a in self.agents]
        self.n_actions = max(sp.n for sp in self._act_spaces)
        self._raw_obs_dims = [int(np.prod(sp.shape)) for sp in self._obs_spaces]
        self._max_obs = max(self._raw_obs_dims)
        self.obs_dim = self._max_obs + (self.n_agents if agent_ids else 0)
        self.state_dim = self._max_obs * self.n_agents
        self.episode_limit = getattr(
            self.env.unwrapped, "max_cycles", 500
        )
        self._last_obs = None
        self._state = np.zeros((self.state_dim,), np.float32)

    # ------------------------------------------------------------------
    def _process_obs(self, obs_dict) -> np.ndarray:
        rows = []
        for i, agent in enumerate(self.agents):
            flat = np.asarray(obs_dict[agent], np.float32).reshape(-1)
            if flat.shape[0] < self._max_obs:
                flat = np.pad(flat, (0, self._max_obs - flat.shape[0]))
            rows.append(flat)
        obs = np.stack(rows)
        self._state = obs.reshape(-1).astype(np.float32)
        if self.agent_ids:
            obs = np.concatenate([obs, np.eye(self.n_agents, dtype=np.float32)], 1)
        return obs.astype(np.float32)

    def get_avail_actions(self) -> np.ndarray:
        avail = np.zeros((self.n_agents, self.n_actions), bool)
        for i, sp in enumerate(self._act_spaces):
            avail[i, : sp.n] = True
        return avail

    def reset(self, seed: Optional[int] = None):
        obs, _ = self.env.reset(seed=seed)
        obs = self._process_obs(obs)
        self._last_obs = obs
        return obs

    def step(self, actions: np.ndarray):
        acts = {
            agent: int(np.clip(actions[i], 0, self._act_spaces[i].n - 1))
            for i, agent in enumerate(self.agents)
        }
        obs_d, rew_d, done_d, trunc_d, _ = self.env.step(acts)
        done = all(done_d.values()) if done_d else True
        truncated = all(trunc_d.values()) if trunc_d else False
        if len(obs_d) == 0:  # PZ returns empty dicts on termination
            obs = self._last_obs
            reward = 0.0
        else:
            obs = self._process_obs(obs_d)
            self._last_obs = obs
            reward = float(rew_d[self.agents[0]])
        return obs, reward, done, truncated

    def get_state(self) -> np.ndarray:
        return self._state

    def close(self):
        self.env.close()
