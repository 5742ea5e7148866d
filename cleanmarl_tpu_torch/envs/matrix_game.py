"""Deterministic cooperative matrix game, batched (port of
``cleanmarl_tpu/envs/matrix_game.py``).

At step t the target action ``g = t mod n_actions`` is shown to every
agent as a one-hot observation; team reward = (#agents choosing g) /
n_agents. At odd steps ``(g+1) mod n_actions`` is unavailable (when
``mask_trick``). With ``done_on_jackpot`` an all-hit step ends the
episode with a +1 bonus; otherwise episodes truncate at
``episode_limit``.
"""
from __future__ import annotations

import dataclasses

import torch

from cleanmarl_tpu_torch.envs.base import Environment
from cleanmarl_tpu_torch.types import TimeStep


@dataclasses.dataclass(frozen=True)
class MatrixGameState:
    t: torch.Tensor  # (N,) int64


class MatrixGame(Environment):
    def __init__(self, n_agents: int = 2, n_actions: int = 3,
                 episode_limit: int = 8, done_on_jackpot: bool = False,
                 mask_trick: bool = True, device="cpu"):
        self.n_agents = n_agents
        self.n_actions = n_actions
        self.episode_limit = episode_limit
        self.done_on_jackpot = done_on_jackpot
        self.mask_trick = mask_trick
        self.obs_dim = n_actions
        self.state_dim = n_actions * n_agents
        self.device = torch.device(device)

    def _obs(self, t):
        g = torch.remainder(t, self.n_actions)
        onehot = torch.nn.functional.one_hot(g, self.n_actions).float()
        obs = onehot[:, None, :].expand(-1, self.n_agents, -1).contiguous()
        return obs, obs.reshape(obs.shape[0], -1)

    def _avail(self, t):
        n = t.shape[0]
        avail = torch.ones((n, self.n_agents, self.n_actions), dtype=torch.bool,
                           device=self.device)
        if not self.mask_trick:
            return avail
        g = torch.remainder(t, self.n_actions)
        blocked = torch.remainder(g + 1, self.n_actions)
        odd = torch.remainder(t, 2) == 1
        cols = torch.arange(self.n_actions, device=self.device)
        hit = (cols[None, :] == blocked[:, None]) & odd[:, None]      # (N,K)
        return avail & ~hit[:, None, :]

    def _timestep(self, t, reward, done, truncated, won):
        obs, state = self._obs(t)
        return TimeStep(obs=obs, state=state, avail=self._avail(t),
                        reward=reward, done=done, truncated=truncated,
                        info={"battle_won": won})

    def _reset(self, num_envs, generator):
        t = torch.zeros((num_envs,), dtype=torch.int64, device=self.device)
        z = torch.zeros((num_envs,), device=self.device)
        f = torch.zeros((num_envs,), dtype=torch.bool, device=self.device)
        return MatrixGameState(t=t), self._timestep(t, z, f, f, z)

    def _step(self, state: MatrixGameState, actions, generator):
        g = torch.remainder(state.t, self.n_actions)
        hits = actions == g[:, None]
        reward = hits.float().mean(-1)
        jackpot = hits.all(-1)
        done = jackpot & self.done_on_jackpot
        reward = reward + done.float()
        t2 = state.t + 1
        truncated = (t2 >= self.episode_limit) & ~done
        return MatrixGameState(t=t2), self._timestep(
            t2, reward, done, truncated, jackpot.float()
        )
