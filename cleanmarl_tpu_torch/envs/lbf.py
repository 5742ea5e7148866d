"""Level-Based Foraging, natively batched (port of
``cleanmarl_tpu/envs/lbf.py``).

Same rules, obs layout and map names as the JAX module (see its
docstring): an S×S grid with P players and F foods; actions 0 NONE,
1 NORTH (y−1), 2 SOUTH (y+1), 3 WEST (x−1), 4 EAST (x+1), 5 LOAD. A move
succeeds iff its target is inside the grid, not a live food, not the
target of another player and not another player's cell. Players next to a
live food (L1 distance 1) that LOAD collect it iff their levels sum to at
least its level; each loader earns ``food_level · level / Σ loader
levels``, divided by the episode's total food level. The episode ends
when every food is collected and truncates at ``time_limit``.

Obs per agent (3F + 3P): per-food (y, x, level), eaten foods at
(−1, −1, 0), then the player triples self first and the others in index
order. State = the agents' obs concatenated. Every action is always
available. ``info["agent_rewards"]`` holds the per-agent rewards that
COMA's ``per_agent_rewards`` reads; the team reward is their sum or mean
(``reward_aggr``).

Every state field carries a leading env axis. Reset draws a per-env
permutation of the cells and the levels from the caller's
``torch.Generator``; ``_step`` is deterministic.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.envs.base import Environment
from cleanmarl_tpu_torch.types import TimeStep

NONE, NORTH, SOUTH, WEST, EAST, LOAD = range(6)
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, 0))   # (dy, dx)


@dataclasses.dataclass(frozen=True)
class LBFState:
    player_pos: torch.Tensor    # (N, P, 2) int64 (y, x)
    player_level: torch.Tensor  # (N, P) int64
    food_pos: torch.Tensor      # (N, F, 2) int64
    food_level: torch.Tensor    # (N, F) int64, 0 once collected
    total_food: torch.Tensor    # (N,) f32: the food levels spawned
    t: torch.Tensor             # (N,) int64


class LBF(Environment):
    def __init__(self, grid_size: int = 8, n_agents: int = 2, n_foods: int = 3,
                 max_player_level: int = 3, coop: bool = False, time_limit: int = 150,
                 reward_aggr: str = "sum", device="cuda"):
        self.grid_size = grid_size
        self.n_agents = n_agents
        self.n_foods = n_foods
        self.max_player_level = max_player_level
        self.coop = coop
        self.episode_limit = time_limit
        self.reward_aggr = reward_aggr
        self.n_actions = 6
        self.obs_dim = 3 * n_foods + 3 * n_agents
        self.state_dim = self.obs_dim * n_agents
        self.device = dev = resolve_device(device)
        self._moves = torch.tensor(MOVES, dtype=torch.int64, device=dev)
        # row i: player i, then the others in index order (jnp.delete)
        self._order = torch.tensor(
            [[i] + [j for j in range(n_agents) if j != i] for i in range(n_agents)],
            dtype=torch.int64, device=dev)
        self._not_self = ~torch.eye(n_agents, dtype=torch.bool, device=dev)

    # ------------------------------------------------------------------
    def _obs(self, s: LBFState) -> torch.Tensor:
        n, P = s.player_level.shape
        eaten = s.food_level <= 0                                     # (N,F)
        food_feat = torch.cat(
            [torch.where(eaten[..., None], -1, s.food_pos).float(),
             torch.where(eaten, 0, s.food_level).float()[..., None]], dim=-1,
        ).reshape(n, 1, -1).expand(n, P, 3 * self.n_foods)
        player_feat = torch.cat([s.player_pos.float(), s.player_level.float()[..., None]],
                                dim=-1)                               # (N,P,3)
        per_agent = player_feat[:, self._order].reshape(n, P, 3 * P)
        return torch.cat([food_feat, per_agent], dim=-1)

    def _timestep(self, s, reward, done, truncated, agent_rewards) -> TimeStep:
        obs = self._obs(s)
        n = obs.shape[0]
        return TimeStep(
            obs=obs, state=obs.reshape(n, -1),
            avail=torch.ones((n, self.n_agents, self.n_actions), dtype=torch.bool,
                             device=self.device),
            reward=reward, done=done, truncated=truncated,
            info={"battle_won": torch.zeros((n,), device=self.device),
                  "agent_rewards": agent_rewards})

    def _reset(self, num_envs: int, generator):
        S, P, F, dev = self.grid_size, self.n_agents, self.n_foods, self.device
        cells = torch.rand((num_envs, S * S), generator=generator, device=dev).argsort(-1)
        to_yx = lambda c: torch.stack([c // S, c % S], dim=-1)  # noqa: E731
        player_level = torch.randint(1, self.max_player_level + 1, (num_envs, P),
                                     generator=generator, device=dev)
        if self.coop:
            food_level = player_level.sum(-1, keepdim=True).expand(num_envs, F).clone()
        else:
            food_level = torch.randint(1, self.max_player_level + 1, (num_envs, F),
                                       generator=generator, device=dev)
        s = LBFState(player_pos=to_yx(cells[:, :P]), player_level=player_level,
                     food_pos=to_yx(cells[:, P:P + F]), food_level=food_level,
                     total_food=food_level.sum(-1).float(),
                     t=torch.zeros((num_envs,), dtype=torch.int64, device=dev))
        zf = torch.zeros((num_envs,), device=dev)
        fb = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        return s, self._timestep(s, zf, fb, fb, torch.zeros((num_envs, P), device=dev))

    # ------------------------------------------------------------------
    def _step(self, s: LBFState, actions, generator):
        actions = torch.clamp(actions.long(), 0, self.n_actions - 1)

        # ---- movement --------------------------------------------------
        proposed = s.player_pos + self._moves[actions]                # (N,P,2)
        in_bounds = ((proposed >= 0) & (proposed < self.grid_size)).all(-1)
        alive_food = s.food_level > 0                                 # (N,F)
        on_food = ((proposed[:, :, None] == s.food_pos[:, None]).all(-1)
                   & alive_food[:, None, :]).any(-1)
        # same-target conflicts (including moving into a stationary player)
        same_target = (proposed[:, :, None] == proposed[:, None]).all(-1).sum(-1) > 1
        into_player = ((proposed[:, :, None] == s.player_pos[:, None]).all(-1)
                       & self._not_self).any(-1)
        ok = in_bounds & ~on_food & ~same_target & ~into_player
        player_pos = torch.where(ok[..., None], proposed, s.player_pos)

        # ---- loading ---------------------------------------------------
        loading = actions == LOAD
        dist = (player_pos[:, :, None] - s.food_pos[:, None]).abs().sum(-1)   # (N,P,F)
        part = (dist == 1) & loading[..., None] & alive_food[:, None, :]
        loader_sum = (part * s.player_level[..., None]).sum(1)        # (N,F)
        collected = alive_food & (loader_sum >= s.food_level) & (loader_sum > 0)
        share = torch.where(
            collected[:, None, :] & part,
            (s.food_level[:, None, :] * s.player_level[..., None]).float()
            / torch.clamp(loader_sum[:, None, :], min=1).float(), 0.0)      # (N,P,F)
        rewards = share.sum(-1) / torch.clamp(s.total_food, min=1.0)[:, None]
        food_level = torch.where(collected, 0, s.food_level)

        t2 = s.t + 1
        done = (food_level <= 0).all(-1)
        truncated = (t2 >= self.episode_limit) & ~done
        team = rewards.mean(-1) if self.reward_aggr == "mean" else rewards.sum(-1)
        s2 = dataclasses.replace(s, player_pos=player_pos, food_level=food_level, t=t2)
        return s2, self._timestep(s2, team, done, truncated, rewards)


def make(env_name: str, device="cuda", **kwargs) -> Environment:
    m = re.fullmatch(r"Foraging-(\d+)x(\d+)-(\d+)p-(\d+)f(-coop)?(?:-v\d+)?", env_name)
    if not m:
        raise ValueError(
            f"unknown LBF map {env_name!r}; expected "
            f"Foraging-{{S}}x{{S}}-{{P}}p-{{F}}f[-coop]-v3"
        )
    if m.group(1) != m.group(2):
        raise ValueError(f"only square grids supported, got {env_name!r}")
    return LBF(grid_size=int(m.group(1)), n_agents=int(m.group(3)),
               n_foods=int(m.group(4)), coop=m.group(5) is not None, device=device,
               **kwargs)
