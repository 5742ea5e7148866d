"""Multi-agent Particle Environments, batched (port of
``cleanmarl_tpu/envs/mpe.py``): ``simple_spread_v3``,
``simple_speaker_listener_v4`` and ``simple_reference_v3``.

The MPE core dynamics as the JAX package writes them, over a leading env
axis:

- integrator: ``v ← v·(1−damping) + F·dt``, ``x ← x + v·dt`` with
  dt=0.1, damping=0.25, mass 1;
- discrete action → force: {1:+x, 2:−x, 3:+y, 4:−y} scaled by 5.0;
- soft contact between collidable entities:
  ``penetration = softplus(−(dist−dist_min)/k)·k``, contact force 100,
  margin k=1e-3, equal and opposite.

CTDE contract of the reference's PettingZoo wrapper: obs stacked per
agent (heterogeneous obs zero-padded to the longest), state = the concat
of the obs, team reward = agent 0's reward, avail pads heterogeneous
action spaces, and episodes always truncate at ``max_cycles``.

A step never draws random numbers: it is a function of the state and the
actions. Only ``_reset`` draws, from the caller's generator.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.envs.base import Environment
from cleanmarl_tpu_torch.types import TimeStep

DT = 0.1
DAMPING = 0.25
SENSITIVITY = 5.0
CONTACT_FORCE = 1e2
CONTACT_MARGIN = 1e-3


def action_force(actions: torch.Tensor, n_actions: int = 5) -> torch.Tensor:
    """Discrete action index → 2D control force: u_x = onehot[1] −
    onehot[2], u_y = onehot[3] − onehot[4], times the sensitivity.
    actions (...) int → (..., 2) f32."""
    onehot = F.one_hot(actions, n_actions).float()
    ux = onehot[..., 1] - onehot[..., 2]
    uy = onehot[..., 3] - onehot[..., 4]
    return torch.stack([ux, uy], dim=-1) * SENSITIVITY


def collision_forces(pos: torch.Tensor, sizes: torch.Tensor,
                     collide: torch.Tensor) -> torch.Tensor:
    """Pairwise soft-contact forces. pos (..., E, 2), sizes (E,), collide
    (E,) bool → the force on each entity (..., E, 2)."""
    delta = pos[..., :, None, :] - pos[..., None, :, :]           # (..., E, E, 2)
    dist = torch.sqrt(torch.sum(torch.square(delta), dim=-1) + 1e-12)
    dist_min = sizes[:, None] + sizes[None, :]
    k = CONTACT_MARGIN
    penetration = F.softplus(-(dist - dist_min) / k) * k
    E = pos.shape[-2]
    pair = (collide[:, None] & collide[None, :]
            & ~torch.eye(E, dtype=torch.bool, device=pos.device))
    mag = torch.where(pair, CONTACT_FORCE * penetration, 0.0)
    direction = delta / dist[..., None]
    return torch.sum(direction * mag[..., None], dim=-2)


def integrate(pos, vel, force, movable, max_speed=None):
    """MPE ``integrate_state``. pos/vel/force (..., E, 2), movable (E,) bool."""
    vel = vel * (1.0 - DAMPING) + force * DT
    if max_speed is not None:
        speed = torch.sqrt(torch.sum(torch.square(vel), dim=-1, keepdim=True) + 1e-12)
        vel = torch.where(speed > max_speed, vel / speed * max_speed, vel)
    vel = vel * movable[:, None]
    return pos + vel * DT, vel


@dataclasses.dataclass(frozen=True)
class MPEState:
    agent_pos: torch.Tensor     # (N, n_agents, 2)
    agent_vel: torch.Tensor     # (N, n_agents, 2)
    landmark_pos: torch.Tensor  # (N, n_landmarks, 2)
    comm: torch.Tensor          # (N, speakers, c_dim) communication state
    goal: torch.Tensor          # (N,) or (N, 2) int64, per scenario (spread: 0)
    t: torch.Tensor             # (N,) int64


class _MPE(Environment):
    def _uniform(self, generator, shape, bound: float):
        return (torch.rand(shape, generator=generator, device=self.device) * 2.0 - 1.0) * bound

    def _timestep(self, obs, avail, reward, truncated) -> TimeStep:
        n = obs.shape[0]
        return TimeStep(
            obs=obs, state=obs.reshape(n, -1), avail=avail, reward=reward,
            done=torch.zeros((n,), dtype=torch.bool, device=self.device),
            truncated=truncated,
            info={"battle_won": torch.zeros((n,), device=self.device)})

    def _all_avail(self, n):
        return torch.ones((n, self.n_agents, self.n_actions), dtype=torch.bool,
                          device=self.device)


class SimpleSpread(_MPE):
    """``simple_spread_v3``: N agents must cover N landmarks.

    r_i = (1 − local_ratio)·(−Σ_l min_a d(a, l)) + local_ratio·(−#agents
    colliding with i); the team reward is r_0. Obs (18 for N=3):
    [self_vel, self_pos, landmark_rel ×N, other_rel ×(N−1), other_comm
    ×(N−1)·c_dim], comm always zero.
    """

    def __init__(self, n_agents: int = 3, local_ratio: float = 0.5,
                 max_cycles: int = 25, device="cuda"):
        self.n_agents = n_agents
        self.n_landmarks = n_agents
        self.local_ratio = local_ratio
        self.episode_limit = max_cycles
        self.n_actions = 5
        self.c_dim = 2
        self.agent_size = 0.15
        self.landmark_size = 0.05
        self.obs_dim = 2 + 2 + 2 * self.n_landmarks + 2 * (n_agents - 1) \
            + self.c_dim * (n_agents - 1)
        self.state_dim = self.obs_dim * n_agents
        self.device = resolve_device(device)
        # others[i] = every agent but i, in order (the JAX jnp.delete)
        self._others = torch.tensor(
            [[j for j in range(n_agents) if j != i] for i in range(n_agents)],
            dtype=torch.int64, device=self.device)
        E = n_agents + self.n_landmarks
        self._sizes = torch.tensor([self.agent_size] * n_agents
                                   + [self.landmark_size] * self.n_landmarks,
                                   device=self.device)
        self._collide = torch.arange(E, device=self.device) < n_agents
        self._movable = torch.ones((n_agents,), dtype=torch.bool, device=self.device)
        self._eye = torch.eye(n_agents, dtype=torch.bool, device=self.device)

    def _obs(self, s: MPEState) -> torch.Tensor:
        n, na = s.agent_pos.shape[0], self.n_agents
        pos = s.agent_pos
        rel_lm = (s.landmark_pos[:, None] - pos[:, :, None]).reshape(n, na, -1)
        rel_other = (pos[:, self._others] - pos[:, :, None]).reshape(n, na, -1)
        other_comm = s.comm[:, self._others].reshape(n, na, -1)
        return torch.cat([s.agent_vel, pos, rel_lm, rel_other, other_comm], dim=-1)

    def _reset(self, num_envs, generator):
        na, nl = self.n_agents, self.n_landmarks
        s = MPEState(
            agent_pos=self._uniform(generator, (num_envs, na, 2), 1.0),
            agent_vel=torch.zeros((num_envs, na, 2), device=self.device),
            landmark_pos=self._uniform(generator, (num_envs, nl, 2), 0.9),
            comm=torch.zeros((num_envs, na, self.c_dim), device=self.device),
            goal=torch.zeros((num_envs,), dtype=torch.int64, device=self.device),
            t=torch.zeros((num_envs,), dtype=torch.int64, device=self.device),
        )
        f = torch.zeros((num_envs,), dtype=torch.bool, device=self.device)
        return s, self._timestep(self._obs(s), self._all_avail(num_envs),
                                 torch.zeros((num_envs,), device=self.device), f)

    def _step(self, s: MPEState, actions, generator):
        na = self.n_agents
        u = action_force(actions, self.n_actions)
        pos = torch.cat([s.agent_pos, s.landmark_pos], dim=1)
        forces = collision_forces(pos, self._sizes, self._collide)
        agent_pos, agent_vel = integrate(s.agent_pos, s.agent_vel, forces[:, :na] + u,
                                         self._movable)
        t2 = s.t + 1
        s2 = dataclasses.replace(s, agent_pos=agent_pos, agent_vel=agent_vel, t=t2)

        d = torch.sqrt(torch.sum(torch.square(
            agent_pos[:, :, None] - s.landmark_pos[:, None]), dim=-1))   # (N, na, nl)
        global_rew = -torch.sum(torch.min(d, dim=1).values, dim=-1)
        da = torch.sqrt(torch.sum(torch.square(
            agent_pos[:, :, None] - agent_pos[:, None]), dim=-1) + 1e-12)
        coll = (da < 2 * self.agent_size) & ~self._eye
        local_rew0 = -torch.sum(coll[:, 0].float(), dim=-1)
        reward = (1.0 - self.local_ratio) * global_rew + self.local_ratio * local_rew0
        return s2, self._timestep(self._obs(s2), self._all_avail(actions.shape[0]),
                                  reward, t2 >= self.episode_limit)


class SimpleSpeakerListener(_MPE):
    """``simple_speaker_listener_v4``: a static speaker sees which of 3
    landmarks is the listener's goal and says one of 3 symbols; the mobile
    listener hears it and must reach the goal. Reward −‖listener − goal‖²
    for both.

    Agents [speaker, listener]. Speaker Discrete(3), listener Discrete(5),
    padded to 5 with avail masks. Obs: speaker (3,) = goal color, listener
    (11,) = [self_vel, landmark_rel ×3, comm(3)], zero-padded to 11. The
    utterance reaches the listener's obs on the next step.
    """

    def __init__(self, max_cycles: int = 25, device="cuda"):
        self.n_agents = 2
        self.n_landmarks = 3
        self.episode_limit = max_cycles
        self.n_actions = 5          # padded; the speaker has 3
        self.c_dim = 3
        self.obs_dim = 11           # max(3, 11)
        self.state_dim = self.obs_dim * 2
        self.landmark_size = 0.04
        self.listener_size = 0.075
        self.device = resolve_device(device)
        self._avail_row = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                                       dtype=torch.bool, device=self.device)

    def _obs(self, s: MPEState) -> torch.Tensor:
        n = s.agent_pos.shape[0]
        goal_color = F.one_hot(s.goal, 3).float() * 0.75
        speaker = torch.cat([goal_color, torch.zeros((n, self.obs_dim - 3),
                                                     device=self.device)], dim=-1)
        rel_lm = (s.landmark_pos - s.agent_pos[:, 1:2]).reshape(n, -1)
        listener = torch.cat([s.agent_vel[:, 1], rel_lm, s.comm[:, 0]], dim=-1)
        return torch.stack([speaker, listener], dim=1)

    def _avail(self, n):
        return self._avail_row.expand(n, -1, -1)

    def _reset(self, num_envs, generator):
        dev = self.device
        s = MPEState(
            agent_pos=self._uniform(generator, (num_envs, 2, 2), 1.0),
            agent_vel=torch.zeros((num_envs, 2, 2), device=dev),
            landmark_pos=self._uniform(generator, (num_envs, 3, 2), 0.9),
            comm=torch.zeros((num_envs, 1, self.c_dim), device=dev),
            goal=torch.randint(0, 3, (num_envs,), generator=generator, device=dev),
            t=torch.zeros((num_envs,), dtype=torch.int64, device=dev),
        )
        f = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        return s, self._timestep(self._obs(s), self._avail(num_envs),
                                 torch.zeros((num_envs,), device=dev), f)

    def _step(self, s: MPEState, actions, generator):
        n = actions.shape[0]
        # the listener (agent 1) moves; the speaker is immobile
        u = action_force(actions[:, 1], self.n_actions)
        vel = s.agent_vel[:, 1] * (1.0 - DAMPING) + u * DT
        pos = s.agent_pos[:, 1] + vel * DT
        agent_pos, agent_vel = s.agent_pos.clone(), s.agent_vel.clone()
        agent_pos[:, 1] = pos
        agent_vel[:, 1] = vel
        # the speaker's utterance; its padded actions 3 and 4 clip to 2
        say = torch.clamp(actions[:, 0], 0, self.c_dim - 1)
        comm = F.one_hot(say, self.c_dim).float()[:, None, :]
        t2 = s.t + 1
        s2 = dataclasses.replace(s, agent_pos=agent_pos, agent_vel=agent_vel,
                                 comm=comm, t=t2)
        goal_pos = s.landmark_pos[torch.arange(n, device=self.device), s.goal]
        reward = -torch.sum(torch.square(pos - goal_pos), dim=-1)
        return s2, self._timestep(self._obs(s2), self._avail(n), reward,
                                  t2 >= self.episode_limit)


class SimpleReference(_MPE):
    """``simple_reference_v3``: 2 mobile agents, 3 colored landmarks. Each
    agent privately sees the landmark the OTHER agent must reach, and
    both move and say one of 10 symbols.

    - action Discrete(50): ``move = a % 5``, ``say = a // 5``;
    - obs (21,): [self_vel(2), landmark_rel(6), goal_color(3),
      other_comm(10)], goal colors 0.25 + 0.5·onehot(goal);
    - reward 0.5·local_0 + 0.5·mean_j local_j with local_i = −dist²(other
      agent, the landmark agent i assigned it);
    - agents do not collide; utterances reach the next step's obs.
    """

    def __init__(self, max_cycles: int = 25, local_ratio: float = 0.5, device="cuda"):
        self.n_agents = 2
        self.n_landmarks = 3
        self.episode_limit = max_cycles
        self.local_ratio = local_ratio
        self.c_dim = 10
        self.n_move = 5
        self.n_actions = self.n_move * self.c_dim     # Discrete(50)
        self.obs_dim = 2 + 2 * self.n_landmarks + 3 + self.c_dim
        self.state_dim = self.obs_dim * self.n_agents
        self.device = resolve_device(device)
        self._other = torch.tensor([1, 0], dtype=torch.int64, device=self.device)
        self._movable = torch.ones((2,), dtype=torch.bool, device=self.device)

    def _obs(self, s: MPEState) -> torch.Tensor:
        n = s.agent_pos.shape[0]
        # goal[i] = the landmark the other agent must reach, seen by agent i
        goal_color = 0.25 + 0.5 * F.one_hot(s.goal, self.n_landmarks).float()
        rel_lm = (s.landmark_pos[:, None] - s.agent_pos[:, :, None]).reshape(n, 2, -1)
        return torch.cat([s.agent_vel, rel_lm, goal_color, s.comm[:, self._other]], dim=-1)

    def _reset(self, num_envs, generator):
        dev = self.device
        s = MPEState(
            agent_pos=self._uniform(generator, (num_envs, 2, 2), 1.0),
            agent_vel=torch.zeros((num_envs, 2, 2), device=dev),
            landmark_pos=self._uniform(generator, (num_envs, 3, 2), 1.0),
            comm=torch.zeros((num_envs, 2, self.c_dim), device=dev),
            goal=torch.randint(0, self.n_landmarks, (num_envs, 2), generator=generator,
                               device=dev),
            t=torch.zeros((num_envs,), dtype=torch.int64, device=dev),
        )
        f = torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        return s, self._timestep(self._obs(s), self._all_avail(num_envs),
                                 torch.zeros((num_envs,), device=dev), f)

    def _step(self, s: MPEState, actions, generator):
        n = actions.shape[0]
        move = torch.remainder(actions, self.n_move)
        say = torch.div(actions, self.n_move, rounding_mode="floor")
        u = action_force(move, self.n_move)
        agent_pos, agent_vel = integrate(s.agent_pos, s.agent_vel, u, self._movable)
        comm = F.one_hot(say, self.c_dim).float()
        t2 = s.t + 1
        s2 = dataclasses.replace(s, agent_pos=agent_pos, agent_vel=agent_vel,
                                 comm=comm, t=t2)
        goal_pos = s.landmark_pos[torch.arange(n, device=self.device)[:, None], s.goal]
        local = -torch.sum(torch.square(agent_pos[:, self._other] - goal_pos), dim=-1)
        reward = (self.local_ratio * local[:, 0]
                  + (1.0 - self.local_ratio) * torch.mean(local, dim=-1))
        return s2, self._timestep(self._obs(s2), self._all_avail(n), reward,
                                  t2 >= self.episode_limit)


def make(env_name: str, device="cuda", **kwargs) -> Environment:
    name = env_name.lower()
    if name.startswith("simple_spread"):
        return SimpleSpread(device=device, **kwargs)
    if name.startswith("simple_speaker_listener"):
        return SimpleSpeakerListener(device=device, **kwargs)
    if name.startswith("simple_reference"):
        return SimpleReference(device=device, **kwargs)
    raise ValueError(
        f"unknown MPE scenario {env_name!r}; available: simple_spread_v3, "
        f"simple_speaker_listener_v4, simple_reference_v3"
    )
