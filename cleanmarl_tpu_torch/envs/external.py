"""Host (Python) environments behind the batched env API (port of
``cleanmarl_tpu/envs/external.py``).

A batch of host envs (e.g. a real PettingZoo env, ``envs/pettingzoo_host``)
is stepped serially on the host, finished envs are auto-reset there, and
the arrays come back as tensors on the family's device, so every
algorithm runs on them unchanged. The JAX package needs ``io_callback``
to leave its compiled program; here ``HostVecEnv.step`` moves the actions
to the host once, steps the envs and returns ``(state, ts, final)`` like
``envs/base.VecEnv.step``. Throughput is bounded by the Python envs.

Host protocol of one env: attributes ``n_agents``, ``obs_dim``,
``state_dim``, ``n_actions``, ``episode_limit`` (and optionally
``provides_agent_rewards``); ``reset(seed) -> obs``, ``step(actions) ->
(obs, reward, done, truncated[, info])``, ``get_state()``,
``get_avail_actions()``, ``close()``. An ``info`` dict's ``battle_won``
and, when the env declares ``provides_agent_rewards``, its
``agent_rewards`` ((n_agents,), required on every step) reach the
TimeStep's info in both the live and the pre-reset ``final`` views.

RNG: host envs are seeded from ``np.random.RandomState(seed)`` at every
reset; the torch generator passed to ``reset``/``step`` is ignored, as the
JAX package ignores its key (host randomness cannot come from it).
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.envs.base import VecEnv, categorical
from cleanmarl_tpu_torch.types import TimeStep


class HostEnvFamily:
    """Static metadata of a host env constructor and its vec-env factory.

    Has the attributes of ``Environment`` that the algorithms read
    (n_agents, obs_dim, state_dim, n_actions, episode_limit, device) and
    ``make_vec``, which ``as_vec`` calls in place of ``VecEnv``.
    """

    def __init__(self, make_env: Callable[[], object], seed: int = 0, device="cuda"):
        self._make_env = make_env
        probe = make_env()
        self.n_agents = probe.n_agents
        self.obs_dim = probe.obs_dim
        self.state_dim = probe.state_dim
        self.n_actions = probe.n_actions
        self.episode_limit = probe.episode_limit
        self.provides_agent_rewards = bool(getattr(probe, "provides_agent_rewards", False))
        probe.close()
        self._seed = seed
        self.device = resolve_device(device)

    def make_vec(self, num_envs: int, auto_reset: bool = True) -> "HostVecEnv":
        return HostVecEnv(self, num_envs, auto_reset=auto_reset)


class HostVecEnv:
    """``num_envs`` host envs stepped one after another. The env state the
    algorithms carry is the host step count (an int)."""

    def __init__(self, family: HostEnvFamily, num_envs: int, auto_reset: bool = True):
        self.family = family
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.n_agents = family.n_agents
        self.obs_dim = family.obs_dim
        self.state_dim = family.state_dim
        self.n_actions = family.n_actions
        self.episode_limit = family.episode_limit
        self.device = family.device
        self.envs: List[object] = [family._make_env() for _ in range(num_envs)]
        self._rng = np.random.RandomState(family._seed)
        self._t = np.zeros(num_envs, np.int64)

    def _new_seed(self) -> int:
        return int(self._rng.randint(0, 2**31 - 1))

    # -- host side ------------------------------------------------------
    def _host_reset(self):
        obs, state, avail = [], [], []
        for i, env in enumerate(self.envs):
            obs.append(env.reset(seed=self._new_seed()))
            self._t[i] = 0
            state.append(env.get_state())
            avail.append(env.get_avail_actions())
        E, n = self.num_envs, self.n_agents
        d = dict(obs=np.stack(obs).astype(np.float32),
                 state=np.stack(state).astype(np.float32),
                 avail=np.stack(avail).astype(bool),
                 reward=np.zeros(E, np.float32), done=np.zeros(E, bool),
                 truncated=np.zeros(E, bool), battle_won=np.zeros(E, np.float32))
        if self.family.provides_agent_rewards:
            d["agent_rewards"] = np.zeros((E, n), np.float32)
        return d

    def _host_step(self, actions: np.ndarray):
        live, final = [], []
        for i, env in enumerate(self.envs):
            out = env.step(actions[i])
            # (obs, reward, done, truncated[, info])
            obs, reward, done, truncated = out[:4]
            info = out[4] if len(out) > 4 else {}
            bw = float(info.get("battle_won", 0.0))
            ar = info.get("agent_rewards")
            if self.family.provides_agent_rewards and ar is None:
                raise ValueError(
                    "host env declares provides_agent_rewards but step() "
                    "returned no info['agent_rewards'] — the contract "
                    "requires it on EVERY step"
                )
            self._t[i] += 1
            if self._t[i] >= self.episode_limit and not done:
                truncated = True
            state, avail = env.get_state(), env.get_avail_actions()
            final.append((obs, state, avail, reward, done, truncated, bw, ar))
            if self.auto_reset and (done or truncated):
                obs = env.reset(seed=self._new_seed())
                self._t[i] = 0
                state, avail = env.get_state(), env.get_avail_actions()
            live.append((obs, state, avail, reward, done, truncated, bw, ar))

        def pack(rows):
            obs, state, avail, reward, done, trunc, bw, ar = zip(*rows)
            d = dict(obs=np.stack(obs).astype(np.float32),
                     state=np.stack(state).astype(np.float32),
                     avail=np.stack(avail).astype(bool),
                     reward=np.asarray(reward, np.float32), done=np.asarray(done, bool),
                     truncated=np.asarray(trunc, bool), battle_won=np.asarray(bw, np.float32))
            if self.family.provides_agent_rewards:
                d["agent_rewards"] = np.stack(ar).astype(np.float32)
            return d

        return pack(live), pack(final)

    # -- tensors --------------------------------------------------------
    def _to_ts(self, *views):
        """One TimeStep per view (a dict of numpy arrays), from one
        host-to-device copy: every field goes up as float32 in one flat
        buffer (booleans as 0 and 1, exact) and is split, reshaped and cast
        back on the device."""
        flat = np.concatenate([v.astype(np.float32).ravel() for d in views for v in d.values()])
        buf, i, out = torch.from_numpy(flat).to(self.device), 0, []
        for d in views:
            t = {}
            for k, v in d.items():
                x = buf[i:i + v.size].view(v.shape)
                t[k], i = (x.bool() if v.dtype == np.bool_ else x), i + v.size
            info = {"battle_won": t["battle_won"]}
            if "agent_rewards" in t:
                info["agent_rewards"] = t["agent_rewards"]
            out.append(TimeStep(obs=t["obs"], state=t["state"], avail=t["avail"],
                                reward=t["reward"], done=t["done"], truncated=t["truncated"],
                                info=info))
        return out

    def reset(self, generator=None):
        del generator  # host RNG (module docstring)
        return 0, self._to_ts(self._host_reset())[0]

    def step(self, state, actions, generator=None):
        """actions (num_envs, n_agents) → (state + 1, ts, final)."""
        del generator
        with span("env.step"):
            live, final = self._host_step(actions.detach().cpu().numpy())
            if not self.auto_reset:            # the live view is the pre-reset one
                ts, = self._to_ts(live)
                return state + 1, ts, ts
            ts, final_ts = self._to_ts(live, final)
            return state + 1, ts, final_ts

    def sample(self, generator, avail):
        logits = torch.where(avail.bool(), 0.0, float("-inf"))
        return categorical(logits, generator)

    def close(self):
        for env in self.envs:
            env.close()


def as_vec(env, num_envs: int, auto_reset: bool = True):
    """``VecEnv`` for a batched torch env, ``HostVecEnv`` for a host family."""
    if hasattr(env, "make_vec"):
        return env.make_vec(num_envs, auto_reset=auto_reset)
    return VecEnv(env, num_envs, auto_reset=auto_reset)
