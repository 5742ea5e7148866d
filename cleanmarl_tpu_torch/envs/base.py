"""Batched environment API (port of ``cleanmarl_tpu/envs/base.py``).

The JAX package writes each env as a per-env pure function and vmaps it.
Here an env is natively batched: every state field and every TimeStep
field carries a leading ``num_envs`` axis, so one call steps the whole
batch with a fixed number of tensor ops:

    state, ts = env.reset(num_envs, generator)
    state, ts = env.step(state, actions, generator)

Env states are frozen dataclasses of tensors; ``state_where`` selects
between two of them per env.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.envs import step_graph
from cleanmarl_tpu_torch.types import TimeStep


def state_where(mask: torch.Tensor, a, b):
    """Per-env select between two env states (dataclasses of tensors
    with a leading env axis): ``a`` where ``mask`` (N,) is set."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out[f.name] = torch.where(m, x, y)
    return type(a)(**out)


def state_from_numpy(cls, fields, device, batched: bool = True):
    """Build an env state of dataclass ``cls`` from a mapping of numpy
    arrays (e.g. a JAX env state as numpy): floats → float32, integers →
    int64, booleans stay boolean. ``batched=False`` adds the leading env
    axis of size 1."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(fields[f.name])
        if a.dtype != np.bool_:
            a = a.astype(np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32)
        t = torch.from_numpy(np.array(a)).to(device)
        out[f.name] = t if batched else t[None]
    return cls(**out)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator]):
    """One sample per leading index from unnormalized ``logits`` (..., K)
    via the Gumbel-max trick, drawn from ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class Environment:
    """Base class for batched multi-agent environments.

    Subclasses define ``n_agents``, ``obs_dim``, ``state_dim``,
    ``n_actions``, ``episode_limit``, ``device`` and implement ``_reset``
    and ``_step`` over a leading env axis. Action 0 is the no-op in envs
    with a death mechanic, and a dead agent's avail row is exactly
    {no-op} (the contract ``ppo_common.alive_mask`` relies on).
    """

    n_agents: int
    obs_dim: int
    state_dim: int
    n_actions: int
    episode_limit: int = 150
    device: torch.device = torch.device("cpu")

    def _reset(self, num_envs: int, generator: Optional[torch.Generator]):
        raise NotImplementedError

    def _step(self, state, actions: torch.Tensor,
              generator: Optional[torch.Generator]):
        raise NotImplementedError

    def reset(self, num_envs: int, generator=None) -> Tuple[object, TimeStep]:
        return self._reset(num_envs, generator)

    def step(self, state, actions, generator=None) -> Tuple[object, TimeStep]:
        return self._step(state, actions, generator)

    def sample(self, generator, avail: torch.Tensor) -> torch.Tensor:
        """Uniform random actions over the available ones.
        avail (N, n_agents, n_actions) → (N, n_agents) int64."""
        logits = torch.where(avail.bool(), 0.0, float("-inf"))
        return categorical(logits, generator)

    def get_obs_size(self) -> int:
        return self.obs_dim

    def get_state_size(self) -> int:
        return self.state_dim

    def get_action_size(self) -> int:
        return self.n_actions


class VecEnv:
    """``num_envs`` copies of one env, stepped as one batch, with
    on-device auto-reset.

    ``step`` keeps the contract of the JAX ``VecEnv.step``: when an env
    reports done|truncated its next obs/state/avail come from a fresh
    reset (selected with ``torch.where``, no host sync), while the
    returned TimeStep keeps the terminal reward/done/truncated/info; the
    pre-reset TimeStep is returned as ``final``.

    On a card the step replays from CUDA graphs (``envs/step_graph.py``),
    one ``StepGraph`` per instance, bound to the generator of the latest
    call: the first call with a generator runs eagerly (the warm-up), the
    next captures and replays, later ones replay. A call with another
    generator drops the graph and runs eagerly, as the warm-up of that
    generator's graph. ``generator=None``, inputs laid out otherwise than
    the captured ones, and a CPU env always run eagerly. Either way the
    call is functional: it writes none of its inputs, and returns tensors
    that no later call writes.
    """

    def __init__(self, env: Environment, num_envs: int, auto_reset: bool = True):
        self.env = env
        self.num_envs = num_envs
        self.auto_reset = auto_reset
        self.n_agents = env.n_agents
        self.obs_dim = env.obs_dim
        self.state_dim = env.state_dim
        self.n_actions = env.n_actions
        self.episode_limit = env.episode_limit
        self.device = env.device
        self._generator = None      # the generator the graph is bound to
        self._graph = None

    def reset(self, generator=None):
        return self.env.reset(self.num_envs, generator)

    def step(self, state, actions, generator=None):
        """actions (num_envs, n_agents) int → (new_state, ts, final)."""
        with span("env.step"):
            graph = self._graph_for(state, actions, generator)
            if graph is not None:
                return graph(state, actions)
            return self._eager_step(state, actions, generator)

    def _graph_for(self, state, actions, generator):
        if generator is None or not step_graph.capturable(self.env):
            return None
        if generator is not self._generator:
            self._generator, self._graph = generator, None
            return None
        if self._graph is None:
            self._graph = step_graph.StepGraph(self, state, actions, generator)
        return self._graph if self._graph.fits(state, actions) else None

    def _eager_step(self, state, actions, generator):
        state2, ts = self.env.step(state, actions, generator)
        if not self.auto_reset:
            return state2, ts, ts
        return (*self._auto_reset(state2, ts, generator), ts)

    def _auto_reset(self, state2, ts, generator):
        """The all-env reset and the selection → (new_state, ts)."""
        reset_state, reset_ts = self.env.reset(self.num_envs, generator)
        ended = torch.logical_or(ts.done, ts.truncated)

        def pick(a, b):
            return torch.where(ended.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        new_state = state_where(ended, reset_state, state2)
        out = ts.replace(
            obs=pick(reset_ts.obs, ts.obs),
            state=pick(reset_ts.state, ts.state),
            avail=pick(reset_ts.avail, ts.avail),
        )
        return new_state, out

    def sample(self, generator, avail):
        return self.env.sample(generator, avail)
