"""Policy evaluation (port of ``cleanmarl_tpu/core/evaluation.py``).

A batch of ``num_eval_ep`` envs (no auto-reset) is stepped for
``episode_limit`` steps; each env contributes exactly its first episode.
Emits ``eval/ep_reward``, ``eval/std_ep_reward``, ``eval/ep_length`` and
``eval/battle_won``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from cleanmarl_tpu_torch.envs.base import Environment
from cleanmarl_tpu_torch.envs.external import as_vec

# policy(params, carry, obs, avail, generator) -> (carry, actions)
PolicyFn = Callable[..., Any]


def make_evaluator(env: Environment, num_eval_ep: int, policy: PolicyFn,
                   init_carry: Callable[[int], Any] = lambda n: ()):
    """Returns eval_fn(params, generator) -> dict of scalar tensors."""
    vec = as_vec(env, num_eval_ep, auto_reset=False)

    @torch.no_grad()
    def eval_fn(params, generator):
        env_state, ts = vec.reset(generator)
        carry = init_carry(num_eval_ep)
        dev = env.device
        ret = torch.zeros((num_eval_ep,), device=dev)
        length = torch.zeros((num_eval_ep,), device=dev)
        won = torch.zeros((num_eval_ep,), device=dev)
        active = torch.ones((num_eval_ep,), dtype=torch.bool, device=dev)
        for _ in range(env.episode_limit):
            carry, actions = policy(params, carry, ts.obs, ts.avail, generator)
            env_state, ts, _ = vec.step(env_state, actions, generator)
            ret = ret + ts.reward * active
            length = length + active
            ended = torch.logical_or(ts.done, ts.truncated)
            finished_now = active & ended
            won = torch.where(finished_now,
                              ts.info.get("battle_won", torch.zeros_like(ret)), won)
            active = active & ~ended
        return {
            "eval/ep_reward": ret.mean(),
            "eval/std_ep_reward": ret.std(unbiased=False),
            "eval/ep_length": length.mean(),
            "eval/battle_won": won.mean(),
        }

    return eval_fn
