"""On-device rollout statistics (port of ``cleanmarl_tpu/core/metrics.py``).

The running per-env return/length and the block-level sums stay on the
device; the host reads one small dict per logging interval.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class EpisodeStats:
    ep_ret: torch.Tensor   # (num_envs,) running return of current episode
    ep_len: torch.Tensor   # (num_envs,)
    ret_sum: torch.Tensor  # () sum of finished-episode returns this block
    len_sum: torch.Tensor
    won_sum: torch.Tensor
    count: torch.Tensor    # () number of finished episodes this block

    @staticmethod
    def create(num_envs: int, device="cpu") -> "EpisodeStats":
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        return EpisodeStats(ep_ret=z(num_envs), ep_len=z(num_envs), ret_sum=z(),
                            len_sum=z(), won_sum=z(), count=z())

    def step(self, reward, ended, won) -> "EpisodeStats":
        """reward/won: (num_envs,) f32, ended: (num_envs,) bool."""
        ep_ret = self.ep_ret + reward
        ep_len = self.ep_len + 1.0
        e = ended.float()
        return EpisodeStats(
            ret_sum=self.ret_sum + torch.sum(ep_ret * e),
            len_sum=self.len_sum + torch.sum(ep_len * e),
            won_sum=self.won_sum + torch.sum(won * e),
            count=self.count + torch.sum(e),
            ep_ret=ep_ret * (1.0 - e),
            ep_len=ep_len * (1.0 - e),
        )

    def flush(self) -> "EpisodeStats":
        z = torch.zeros_like(self.count)
        return dataclasses.replace(self, ret_sum=z, len_sum=z, won_sum=z, count=z)

    def rollout_metrics(self) -> Dict[str, torch.Tensor]:
        denom = torch.clamp(self.count, min=1.0)
        return {
            "rollout/ep_reward": self.ret_sum / denom,
            "rollout/ep_length": self.len_sum / denom,
            "rollout/battle_won": self.won_sum / denom,
            "rollout/num_episodes": self.count,
        }
