"""Reward post-processing (port of ``cleanmarl_tpu/core/rewards.py``):
per-batch standardization, with masked statistics for padded episode
batches (QMIX samples whole episodes padded to ``T_max``)."""
from __future__ import annotations

from typing import Optional

import torch


def standardize(rewards: torch.Tensor, mask: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    if mask is None:
        mu = rewards.mean()
        std = rewards.std(unbiased=False)
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        mu = torch.sum(rewards * mask) / denom
        std = torch.sqrt(torch.sum(torch.square(rewards - mu) * mask) / denom)
    return (rewards - mu) / (std + eps)
