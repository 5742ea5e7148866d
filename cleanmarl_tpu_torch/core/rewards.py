"""Reward post-processing (port of ``cleanmarl_tpu/core/rewards.py``):
per-batch standardization, with masked statistics for padded episode
batches (QMIX samples whole episodes padded to ``T_max``). Without a
mask the statistics are those of every rank's batch in a data-parallel
run (``distributed/dp.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from cleanmarl_tpu_torch.distributed.dp import global_mean_std


def standardize(rewards: torch.Tensor, mask: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    if mask is None:
        mu, std = global_mean_std(rewards)
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        mu = torch.sum(rewards * mask) / denom
        std = torch.sqrt(torch.sum(torch.square(rewards - mu) * mask) / denom)
    return (rewards - mu) / (std + eps)
