"""Reward post-processing (port of ``cleanmarl_tpu/core/rewards.py``):
per-batch standardization, with masked statistics for padded episode
batches (QMIX samples whole episodes padded to ``T_max``). In a
data-parallel run (``distributed/dp.py``) the statistics, masked or not,
are those of every rank's batch."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cleanmarl_tpu_torch.distributed.dp import global_mean_std, global_sum


def masked_count(rewards: torch.Tensor, mask: torch.Tensor, normalize: bool,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (``rewards``, standardized over the masked entries when
    ``normalize``; max(Σ mask, 1)), both over every rank's batch: the
    count of a masked mean and its rewards. The mask's and the rewards'
    sums share one collective; the variance, two-pass, takes a second."""
    if not normalize:
        (count,) = global_sum(mask.sum())
        return rewards, torch.clamp(count, min=1.0)
    count, total = global_sum(mask.sum(), torch.sum(rewards * mask))
    count = torch.clamp(count, min=1.0)
    mu = total / count
    (sq,) = global_sum(torch.sum(torch.square(rewards - mu) * mask))
    return (rewards - mu) / (torch.sqrt(sq / count) + eps), count


def standardize(rewards: torch.Tensor, mask: Optional[torch.Tensor] = None,
                eps: float = 1e-6) -> torch.Tensor:
    if mask is None:
        mu, std = global_mean_std(rewards)
        return (rewards - mu) / (std + eps)
    return masked_count(rewards, mask, True, eps)[0]
