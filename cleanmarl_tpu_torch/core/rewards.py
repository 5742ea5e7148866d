"""Reward post-processing (port of ``cleanmarl_tpu/core/rewards.py``):
per-batch standardization. The masked form of the JAX function serves
the off-policy algorithms and comes with their slices."""
from __future__ import annotations

import torch


def standardize(rewards: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = rewards.mean()
    std = rewards.std(unbiased=False)
    return (rewards - mu) / (std + eps)
