"""IPPO: independent PPO with a decentralized critic that reads each
agent's own observation (port of ``cleanmarl_tpu/algos/ippo.py``).
Identical to MAPPO except the critic input; see ``ppo_common``.

    python -m cleanmarl_tpu_torch.algos.ippo --env_type lbf \
        --env_name Foraging-8x8-2p-3f-v3                 # on the card
    ... --device cpu                                     # on the CPU
"""
from __future__ import annotations

from cleanmarl_tpu_torch.algos.ppo_common import (
    PPOConfig, make_train as _make_train, train as _train,
)

IPPOConfig = PPOConfig


def make_train(cfg: PPOConfig, env=None):
    return _make_train(cfg, env, centralized=False, algo_name="IPPO")


def train(cfg: PPOConfig, env=None, logger=None):
    return _train(cfg, env, centralized=False, algo_name="IPPO", logger=logger)


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    return train(cli(PPOConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
