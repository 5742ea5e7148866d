"""MAPPO: multi-agent PPO with a centralized state-input critic (port of
``cleanmarl_tpu/algos/mappo.py``). Identical to IPPO except the critic
consumes the global state and its value is broadcast to every agent;
see ``ppo_common``.

    python -m cleanmarl_tpu_torch.algos.mappo --recurrent true \
        --env_type smaclite --env_name 3m            # on the card
    ... --device cpu                                 # on the CPU
"""
from __future__ import annotations

from cleanmarl_tpu_torch.algos.ppo_common import (
    PPOConfig, make_train as _make_train, train as _train,
)

MAPPOConfig = PPOConfig


def make_train(cfg: PPOConfig, env=None):
    return _make_train(cfg, env, centralized=True, algo_name="MAPPO")


def train(cfg: PPOConfig, env=None, logger=None):
    return _train(cfg, env, centralized=True, algo_name="MAPPO", logger=logger)


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    train(cli(PPOConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
