"""Recurrent VDN (GRU Q-net, team value = Σ agent values): the CLI of
``recurrent_q`` with ``mixing="vdn"`` (port of
``cleanmarl_tpu/algos/vdn_rnn.py``); ``--replay sequence`` trains on
chunks with burn-in.

    python -m cleanmarl_tpu_torch.algos.vdn_rnn --env_type smaclite \
        --env_name 3m --num_envs 64                    # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

from dataclasses import replace

from cleanmarl_tpu_torch.algos.recurrent_q import RecurrentQConfig, train


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    cfg = cli(RecurrentQConfig, argv, description=__doc__)
    return train(replace(cfg, mixing="vdn"))


if __name__ == "__main__":
    main()
