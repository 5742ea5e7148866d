"""Recurrent QMIX (GRU Q-net and the monotonic mixer): the CLI of
``recurrent_q`` with ``mixing="qmix"`` (port of
``cleanmarl_tpu/algos/qmix_rnn.py``).

    python -m cleanmarl_tpu_torch.algos.qmix_rnn --env_type smaclite \
        --env_name 3m --num_envs 64                    # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

from dataclasses import replace

from cleanmarl_tpu_torch.algos.recurrent_q import RecurrentQConfig, train


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    cfg = cli(RecurrentQConfig, argv, description=__doc__)
    return train(replace(cfg, mixing="qmix"))


if __name__ == "__main__":
    main()
