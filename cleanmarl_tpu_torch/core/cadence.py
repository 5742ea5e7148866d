"""Episode-cadence update scheduling for the off-policy algorithms (port
of ``cleanmarl_tpu/core/cadence.py``), on host integers.

The reference updates once per ``train_freq`` completed episodes; a
synchronized env batch can finish many episodes in one iteration (on MPE
all ``num_envs`` truncate together), so one iteration may owe several
updates. ``bounded_due`` runs at most ``n_slots`` of them and carries the
rest as an update debt; ``target_due`` counts target-network crossings on
the clock of updates actually run, so deferred updates defer their target
steps with them.

The JAX package scans ``n_slots`` conditional update slots on the device,
because its loop is one compiled program. Here the counts are host
integers and the caller runs exactly ``n_run`` updates in a Python loop:
running every slot masked on the device would do ``n_slots`` full updates
each iteration.
"""
from __future__ import annotations

from typing import Tuple


def num_slots(max_updates_per_iter: int, num_envs: int) -> int:
    """Most updates one iteration may run (0 = uncapped: ``num_envs``)."""
    return max_updates_per_iter if max_updates_per_iter > 0 else num_envs


def bounded_due(debt: int, due: int, n_slots: int) -> Tuple[int, int]:
    """→ (n_run, new_debt): run ``n_run`` updates now, carry the rest."""
    debt = debt + due
    n_run = min(debt, n_slots)
    return n_run, debt - n_run


def target_due(prev_updates: int, n_run: int, train_freq: int, target_freq: int) -> int:
    """Target-network crossings over the ``n_run`` updates just run:
    ``num_updates * train_freq`` is the serviced episode clock."""
    prev = prev_updates * train_freq
    now = prev + n_run * train_freq
    return now // target_freq - prev // target_freq
