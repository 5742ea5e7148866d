"""Episode replay on the device (port of ``cleanmarl_tpu/buffers/episode.py``):
a ring of episodes padded to ``T_max = episode_limit`` with an integer
length per slot, and the per-env accumulator that assembles episodes from
the auto-reset env batch.

Every slot has the fixed shape ``(T_max, ...)``; sampling gathers whole
slots and derives the step mask from the lengths. The ring's leaves are
``(capacity + 1, T_max, ...)``: row ``capacity`` is a scratch row that
takes the writes of envs whose episode did not end, so a commit is one
scatter of every env's row with no host branch on which envs ended.

``cursor`` and ``size`` are host integers. They advance by the number of
episodes that ended, which ``add_step`` reads from the device once per
call: the one host sync of a QMIX iteration, which the episode-cadence
update count needs on the host anyway (``core/cadence.py``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map


class EpisodeBuffer:
    def __init__(self, data: Any, length: torch.Tensor, cursor: int = 0, size: int = 0):
        self.data = data          # leaves (capacity + 1, T_max, ...)
        self.length = length      # (capacity + 1,) int64
        self.cursor = cursor
        self.size = size

    @property
    def capacity(self) -> int:
        return self.length.shape[0] - 1

    @property
    def t_max(self) -> int:
        return tree_leaves(self.data)[0].shape[1]

    @staticmethod
    def create(capacity: int, t_max: int, example: Any) -> "EpisodeBuffer":
        """``example``: one step's record, unbatched; the ring takes its
        shapes, dtypes and device."""
        data = tree_map(lambda x: torch.zeros((capacity + 1, t_max) + tuple(x.shape),
                                              dtype=x.dtype, device=x.device), example)
        dev = tree_leaves(example)[0].device
        return EpisodeBuffer(data, torch.zeros((capacity + 1,), dtype=torch.int64,
                                               device=dev))

    def sample(self, generator, batch_size: int) -> Tuple[Any, torch.Tensor]:
        """→ (records (B, T_max, ...), mask (B, T_max) f32), uniform over the
        stored episodes. ``idx < size <= capacity``, so the scratch row is
        never read."""
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                            device=self.length.device)
        batch = tree_map(lambda buf: buf[idx], self.data)
        steps = torch.arange(self.t_max, device=idx.device)
        mask = (steps[None, :] < self.length[idx][:, None]).float()
        return batch, mask


class EpisodeAccumulator:
    """Per-env episodes in progress: leaves of ``store`` are
    ``(num_envs, T_max, ...)``, ``t`` is (num_envs,) int64."""

    def __init__(self, store: Any, t: torch.Tensor):
        self.store = store
        self.t = t

    @staticmethod
    def create(num_envs: int, t_max: int, example: Any) -> "EpisodeAccumulator":
        store = tree_map(lambda x: torch.zeros((num_envs, t_max) + tuple(x.shape),
                                               dtype=x.dtype, device=x.device), example)
        dev = tree_leaves(example)[0].device
        return EpisodeAccumulator(store, torch.zeros((num_envs,), dtype=torch.int64,
                                                     device=dev))

    def add_step(self, ring: EpisodeBuffer, record: Any, ended: torch.Tensor) -> int:
        """Append one step for every env and commit the episodes of the envs
        whose ``ended`` (num_envs,) flag is set into ``ring``, both in place.
        ``record`` has a leading num_envs axis. Returns the number of
        episodes committed (read from the device: one sync)."""
        num_envs, t_max = self.t.shape[0], tree_leaves(self.store)[0].shape[1]
        envs = torch.arange(num_envs, device=self.t.device)
        tw = torch.clamp(self.t, max=t_max - 1)

        def write_step(buf, x):
            buf[envs, tw] = x
        tree_map(write_step, self.store, record)
        new_t = torch.clamp(self.t + 1, max=t_max)

        cap = ring.capacity
        ended_i = ended.long()
        offsets = torch.cumsum(ended_i, 0) - ended_i
        dest = torch.where(ended, torch.remainder(ring.cursor + offsets, cap), cap)

        # Every env whose episode did not end writes the scratch row, so
        # ``dest`` repeats ``cap``; on CUDA an indexed assignment with
        # repeated indices keeps one of the writes, unspecified which. That
        # is harmless because nothing reads the scratch row (``sample``
        # draws below ``size``); the rows of ended envs are distinct.
        def commit(buf, s):
            buf[dest] = s
        tree_map(commit, ring.data, self.store)
        ring.length[dest] = new_t
        self.t = torch.where(ended, 0, new_t)

        n_new = int(ended_i.sum())
        ring.cursor = (ring.cursor + n_new) % cap
        ring.size = min(ring.size + n_new, cap)
        return n_new
