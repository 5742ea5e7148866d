"""Episode replay on the device (port of ``cleanmarl_tpu/buffers/episode.py``):
a ring of episodes padded to ``T_max = episode_limit`` with an integer
length per slot, and the per-env accumulator that assembles episodes from
the auto-reset env batch.

Every slot has the fixed shape ``(T_max, ...)``; sampling gathers whole
slots and derives the step mask from the lengths. The ring's leaves are
``(rows + 1, T_max, ...)``: row ``rows`` is a scratch row that takes the
writes of envs whose episode did not end, so a single-process commit is
one scatter of every env's row with no host branch on which envs ended.

``cursor`` and ``size`` are host integers. They advance by the number of
episodes that ended, which ``add_step`` reads from the device once per
call: the one host sync of a QMIX iteration, which the episode-cadence
update count needs on the host anyway (``core/cadence.py``).

In a process group (``distributed/dp.py``) the ring holds this rank's
rows of a ``capacity``-row global ring (global row ``i`` on rank ``i %
world``), the accumulator this rank's envs. A commit gathers every rank's
end flags (the one sync), gives the ended envs their single-process
destinations in global env order and sends each episode and its length
to the owner of its row; nothing writes the scratch row. A sample takes
rank 0's draw and fetches this rank's batch rows from their owners.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.distributed import dp


class EpisodeBuffer:
    def __init__(self, data: Any, length: torch.Tensor, cursor: int = 0, size: int = 0,
                 capacity: Optional[int] = None):
        self.data = data          # leaves (rows + 1, T_max, ...)
        self.length = length      # (rows + 1,) int64
        self.cursor = cursor
        self.size = size
        # global rows; this rank holds dp.owned_rows(capacity, rank, world)
        self.capacity = length.shape[0] - 1 if capacity is None else capacity

    @property
    def t_max(self) -> int:
        return tree_leaves(self.data)[0].shape[1]

    @staticmethod
    def create(capacity: int, t_max: int, example: Any, rank: int = 0,
               world: int = 1) -> "EpisodeBuffer":
        """``example``: one step's record, unbatched; the ring takes its
        shapes, dtypes and device. Rank ``rank`` of ``world`` holds its
        rows of ``capacity``."""
        rows = dp.owned_rows(capacity, rank, world) + 1
        data = tree_map(lambda x: torch.zeros((rows, t_max) + tuple(x.shape),
                                              dtype=x.dtype, device=x.device), example)
        dev = tree_leaves(example)[0].device
        return EpisodeBuffer(data, torch.zeros((rows,), dtype=torch.int64, device=dev),
                             capacity=capacity)

    def shard(self, rank: int, world: int) -> "EpisodeBuffer":
        """Rank ``rank``'s rows of this single-process ring, and its scratch row."""
        rows = torch.cat([torch.arange(rank, self.capacity, world),
                          torch.tensor([self.capacity])]).to(self.length.device)
        return EpisodeBuffer(tree_map(lambda x: x[rows], self.data), self.length[rows],
                             self.cursor, self.size, self.capacity)

    @staticmethod
    def unshard(parts) -> "EpisodeBuffer":
        """The single-process ring of the ranks' ``parts`` (rank order), the
        inverse of ``shard``: global row ``i`` from rank ``i % world``'s row
        ``i // world``. The ranks' scratch rows are dropped and the result's
        is zero; ``cursor``, ``size`` and ``capacity`` must agree."""
        cursor, size, cap = (dp.agreed([getattr(p, k) for p in parts], f"ring.{k}")
                             for k in ("cursor", "size", "capacity"))

        def merge(*xs):
            return dp.unshard_rows([x[:-1] for x in xs], cap, scratch=True)
        return EpisodeBuffer(tree_map(merge, *[p.data for p in parts]),
                             merge(*[p.length for p in parts]), cursor, size, cap)

    def sample(self, generator, batch_size: int) -> Tuple[Any, torch.Tensor]:
        """→ (records (B, T_max, ...), mask (B, T_max) f32), uniform over the
        stored episodes. ``idx < size <= capacity``, so the scratch row is
        never read. In a process group, this rank's rows ``rank, rank +
        world, ...`` of rank 0's draw."""
        with span("ring.sample"):
            world = dp.rank_world()[1]
            if world == 1:
                idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                                    device=self.length.device)
                batch = tree_map(lambda buf: buf[idx], self.data)
                length = self.length[idx]
            else:
                idx = dp.rank0_randint(generator, max(self.size, 1), batch_size)
                rows = dp.move_rows({"data": self.data, "length": self.length}, idx % world,
                                    idx // world, np.arange(batch_size) % world)
                batch, length = rows["data"], rows["length"]
            steps = torch.arange(self.t_max, device=length.device)
            mask = (steps[None, :] < length[:, None]).float()
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

    def shard(self, rank: int, world: int) -> "EpisodeAccumulator":
        """Rank ``rank``'s envs of this single-process accumulator."""
        return EpisodeAccumulator(tree_map(lambda x: dp.interleaved(x, rank, world),
                                           self.store), dp.interleaved(self.t, rank, world))

    @staticmethod
    def unshard(parts) -> "EpisodeAccumulator":
        """The single-process accumulator of the ranks' ``parts`` (rank
        order): global env ``j`` from rank ``j % world``."""
        return EpisodeAccumulator(tree_map(lambda *xs: dp.uninterleaved(xs),
                                           *[p.store for p in parts]),
                                  dp.uninterleaved([p.t for p in parts]))

    def add_step(self, ring: EpisodeBuffer, record: Any, ended: torch.Tensor) -> int:
        """Append one step for every env and commit the episodes of the envs
        whose ``ended`` (num_envs,) flag is set into ``ring``, both in place.
        ``record`` has a leading num_envs axis. Returns the number of
        episodes committed, over every rank (read from the device: one
        sync)."""
        with span("ring.commit"):
            num_envs, t_max = self.t.shape[0], tree_leaves(self.store)[0].shape[1]
            envs = torch.arange(num_envs, device=self.t.device)
            tw = torch.clamp(self.t, max=t_max - 1)

            def write_step(buf, x):
                buf[envs, tw] = x
            tree_map(write_step, self.store, record)
            new_t = torch.clamp(self.t + 1, max=t_max)

            cap = ring.capacity
            rank, world = dp.rank_world()
            if world == 1:
                ended_i = ended.long()
                offsets = torch.cumsum(ended_i, 0) - ended_i
                dest = torch.where(ended, torch.remainder(ring.cursor + offsets, cap), cap)

                # Every env whose episode did not end writes the scratch row, so
                # ``dest`` repeats ``cap``; on CUDA an indexed assignment with
                # repeated indices keeps one of the writes, unspecified which.
                # That is harmless because nothing reads the scratch row
                # (``sample`` draws below ``size``); the rows of ended envs are
                # distinct.
                def commit(buf, s):
                    buf[dest] = s
                tree_map(commit, ring.data, self.store)
                ring.length[dest] = new_t
                n_new = int(ended_i.sum())
            else:
                ends = np.flatnonzero(dp.gather_flags(ended)[0])      # global envs, in order
                n_new = len(ends)
                if n_new:
                    dest = (ring.cursor + np.arange(n_new)) % cap      # global rows
                    got = dp.move_rows({"data": self.store, "length": new_t}, ends % world,
                                       ends // world, dest % world)
                    rows = torch.as_tensor(dest[dest % world == rank] // world,
                                           device=self.t.device)

                    def commit(buf, s):
                        buf[rows] = s
                    tree_map(commit, ring.data, got["data"])
                    ring.length[rows] = got["length"]
            self.t = torch.where(ended, 0, new_t)

            ring.cursor = (ring.cursor + n_new) % cap
            ring.size = min(ring.size + n_new, cap)
            return n_new
