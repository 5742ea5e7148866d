"""Sequence replay on the device (port of ``cleanmarl_tpu/buffers/sequence.py``):
a ring of fixed-length chunks for recurrent Q-learning, and the per-env
accumulator that cuts the auto-reset env batch into chunks.

Episodes are cut into contiguous ``seq_length``-step chunks as they
stream in. The last, partial chunk of an episode is back-filled from that
env's previously committed chunk, so every stored row is dense: its first
``L − t`` entries are the tail of the previous chunk and the rest are the
partial chunk (the reference's ``is_last`` overlap patch). Sampling is
uniform over chunks and returns fixed ``(B, L, ...)`` records, no mask.

The ring's leaves are ``(capacity + 1, L, ...)``: row ``capacity`` is a
scratch row that takes the writes of envs that commit nothing, so a
commit is one scatter of every env's row with no host branch on which
envs committed. ``cursor`` and ``size`` are host integers; they advance
by the number of chunks committed, which ``add_step`` reads from the
device once per call, with the number of episodes that ended: the one
host sync of a recurrent-Q iteration.

In a process group (``distributed/dp.py``) the ring holds this rank's
rows of a ``capacity``-row global ring (global row ``i`` on rank ``i %
world``), the accumulator this rank's envs, whose back-fill reads their
own previous chunks. A commit gathers every rank's commit and end flags
(the one sync), gives the committing envs their single-process
destinations in global env order and sends each chunk to the owner of
its row; nothing writes the scratch row. A sample takes rank 0's draw and
fetches this rank's batch rows from their owners.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.distributed import dp


class SequenceBuffer:
    def __init__(self, data: Any, cursor: int = 0, size: int = 0,
                 capacity: Optional[int] = None):
        self.data = data          # leaves (rows + 1, L, ...)
        self.cursor = cursor
        self.size = size
        # global rows; this rank holds dp.owned_rows(capacity, rank, world)
        self.capacity = tree_leaves(data)[0].shape[0] - 1 if capacity is None else capacity

    @staticmethod
    def create(capacity: int, seq_length: int, example: Any, rank: int = 0,
               world: int = 1) -> "SequenceBuffer":
        """``example``: one step's record, unbatched; the ring takes its
        shapes, dtypes and device. Rank ``rank`` of ``world`` holds its
        rows of ``capacity``."""
        rows = dp.owned_rows(capacity, rank, world) + 1
        return SequenceBuffer(tree_map(
            lambda x: torch.zeros((rows, seq_length) + tuple(x.shape),
                                  dtype=x.dtype, device=x.device), example),
            capacity=capacity)

    def shard(self, rank: int, world: int) -> "SequenceBuffer":
        """Rank ``rank``'s rows of this single-process ring, and its scratch row."""
        dev = tree_leaves(self.data)[0].device
        rows = torch.cat([torch.arange(rank, self.capacity, world),
                          torch.tensor([self.capacity])]).to(dev)
        return SequenceBuffer(tree_map(lambda x: x[rows], self.data), self.cursor,
                              self.size, self.capacity)

    @staticmethod
    def unshard(parts) -> "SequenceBuffer":
        """The single-process ring of the ranks' ``parts`` (rank order), the
        inverse of ``shard``: global row ``i`` from rank ``i % world``'s row
        ``i // world``. The ranks' scratch rows are dropped and the result's
        is zero; ``cursor``, ``size`` and ``capacity`` must agree."""
        cursor, size, cap = (dp.agreed([getattr(p, k) for p in parts], f"ring.{k}")
                             for k in ("cursor", "size", "capacity"))
        return SequenceBuffer(tree_map(
            lambda *xs: dp.unshard_rows([x[:-1] for x in xs], cap, scratch=True),
            *[p.data for p in parts]), cursor, size, cap)

    def sample(self, generator, batch_size: int) -> Any:
        """→ records (B, L, ...), uniform over the stored chunks.
        ``idx < size <= capacity``, so the scratch row is never read. In a
        process group, this rank's rows ``rank, rank + world, ...`` of rank
        0's draw."""
        with span("ring.sample"):
            world = dp.rank_world()[1]
            if world > 1:
                idx = dp.rank0_randint(generator, max(self.size, 1), batch_size)
                return dp.move_rows(self.data, idx % world, idx // world,
                                    np.arange(batch_size) % world)
            dev = tree_leaves(self.data)[0].device
            idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                                device=dev)
            return tree_map(lambda buf: buf[idx], self.data)


class SequenceAccumulator:
    """Per-env chunks in progress: leaves of ``store`` and ``prev`` are
    ``(num_envs, L, ...)``, ``t`` is (num_envs,) int64. ``prev`` holds each
    env's last committed chunk (zeros before its first commit, as the
    reference's fresh storage), the source of its back-fill."""

    def __init__(self, store: Any, prev: Any, t: torch.Tensor):
        self.store = store
        self.prev = prev
        self.t = t

    @staticmethod
    def create(num_envs: int, seq_length: int, example: Any) -> "SequenceAccumulator":
        def zeros(x):
            return torch.zeros((num_envs, seq_length) + tuple(x.shape), dtype=x.dtype,
                               device=x.device)
        dev = tree_leaves(example)[0].device
        return SequenceAccumulator(tree_map(zeros, example), tree_map(zeros, example),
                                   torch.zeros((num_envs,), dtype=torch.int64, device=dev))

    def shard(self, rank: int, world: int) -> "SequenceAccumulator":
        """Rank ``rank``'s envs of this single-process accumulator."""
        def take(tree):
            return tree_map(lambda x: dp.interleaved(x, rank, world), tree)
        return SequenceAccumulator(take(self.store), take(self.prev),
                                   dp.interleaved(self.t, rank, world))

    @staticmethod
    def unshard(parts) -> "SequenceAccumulator":
        """The single-process accumulator of the ranks' ``parts`` (rank
        order): global env ``j`` from rank ``j % world``."""
        def merge(key):
            return tree_map(lambda *xs: dp.uninterleaved(xs),
                            *[getattr(p, key) for p in parts])
        return SequenceAccumulator(merge("store"), merge("prev"),
                                   dp.uninterleaved([p.t for p in parts]))

    def add_step(self, ring: SequenceBuffer, record: Any,
                 ended: torch.Tensor) -> Tuple[int, int]:
        """Append one step for every env; commit into ``ring`` the chunks
        that became full and the back-filled last chunks of the episodes
        whose ``ended`` (num_envs,) flag is set, all in place. ``record``
        has a leading num_envs axis. Returns (chunks committed, episodes
        ended), read from the device together: one sync."""
        with span("ring.commit"):
            num_envs, L = self.t.shape[0], tree_leaves(self.store)[0].shape[1]
            dev = self.t.device
            envs = torch.arange(num_envs, device=dev)

            def write_step(buf, x):
                buf[envs, self.t] = x
            tree_map(write_step, self.store, record)
            t_new = self.t + 1                     # ≥ 1: this step was written
            full = t_new == L
            commit = torch.logical_or(full, ended)
            patch = torch.logical_and(ended, ~full)

            # the back-fill of every env at once, as one gather per leaf: the
            # first L − t_new entries come from the tail of the env's previous
            # chunk, the rest are this partial chunk shifted right
            steps = torch.arange(L, device=dev)[None, :]
            toadd = (L - t_new)[:, None]
            prev_idx = torch.clamp(t_new[:, None] + steps, max=L - 1)
            cur_idx = torch.clamp(steps - toadd, min=0)
            from_prev = steps < toadd
            rows = envs[:, None]

            def bcast(m, x):
                return m.reshape(m.shape + (1,) * (x.dim() - m.dim()))

            def chunk_of(pv, st):
                patched = torch.where(bcast(from_prev, st), pv[rows, prev_idx], st[rows, cur_idx])
                return torch.where(bcast(patch, st), patched, st)
            chunk = tree_map(chunk_of, self.prev, self.store)

            cap = ring.capacity
            rank, world = dp.rank_world()
            if world == 1:
                commit_i = commit.long()
                offsets = torch.cumsum(commit_i, 0) - commit_i
                dest = torch.where(commit, torch.remainder(ring.cursor + offsets, cap), cap)

                # Every env that commits nothing writes the scratch row, so
                # ``dest`` repeats ``cap``; on CUDA an indexed assignment with
                # repeated indices keeps one of the writes, unspecified which.
                # That is harmless because nothing reads the scratch row
                # (``sample`` draws below ``size``); the rows of committing envs
                # are distinct.
                def scatter(buf, c):
                    buf[dest] = c
                tree_map(scatter, ring.data, chunk)
                n_new, n_ended = torch.stack((commit_i.sum(), ended.long().sum())).tolist()
            else:
                flags = dp.gather_flags(commit, ended)                 # global envs, in order
                commits = np.flatnonzero(flags[0])
                n_new, n_ended = len(commits), int(flags[1].sum())
                if n_new:
                    dest = (ring.cursor + np.arange(n_new)) % cap      # global rows
                    got = dp.move_rows(chunk, commits % world, commits // world, dest % world)
                    rows = torch.as_tensor(dest[dest % world == rank] // world, device=dev)

                    def scatter(buf, c):
                        buf[rows] = c
                    tree_map(scatter, ring.data, got)
            self.prev = tree_map(lambda pv, c: torch.where(bcast(commit, c), c, pv),
                                 self.prev, chunk)
            self.t = torch.where(commit, 0, t_new)

            ring.cursor = (ring.cursor + n_new) % cap
            ring.size = min(ring.size + n_new, cap)
            return n_new, n_ended
