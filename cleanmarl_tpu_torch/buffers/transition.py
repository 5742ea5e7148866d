"""Transition ring buffer on the device (port of
``cleanmarl_tpu/buffers/transition.py``).

Storage is a preallocated record of tensors (leaves ``(capacity, ...)``)
that lives on the device for the whole run. A batch is written in place
at ``(cursor + arange(B)) % capacity``; sampling is a uniform gather.
``cursor`` and ``size`` are host integers: they depend only on how many
rows were written, never on the data, so no write waits for the device.

In a process group (``distributed/dp.py``) the ring holds this rank's
rows of a ``capacity``-row global ring (global row ``i`` on rank ``i %
world``) and a batch is this rank's envs: global env ``j`` goes to row
``(cursor + j) % capacity``, as in one process. Where the ranks divide
both the env batch and the capacity, that row is always this rank's own,
and each rank writes its rows in place with no collective; otherwise each
transition is sent to the owner of its row. A sample takes rank 0's draw
and fetches this rank's batch rows from their owners.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.distributed import dp


class TransitionBuffer:
    def __init__(self, data: Any, cursor: int = 0, size: int = 0,
                 capacity: Optional[int] = None):
        self.data = data
        self.cursor = cursor
        self.size = size
        # global rows; this rank holds dp.owned_rows(capacity, rank, world)
        self.capacity = tree_leaves(data)[0].shape[0] if capacity is None else capacity

    @staticmethod
    def create(capacity: int, example: Any, rank: int = 0, world: int = 1) -> "TransitionBuffer":
        """``example`` is one transition record without the capacity axis;
        the ring takes its shapes, dtypes and device. Rank ``rank`` of
        ``world`` holds its rows of ``capacity``."""
        rows = dp.owned_rows(capacity, rank, world)
        return TransitionBuffer(tree_map(
            lambda x: torch.zeros((rows,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), example), capacity=capacity)

    def shard(self, rank: int, world: int) -> "TransitionBuffer":
        """Rank ``rank``'s rows of this single-process ring."""
        return TransitionBuffer(tree_map(lambda x: dp.interleaved(x, rank, world), self.data),
                                self.cursor, self.size, self.capacity)

    @staticmethod
    def unshard(parts) -> "TransitionBuffer":
        """The single-process ring of the ranks' ``parts`` (rank order), the
        inverse of ``shard``; ``cursor``, ``size`` and ``capacity`` must
        agree."""
        cursor, size, cap = (dp.agreed([getattr(p, k) for p in parts], f"buffer.{k}")
                             for k in ("cursor", "size", "capacity"))
        return TransitionBuffer(tree_map(lambda *xs: dp.unshard_rows(xs, cap),
                                         *[p.data for p in parts]), cursor, size, cap)

    def add_batch(self, batch: Any) -> None:
        """Write a batch (leading axis B, this rank's envs) at the cursor, in
        place."""
        with span("ring.commit"):
            b = tree_leaves(batch)[0].shape[0]
            cap = self.capacity
            dev = tree_leaves(self.data)[0].device
            rank, world = dp.rank_world()
            if world == 1:
                idx = torch.remainder(self.cursor + torch.arange(b, device=dev), cap)
            elif cap % world == 0 and self.cursor % world == 0:
                # global env i * world + rank lands on row cursor + i * world +
                # rank (mod cap): this rank's own row (cursor // world + i) mod
                # (cap // world), with no collective
                idx = torch.remainder(self.cursor // world + torch.arange(b, device=dev),
                                      cap // world)
            else:
                j = np.arange(b * world)                               # global envs
                rows = (self.cursor + j) % cap
                batch = dp.move_rows(batch, j % world, j // world, rows % world)
                idx = torch.as_tensor(rows[rows % world == rank] // world, device=dev)

            def write(buf, x):
                buf[idx] = x
            tree_map(write, self.data, batch)
            self.cursor = (self.cursor + b * world) % cap
            self.size = min(self.size + b * world, cap)

    def sample(self, generator, batch_size: int) -> Any:
        """Uniform sample with replacement over the valid rows. In a process
        group, this rank's rows ``rank, rank + world, ...`` of rank 0's
        draw."""
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
