"""Transition ring buffer on the device (port of
``cleanmarl_tpu/buffers/transition.py``).

Storage is a preallocated record of tensors (leaves ``(capacity, ...)``)
that lives on the device for the whole run. A batch is written in place
at ``(cursor + arange(B)) % capacity``; sampling is a uniform gather.
``cursor`` and ``size`` are host integers: they depend only on how many
rows were written, never on the data, so no write waits for the device.
"""
from __future__ import annotations

from typing import Any

import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map


class TransitionBuffer:
    def __init__(self, data: Any, cursor: int = 0, size: int = 0):
        self.data = data
        self.cursor = cursor
        self.size = size

    @property
    def capacity(self) -> int:
        return tree_leaves(self.data)[0].shape[0]

    @staticmethod
    def create(capacity: int, example: Any) -> "TransitionBuffer":
        """``example`` is one transition record without the capacity axis;
        the ring takes its shapes, dtypes and device."""
        return TransitionBuffer(tree_map(
            lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), example))

    def add_batch(self, batch: Any) -> None:
        """Write a batch (leading axis B) at the cursor, in place."""
        b = tree_leaves(batch)[0].shape[0]
        cap = self.capacity
        idx = torch.remainder(
            self.cursor + torch.arange(b, device=tree_leaves(self.data)[0].device), cap)

        def write(buf, x):
            buf[idx] = x
        tree_map(write, self.data, batch)
        self.cursor = (self.cursor + b) % cap
        self.size = min(self.size + b, cap)

    def sample(self, generator, batch_size: int) -> Any:
        """Uniform sample with replacement over the valid rows."""
        dev = tree_leaves(self.data)[0].device
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                            device=dev)
        return tree_map(lambda buf: buf[idx], self.data)
