"""Episode replay on the device (port of ``cleanmarl_tpu/buffers/episode.py``):
a ring of episodes padded to ``T_max = episode_limit`` with an integer
length per slot, and the per-env accumulator that assembles episodes from
the auto-reset env batch.

Every slot has the fixed shape ``(T_max, ...)``; sampling gathers whole
slots and derives the step mask from the lengths. The ring's leaves have
``rows + 1`` rows: row ``rows`` is a scratch row that takes the
writes of envs whose episode did not end, so a single-process commit is
one scatter of every env's row with no host branch on which envs ended.

**Successor pairs.** A caller may declare that a field of the record is
the next step's value of another within an episode: ``pairs={"next_obs":
"obs"}`` says ``next_obs[t]`` is ``obs[t + 1]`` at every step but an
episode's last (the auto-reset env batch returns the final observation as
``next_obs`` and the reset one as the next ``obs``). The ring and the
accumulator then store each pair once, as one ``(rows, T_max + 1, ...)``
leaf that ``add_step`` writes at ``t`` (``obs``) and ``t + 1``
(``next_obs``), so the final observation of an ended episode is in the
row the commit copies. ``stored`` holds the leaves as they are kept;
``data`` (the ring) and ``store`` (the accumulator) give every field of
the record, ``obs`` the leaf's first ``T_max`` steps and ``next_obs`` its
last ``T_max``, as views. A sample gathers each stored leaf once. Without
pairs, every field is a ``(rows, T_max, ...)`` leaf of its own. An episode
that ran past ``T_max`` would keep writing its step ``T_max - 1``, which a
pair's leaf shares with the successor of step ``T_max - 2``; none does,
since every env truncates at its ``episode_limit``, the ring's ``T_max``.

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

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map
from cleanmarl_tpu_torch.core.tracing import span
from cleanmarl_tpu_torch.distributed import dp


def _check_pairs(example: Any, pairs: Optional[Dict[str, str]]) -> Dict[str, str]:
    """``pairs`` (successor field → its field, ``{"next_obs": "obs"}``) of
    the record ``example``, checked: both fields of the flat dict, of one
    shape and dtype, and no field in two pairs. → a copy."""
    pairs = dict(pairs or {})
    if pairs and not isinstance(example, dict):
        raise ValueError("successor pairs need a record that is a flat dict of fields")
    for nxt, cur in pairs.items():
        for k in (nxt, cur):
            if k not in example:
                raise ValueError(f"successor pair {nxt!r} -> {cur!r}: the record has no "
                                 f"field {k!r}")
        a, b = example[nxt], example[cur]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"successor pair {nxt!r} -> {cur!r}: {nxt!r} is "
                             f"{tuple(a.shape)} {a.dtype}, {cur!r} is {tuple(b.shape)} {b.dtype}")
    heads = list(pairs.values())
    if len(set(heads)) != len(heads) or set(heads) & set(pairs):
        raise ValueError(f"successor pairs {pairs}: a field is in two pairs")
    return pairs


def _allocate(lead: int, t_max: int, example: Any, pairs: Dict[str, str]) -> Any:
    """Zero stored leaves: ``(lead, T_max, ...)`` a field, ``(lead, T_max +
    1, ...)`` a pair's field, none for a successor."""
    def zeros(x, steps):
        return torch.zeros((lead, steps) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if not pairs:
        return tree_map(lambda x: zeros(x, t_max), example)
    heads = set(pairs.values())
    return {k: zeros(x, t_max + (k in heads)) for k, x in example.items() if k not in pairs}


def _fields(stored: Any, pairs: Dict[str, str]) -> Any:
    """Every field of the record from the stored leaves, ``(lead, T_max,
    ...)`` each: a pair's field the first ``T_max`` steps of its leaf, the
    successor the last ``T_max``, as views."""
    if not pairs:
        return stored
    heads = set(pairs.values())
    out = {k: (x[:, :-1] if k in heads else x) for k, x in stored.items()}
    out.update({nxt: stored[cur][:, 1:] for nxt, cur in pairs.items()})
    return out


class EpisodeBuffer:
    def __init__(self, stored: Any, length: torch.Tensor, cursor: int = 0, size: int = 0,
                 capacity: Optional[int] = None, pairs: Optional[Dict[str, str]] = None):
        self.stored = stored      # leaves (rows + 1, T_max, ...); a pair's T_max + 1
        self.pairs = {} if pairs is None else pairs
        self.length = length      # (rows + 1,) int64
        self.cursor = cursor
        self.size = size
        # global rows; this rank holds dp.owned_rows(capacity, rank, world)
        self.capacity = length.shape[0] - 1 if capacity is None else capacity

    @property
    def data(self) -> Any:
        """Every field of the record, ``(rows + 1, T_max, ...)`` (module
        docstring)."""
        return _fields(self.stored, self.pairs)

    @property
    def t_max(self) -> int:
        return tree_leaves(self.data)[0].shape[1]

    @staticmethod
    def create(capacity: int, t_max: int, example: Any, rank: int = 0, world: int = 1,
               pairs: Optional[Dict[str, str]] = None) -> "EpisodeBuffer":
        """``example``: one step's record, unbatched; the ring takes its
        shapes, dtypes and device. Rank ``rank`` of ``world`` holds its
        rows of ``capacity``. ``pairs``: the record's successor pairs
        (module docstring), each stored once."""
        pairs = _check_pairs(example, pairs)
        rows = dp.owned_rows(capacity, rank, world) + 1
        dev = tree_leaves(example)[0].device
        return EpisodeBuffer(_allocate(rows, t_max, example, pairs),
                             torch.zeros((rows,), dtype=torch.int64, device=dev),
                             capacity=capacity, pairs=pairs)

    def shard(self, rank: int, world: int) -> "EpisodeBuffer":
        """Rank ``rank``'s rows of this single-process ring, and its scratch row."""
        rows = torch.cat([torch.arange(rank, self.capacity, world),
                          torch.tensor([self.capacity])]).to(self.length.device)
        return EpisodeBuffer(tree_map(lambda x: x[rows], self.stored), self.length[rows],
                             self.cursor, self.size, self.capacity, self.pairs)

    @staticmethod
    def unshard(parts) -> "EpisodeBuffer":
        """The single-process ring of the ranks' ``parts`` (rank order), the
        inverse of ``shard``: global row ``i`` from rank ``i % world``'s row
        ``i // world``. The ranks' scratch rows are dropped and the result's
        is zero; ``cursor``, ``size``, ``capacity`` and ``pairs`` must agree."""
        cursor, size, cap, pairs = (dp.agreed([getattr(p, k) for p in parts], f"ring.{k}")
                                    for k in ("cursor", "size", "capacity", "pairs"))

        def merge(*xs):
            return dp.unshard_rows([x[:-1] for x in xs], cap, scratch=True)
        return EpisodeBuffer(tree_map(merge, *[p.stored for p in parts]),
                             merge(*[p.length for p in parts]), cursor, size, cap, pairs)

    def sample(self, generator, batch_size: int) -> Tuple[Any, torch.Tensor]:
        """→ (records (B, T_max, ...), mask (B, T_max) f32), uniform over the
        stored episodes. ``idx < size <= capacity``, so the scratch row is
        never read. In a process group, this rank's rows ``rank, rank +
        world, ...`` of rank 0's draw. Each stored leaf is gathered once; a
        pair's two fields are views of its gathered leaf."""
        with span("ring.sample"):
            world = dp.rank_world()[1]
            if world == 1:
                idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator,
                                    device=self.length.device)
                stored = tree_map(lambda buf: buf[idx], self.stored)
                length = self.length[idx]
            else:
                idx = dp.rank0_randint(generator, max(self.size, 1), batch_size)
                rows = dp.move_rows({"data": self.stored, "length": self.length}, idx % world,
                                    idx // world, np.arange(batch_size) % world)
                stored, length = rows["data"], rows["length"]
            steps = torch.arange(self.t_max, device=length.device)
            mask = (steps[None, :] < length[:, None]).float()
            return _fields(stored, self.pairs), mask


class EpisodeAccumulator:
    """Per-env episodes in progress: ``store`` gives every field of the
    record, ``(num_envs, T_max, ...)``, over the ``stored`` leaves (a pair's
    ``T_max + 1``); ``t`` is (num_envs,) int64."""

    def __init__(self, stored: Any, t: torch.Tensor, pairs: Optional[Dict[str, str]] = None):
        self.stored = stored
        self.pairs = {} if pairs is None else pairs
        self.t = t

    @property
    def store(self) -> Any:
        return _fields(self.stored, self.pairs)

    @staticmethod
    def create(num_envs: int, t_max: int, example: Any,
               pairs: Optional[Dict[str, str]] = None) -> "EpisodeAccumulator":
        pairs = _check_pairs(example, pairs)
        dev = tree_leaves(example)[0].device
        return EpisodeAccumulator(_allocate(num_envs, t_max, example, pairs),
                                  torch.zeros((num_envs,), dtype=torch.int64, device=dev), pairs)

    def shard(self, rank: int, world: int) -> "EpisodeAccumulator":
        """Rank ``rank``'s envs of this single-process accumulator."""
        return EpisodeAccumulator(tree_map(lambda x: dp.interleaved(x, rank, world),
                                           self.stored), dp.interleaved(self.t, rank, world),
                                  self.pairs)

    @staticmethod
    def unshard(parts) -> "EpisodeAccumulator":
        """The single-process accumulator of the ranks' ``parts`` (rank
        order): global env ``j`` from rank ``j % world``."""
        return EpisodeAccumulator(tree_map(lambda *xs: dp.uninterleaved(xs),
                                           *[p.stored for p in parts]),
                                  dp.uninterleaved([p.t for p in parts]),
                                  dp.agreed([p.pairs for p in parts], "acc.pairs"))

    def add_step(self, ring: EpisodeBuffer, record: Any, ended: torch.Tensor) -> int:
        """Append one step for every env and commit the episodes of the envs
        whose ``ended`` (num_envs,) flag is set into ``ring``, both in place.
        ``record`` has a leading num_envs axis. Returns the number of
        episodes committed, over every rank (read from the device: one
        sync)."""
        with span("ring.commit"):
            store = self.store
            num_envs, t_max = self.t.shape[0], tree_leaves(store)[0].shape[1]
            envs = torch.arange(num_envs, device=self.t.device)
            tw = torch.clamp(self.t, max=t_max - 1)

            # a pair's field lands at tw, its successor at tw + 1 of one leaf
            # (``store`` lists the successors last)
            def write_step(buf, x):
                buf[envs, tw] = x
            tree_map(write_step, store, record)
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
                tree_map(commit, ring.stored, self.stored)
                ring.length[dest] = new_t
                n_new = int(ended_i.sum())
            else:
                ends = np.flatnonzero(dp.gather_flags(ended)[0])      # global envs, in order
                n_new = len(ends)
                if n_new:
                    dest = (ring.cursor + np.arange(n_new)) % cap      # global rows
                    got = dp.move_rows({"data": self.stored, "length": new_t}, ends % world,
                                       ends // world, dest % world)
                    rows = torch.as_tensor(dest[dest % world == rank] // world,
                                           device=self.t.device)

                    def commit(buf, s):
                        buf[rows] = s
                    tree_map(commit, ring.stored, got["data"])
                    ring.length[rows] = got["length"]
            self.t = torch.where(ended, 0, new_t)

            ring.cursor = (ring.cursor + n_new) % cap
            ring.size = min(ring.size + n_new, cap)
            return n_new
