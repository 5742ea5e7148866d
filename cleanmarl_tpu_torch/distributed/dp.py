"""Env-batch data parallelism over ``torch.distributed`` (port of
``cleanmarl_tpu/distributed/dp.py``), for the on-policy families (MAPPO,
IPPO, COMA).

The JAX package shards the runner over a device mesh and lets XLA insert
the collectives. Here each rank is one process that holds its own share
of the envs and a full copy of the params; the families call the
collectives themselves:

- **Env layout.** Global env ``j`` lives on rank ``j % world`` at local
  index ``j // world``. The JAX minibatches are contiguous env ranges;
  with this interleave every minibatch splits evenly over the ranks and a
  rank's share of minibatch ``i`` is its contiguous local range ``i``, so
  the per-rank update slices its envs as the single-process one does. It
  needs ``num_envs % (num_minibatches * world) == 0`` (``check_layout``).
- **Init.** Every rank runs ``init`` from its own generator
  (``rank_seed``: rank 0's is the single-process seed), so each rank's
  envs follow their own stream; then the
  replicated fields (params, targets, optimizer state, value-norm stats)
  are broadcast from rank 0 (``global_runner_init``).
- **Update.** Batch-wide statistics are reduced across ranks
  (``global_sum``, ``global_mean_std``), each loss is the local sum over
  the global count, and the gradients are summed across ranks in one
  flattened all-reduce (``all_reduce_sum``) before the norm, clipping and
  Adam, so every rank takes the same step and the params stay identical.

With one rank every collective is skipped and the arithmetic is the
single-process path's, bit for bit.

``DATA_FIELD_DIMS`` is the JAX table of per-env runner fields. The
off-policy entries keep their JAX meaning (their rings shard by
capacity), but those families have no data-parallel path here yet
(ROADMAP Queue A, A8). ``make_mesh``, ``runner_pspecs`` and
``runner_shardings`` describe XLA shardings and have no counterpart.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map, tree_unflatten

# runner field name → axis carrying the env batch; every other field
# (params, targets, optimizer states, value-norm stats, host counters) is
# replicated, and each rank keeps its own generator
_COMMON = {"env_state": 0, "obs": 0, "state": 0, "avail": 0, "stats": 0}
DATA_FIELD_DIMS: Dict[str, Dict[str, int]] = {
    "PPO": {**_COMMON, "actor_h": 0},
    "COMA": {**_COMMON, "actor_h": 0},
    "VDN": {**_COMMON, "buffer": 0},
    "QMIX": {**_COMMON, "acc": 0, "ring": 0},
    "RECURRENT_Q": {**_COMMON, "h": 0, "acc": 0, "ring": 0},
    "MADDPG": {**_COMMON, "actor_h": 0, "acc": 0, "ring": 0},
    "FACMAC": {**_COMMON, "acc": 0, "ring": 0},
}


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    if rank_world()[1] > 1:
        dist.barrier()


def rank_seed(seed: int, rank: int) -> int:
    """Seed of rank ``rank``'s init generator: ``seed`` on rank 0 (the
    single-process run's), ``seed + 1 + rank`` on the others, which never
    equals the eval generator's ``seed + 1``, nor another rank's, even in
    the low 32 bits that the CPU generator keeps."""
    return seed if rank == 0 else seed + 1 + rank


def check_layout(num_envs: int, num_minibatches: int, world: int) -> int:
    """→ the envs of one rank; raises unless every minibatch splits evenly
    over the ranks."""
    if num_envs % (num_minibatches * world):
        raise ValueError(
            f"num_envs={num_envs} must be a multiple of num_minibatches x ranks = "
            f"{num_minibatches} x {world}: each rank takes every {world}-th env, "
            f"and each minibatch must split evenly over the ranks")
    return num_envs // world


@dataclasses.dataclass
class CommStats:
    """Collectives this process issued: calls, float32 elements moved and,
    when ``timed`` (the device synchronized around each call), seconds."""
    timed: bool = False
    calls: int = 0
    elements: int = 0
    seconds: float = 0.0

    def reset(self, timed: bool = False) -> None:
        self.timed, self.calls, self.elements, self.seconds = timed, 0, 0, 0.0


# a process trains one family, so one record serves every collective
COMM = CommStats()


def _all_reduce(flat: torch.Tensor) -> None:
    sync = COMM.timed and flat.is_cuda
    if sync:
        torch.cuda.synchronize(flat.device)
    t0 = time.perf_counter()
    dist.all_reduce(flat)
    if sync:
        torch.cuda.synchronize(flat.device)
    COMM.seconds += time.perf_counter() - t0
    COMM.calls += 1
    COMM.elements += flat.numel()


def global_sum(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor summed over the ranks, all in one collective (the
    tensors themselves with one rank)."""
    if rank_world()[1] == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    _all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return tuple(out)


def all_reduce_sum(trees: Sequence[Any]) -> List[Any]:
    """Every float32 leaf of every tree summed over the ranks in one
    flattened all-reduce → the trees, same shapes (themselves with one
    rank)."""
    if rank_world()[1] == 1:
        return list(trees)
    leaves = [x for tree in trees for x in tree_leaves(tree)]
    for x in leaves:
        if x.dtype != torch.float32:
            raise TypeError(f"all_reduce_sum takes float32 leaves, got {x.dtype}")
    flat = torch.cat([x.reshape(-1) for x in leaves])
    _all_reduce(flat)
    out, i = [], 0
    for tree in trees:
        new = []
        for x in tree_leaves(tree):
            new.append(flat[i:i + x.numel()].view(x.shape))
            i += x.numel()
        out.append(tree_unflatten(tree, new))
    return out


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over every rank's elements (each rank holds as many)."""
    world = rank_world()[1]
    if world == 1:
        return x.mean()
    (s,) = global_sum(x.sum())
    return s / (x.numel() * world)


def global_mean_std(x: torch.Tensor):
    """(mean, population std) over every rank's elements, two-pass as
    ``x.mean()``, ``x.std(unbiased=False)`` compute it on one rank."""
    if rank_world()[1] == 1:
        return x.mean(), x.std(unbiased=False)
    mean = global_mean(x)
    return mean, torch.sqrt(global_mean(torch.square(x - mean)))


def replicate(tree):
    """Every tensor leaf of ``tree`` broadcast from rank 0, in place."""
    if rank_world()[1] > 1:
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor):
                dist.broadcast(x, src=0)
    return tree


def global_runner_init(init_fn, generator: torch.Generator, field_dims: Dict[str, int]):
    """``init_fn(generator)`` on this rank, then every replicated field
    (not per-env, not the generator, not a host number) taken from rank 0."""
    runner = init_fn(generator)
    for f in dataclasses.fields(runner):
        if f.name not in field_dims:
            replicate(getattr(runner, f.name))
    return runner


def shard_runner(runner, field_dims: Dict[str, int], rank: int, world: int):
    """Rank ``rank``'s share of a full single-process runner: along each
    per-env field's env axis, the envs ``rank, rank + world, ...``. A 0-d
    tensor in a per-env field is an additive partial sum (``EpisodeStats``
    block sums): rank 0 keeps it, the others start at zero, so the sums
    over the ranks are the full runner's. Replicated fields are shared;
    the generator is copied."""
    def take(field, d):
        def leaf(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.dim() == 0:
                return x.clone() if rank == 0 else torch.zeros_like(x)
            if x.dim() <= d or x.shape[d] % world:
                raise ValueError(f"{field}: a leaf of shape {tuple(x.shape)} has no "
                                 f"env axis {d} that {world} ranks divide")
            idx = torch.arange(rank, x.shape[d], world, device=x.device)
            return torch.index_select(x, d, idx)
        return leaf

    out = {}
    for f in dataclasses.fields(runner):
        value = getattr(runner, f.name)
        if f.name in field_dims:
            out[f.name] = tree_map(take(f.name, field_dims[f.name]), value)
        elif isinstance(value, torch.Generator):
            gen = torch.Generator(value.device)
            gen.set_state(value.get_state())
            out[f.name] = gen
    return dataclasses.replace(runner, **out)
