"""Data parallelism over ``torch.distributed`` (port of
``cleanmarl_tpu/distributed/dp.py``) for all seven families.

The JAX package shards the runner over a device mesh and lets XLA insert
the collectives. Here each rank is one process that holds its own share
of the envs and of the replay ring and a full copy of the params; the
families call the collectives themselves:

- **Env layout.** Global env ``j`` lives on rank ``j % world`` at local
  index ``j // world``. The JAX minibatches are contiguous env ranges;
  with this interleave every minibatch splits evenly over the ranks and a
  rank's share of minibatch ``i`` is its contiguous local range ``i``, so
  the per-rank update slices its envs as the single-process one does. It
  needs ``num_envs % (num_minibatches * world) == 0`` (``check_layout``).
- **Ring layout.** The off-policy rings shard by capacity: global row
  ``i`` lives on rank ``i % world`` at local index ``i // world``
  (``owned_rows``, any capacity, divided by the ranks or not), and every
  rank keeps its own scratch row. ``cursor`` and ``size`` are global host
  integers, equal on every rank. A commit gathers the ranks' end flags
  (``gather_flags``: the global order of ended envs), gives each finished
  episode, chunk or transition its single-process destination and sends
  it to the rank that owns that row (``move_rows``). A sample is drawn on
  rank 0 from its generator, as the single process draws it
  (``rank0_randint``), and each rank fetches batch rows ``rank, rank +
  world, ...`` from their owners; MADDPG's and FACMAC's update noise is
  drawn on rank 0 at the full batch shape and split the same way
  (``rank0_draw``).
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

Transport: nccl takes every collective on the card. gloo all-reduces and
broadcasts CUDA tensors through the host itself; the flags, the rows
that ``move_rows`` sends (``all_to_all_single``) and the drawn indices
and noise are staged through the host here (``_wire``), so the rows a
commit or a sample moves cost a device→host copy on gloo.

``DATA_FIELD_DIMS`` is the JAX table of per-env runner fields; a ring or
accumulator in it shards by its own ``shard(rank, world)``.
``shard_runner`` cuts a single-process runner into a rank's share and
``unshard_runners`` puts the ranks' shares back together, so a checkpoint
written by ``n`` ranks restores at any world the layout allows
(``core/checkpoint.py``).
``make_mesh``, ``runner_pspecs`` and ``runner_shardings`` describe XLA
shardings and have no counterpart.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np

import torch
import torch.distributed as dist

from cleanmarl_tpu_torch.core.params import tree_leaves, tree_map, tree_unflatten
from cleanmarl_tpu_torch.core.tracing import span

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


def resume_seed(seed: int, rank: int, world: int, step: int) -> int:
    """Seed of the new generator of rank ``rank`` when a checkpoint of step
    ``step``, written by fewer ranks, is restored at ``world`` ranks. Its
    low 32 bits lie in ``[seed + 2**31, seed + 2**31 + 2**30)`` modulo
    2**32, so they are never those of an init generator (``rank_seed``:
    ``seed + j``, ``j < 2**30``) or of the eval generator (``seed + 1``);
    the new ranks of one restore differ by their rank, and ``(world,
    step)`` choose the offset, so the streams of a restore at another
    world or step differ but for a 2**-30 chance."""
    mix = int.from_bytes(hashlib.blake2b(f"{world}:{step}".encode(), digest_size=8).digest(),
                         "little")
    return (seed + 2**31 + (mix + rank) % 2**30) % 2**32


def check_layout(num_envs: int, num_minibatches: int, world: int) -> int:
    """→ the envs of one rank; raises unless every minibatch splits evenly
    over the ranks."""
    if num_envs % (num_minibatches * world):
        raise ValueError(
            f"num_envs={num_envs} must be a multiple of num_minibatches x ranks = "
            f"{num_minibatches} x {world}: each rank takes every {world}-th env, "
            f"and each minibatch must split evenly over the ranks")
    return num_envs // world


def check_split(count: int, world: int, what: str) -> int:
    """→ this rank's rows of a sampled batch of ``count``; raises unless
    the ranks divide it."""
    if count % world:
        raise ValueError(
            f"{what}={count} must be a multiple of the {world} ranks: each rank takes "
            f"every {world}-th row of a sampled batch")
    return count // world


def owned_rows(capacity: int, rank: int, world: int) -> int:
    """Rows that rank ``rank`` holds of a ring of ``capacity`` global rows:
    the rows ``i`` with ``i % world == rank``, at local index ``i // world``."""
    return len(range(rank, capacity, world))


def interleaved(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rows ``rank, rank + world, ...`` of ``x`` (axis 0)."""
    return x[rank::world].clone()


def uninterleaved(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The inverse of ``interleaved``: ``parts[k]`` (rank order) holds
    entries ``k, k + world, ...`` of the result along axis ``dim``."""
    world, n = len(parts), sum(p.shape[dim] for p in parts)
    if [p.shape[dim] for p in parts] != [len(range(k, n, world)) for k in range(world)]:
        raise ValueError(f"{world} ranks' extents {[p.shape[dim] for p in parts]} on axis "
                         f"{dim} are not an interleave of {n}")
    shape = list(parts[0].shape)
    shape[dim] = n
    out = parts[0].new_empty(shape)
    for k, p in enumerate(parts):
        out[(slice(None),) * dim + (slice(k, None, world),)] = p
    return out


def unshard_rows(parts: Sequence[torch.Tensor], capacity: int,
                 scratch: bool = False) -> torch.Tensor:
    """The ``capacity`` global rows of a ring from the ranks' own rows (row
    ``i`` from rank ``i % world`` at ``i // world``), and with ``scratch``
    one zero scratch row after them."""
    rows = uninterleaved(parts)
    if rows.shape[0] != capacity:
        raise ValueError(f"the ranks hold {rows.shape[0]} ring rows, not the {capacity} "
                         f"of the ring's capacity")
    return torch.cat([rows, torch.zeros_like(rows[:1])]) if scratch else rows


def agreed(values: Sequence[Any], what: str) -> Any:
    """The one value that every rank holds; raises naming ``what`` unless
    all are equal (tensors: dtype, shape and every bit)."""
    def same(a, b):
        if isinstance(a, torch.Tensor):
            return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                    and a.shape == b.shape and torch.equal(a, b))
        return type(a) is type(b) and a == b
    if not all(same(values[0], v) for v in values[1:]):
        shown = values if not isinstance(values[0], torch.Tensor) else "tensors"
        raise ValueError(f"{what} differs across the {len(values)} ranks ({shown}); it must "
                         f"be equal on every rank")
    return values[0]


@dataclasses.dataclass
class CommStats:
    """Collectives this process issued: calls, bytes sent and, when
    ``timed`` (the device synchronized around each call), seconds."""
    timed: bool = False
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self, timed: bool = False) -> None:
        self.timed, self.calls, self.bytes, self.seconds = timed, 0, 0, 0.0


# a process trains one family, so one record serves every collective
COMM = CommStats()


def _collective(name: str, run: Callable[[], Any], payload: torch.Tensor,
                device: torch.device) -> None:
    """``run()``, one collective that sends ``payload``, counted in
    ``COMM`` and spanned as ``name`` (``dp.<op>``)."""
    sync = COMM.timed and device.type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with span(name):
        run()
    if sync:
        torch.cuda.synchronize(device)
    COMM.seconds += time.perf_counter() - t0
    COMM.calls += 1
    COMM.bytes += payload.numel() * payload.element_size()


def _all_reduce(flat: torch.Tensor) -> None:
    _collective("dp.all_reduce", lambda: dist.all_reduce(flat), flat, flat.device)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend takes it: on the host for gloo, else where
    it is."""
    return x.cpu() if dist.get_backend() == "gloo" else x


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


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over every rank's elements (each rank
    holds as many): its sum over the global count, the mean with one rank.
    Summed over the ranks (with the gradients) it is the global mean."""
    world = rank_world()[1]
    return x.mean() if world == 1 else x.sum() / (x.numel() * world)


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
    per-env field's env axis, the envs ``rank, rank + world, ...``; a ring
    or an accumulator takes its own share (``shard``: ring rows by
    ``owned_rows``, accumulator rows by env). A 0-d tensor in a per-env
    field is an additive partial sum (``EpisodeStats`` block sums): rank 0
    keeps it, the others start at zero, so the sums over the ranks are the
    full runner's. Replicated fields are shared; the generator is copied.
    ``unshard_runners`` is the inverse."""
    def take(field, d):
        def leaf(x):
            if hasattr(x, "shard"):
                return x.shard(rank, world)
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
            out[f.name] = copy_generator(value)
    return dataclasses.replace(runner, **out)


def copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(g.device)
    out.set_state(g.get_state())
    return out


def unshard_runners(parts: Sequence[Any], field_dims: Dict[str, int]):
    """The single-process runner of the ranks' shares ``parts`` (rank
    order), the inverse of ``shard_runner``: each per-env leaf
    re-interleaved on its env axis (global env ``j`` from rank ``j %
    world``), a ring or an accumulator through its own ``unshard``, each
    0-d partial sum added over the ranks. Replicated fields (params,
    targets, optimizer state, value-norm stats, ``last_*``) and host
    counters must be equal on every rank, else this raises naming the
    field; the generator is a copy of rank 0's. Scratch rows aside,
    ``unshard_runners([shard_runner(r, d, k, w) for k in range(w)], d)``
    is ``r``."""
    def merge(field, d):
        def leaf(*xs):
            x = xs[0]
            if hasattr(x, "unshard"):
                return type(x).unshard(list(xs))
            if not isinstance(x, torch.Tensor):
                return agreed(xs, field)
            if x.dim() == 0:
                total = x.clone()
                for y in xs[1:]:
                    total = total + y
                return total
            return uninterleaved(xs, d)
        return leaf

    out = {}
    for f in dataclasses.fields(parts[0]):
        values = [getattr(p, f.name) for p in parts]
        if f.name in field_dims:
            out[f.name] = tree_map(merge(f.name, field_dims[f.name]), *values)
        elif isinstance(values[0], torch.Generator):
            out[f.name] = copy_generator(values[0])
        else:
            tree_map(lambda *xs, name=f.name: agreed(xs, name), *values)
    return dataclasses.replace(parts[0], **out)


def global_layout(runner, world: int) -> Dict[str, int]:
    """The global extents that a runner's layout over ``world`` ranks
    depends on: ``num_envs`` (a rank's envs times the ranks) and, on the
    off-policy families, the ring's ``capacity`` (global already)."""
    out = {"num_envs": int(runner.obs.shape[0]) * world}
    for f in dataclasses.fields(runner):
        cap = getattr(getattr(runner, f.name), "capacity", None)
        if cap is not None:
            out["capacity"] = int(cap)
    return out


def gather_flags(*flags: torch.Tensor) -> np.ndarray:
    """Each rank's (local envs,) bool flags → (len(flags), num_envs) bool on
    the host, in global env order (env ``j`` from rank ``j % world``, row
    ``j // world``). One all-gather; the copy to the host is the caller's
    one device sync of an iteration."""
    local = torch.stack(flags).to(torch.uint8)
    world = rank_world()[1]
    if world == 1:
        return local.cpu().numpy().astype(bool)
    local = _wire(local)
    parts = [torch.empty_like(local) for _ in range(world)]
    _collective("dp.all_gather", lambda: dist.all_gather(parts, local), local, flags[0].device)
    both = torch.stack(parts, dim=-1).cpu()         # (k, local envs, world)
    return both.reshape(len(flags), -1).numpy().astype(bool)


def move_rows(tree: Any, src: np.ndarray, src_row: np.ndarray, dst: np.ndarray) -> Any:
    """Rows sent between ranks in one ``all_to_all_single``. The host arrays
    ``src``, ``src_row`` and ``dst``, equal on every rank, list the moved
    rows in a global order: row ``src_row[k]`` (axis 0) of every leaf of
    ``tree`` on rank ``src[k]`` goes to rank ``dst[k]``. → ``tree`` with
    the rows this rank receives, in that global order (leaves (received,
    ...)). The leaves travel as one byte matrix; a row that stays on its
    rank is copied there and never crosses the wire, and without a row
    that changes rank there is no collective."""
    rank, world = rank_world()
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    elems = [int(np.prod(x.shape[1:], dtype=np.int64)) for x in leaves]
    widths = [n * x.element_size() for n, x in zip(elems, leaves)]

    def packed(items):
        rows = torch.as_tensor(src_row[items], dtype=torch.int64, device=dev)
        return torch.cat([x.index_select(0, rows).reshape(len(rows), n).view(torch.uint8)
                          for n, x in zip(elems, leaves)], dim=1)
    mine = np.flatnonzero(dst == rank)
    # what this rank receives, ordered by source rank (each source's rows in
    # the global order): the other ranks' rows around its own
    own = packed(mine[src[mine] == rank])
    before = int(np.sum(src[mine] < rank))
    crossing = src != dst
    if crossing.any():
        sends = [np.flatnonzero((src == rank) & (dst == q) & crossing) for q in range(world)]
        out_rows = _wire(packed(np.concatenate(sends)))
        recv = torch.empty((len(mine) - len(own), out_rows.shape[1]), dtype=torch.uint8,
                           device=out_rows.device)
        counts = np.bincount(src[mine], minlength=world)
        counts[rank] = 0
        _collective("dp.all_to_all_single", lambda: dist.all_to_all_single(
            recv, out_rows, counts.tolist(), [len(k) for k in sends]), out_rows, dev)
        recv = recv.to(dev)
        own = torch.cat([recv[:before], own, recv[before:]])
    # back in the global order
    by_src = np.argsort(src[mine], kind="stable")
    own = own[torch.as_tensor(np.argsort(by_src), dtype=torch.int64, device=dev)]
    out, col = [], 0
    for x, w in zip(leaves, widths):
        out.append(own[:, col:col + w].clone(memory_format=torch.contiguous_format)
                   .view(x.dtype)
                   .reshape((len(mine),) + tuple(x.shape[1:])))
        col += w
    return tree_unflatten(tree, out)


def rank0_randint(generator: torch.Generator, high: int, n: int) -> np.ndarray:
    """``n`` indices uniform in ``[0, high)`` drawn on rank 0 from
    ``generator`` (on its device), as the single process draws them, and
    broadcast → on every rank, on the host."""
    dev = generator.device
    if rank_world()[0] == 0:
        idx = torch.randint(0, high, (n,), generator=generator, device=dev)
    else:
        idx = torch.empty((n,), dtype=torch.int64, device=dev)
    idx = _wire(idx)
    _collective("dp.broadcast", lambda: dist.broadcast(idx, src=0), idx, dev)
    return idx.cpu().numpy()


def rank0_draw(draw: Callable[[], Sequence[torch.Tensor]], count: int, shape,
               device) -> Tuple[torch.Tensor, ...]:
    """``draw()`` → ``count`` float32 tensors of ``shape`` (the batch axis
    first) on rank 0, broadcast in one collective → each one's batch rows
    ``rank, rank + world, ...`` (``draw()`` itself with one rank)."""
    rank, world = rank_world()
    if world == 1:
        return tuple(draw())
    if rank == 0:
        buf = torch.stack(tuple(draw()))
    else:
        buf = torch.empty((count,) + tuple(shape), dtype=torch.float32, device=device)
    wire = _wire(buf)
    _collective("dp.broadcast", lambda: dist.broadcast(wire, src=0), wire, torch.device(device))
    buf = wire.to(device)
    return tuple(x[rank::world].contiguous() for x in buf)
