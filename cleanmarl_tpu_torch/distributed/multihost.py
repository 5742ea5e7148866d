"""Multi-process bootstrap over ``torch.distributed`` (port of
``cleanmarl_tpu/distributed/multihost.py``).

Every process runs the same training CLI with ``--coordinator_address
host:port --num_processes N --process_id i``; ``cli()`` calls
``maybe_initialize`` right after parsing, which joins the process group
(a ``TCPStore`` at ``host:port``, as ``init_method="tcp://host:port"``
makes one). Rank ``r`` uses ``cuda:{r % device_count}``.

Backend rule (printed once, by rank 0):

- ``nccl`` when every rank has a card of its own: the device is CUDA and
  on every host the ranks are no more than its cards. Before the group
  forms, each rank posts its host name and card count to the store, and
  every rank reads the same layout, so all pick the same backend and a
  multi-host cluster needs no launcher variable;
- ``gloo`` when ranks share a card or run on the CPU. NCCL refuses two
  ranks on one device; gloo all-reduces CUDA tensors through the host,
  and the tensors stay on the card.

The rule picks a transport, never a device: a rank asked to run on the
card runs there with either backend.

``--use_mesh`` in the JAX package shards one process over every visible
device and does nothing with one. Here it spawns one rank per visible
card on a localhost rendezvous (``spawn_mesh``), and does nothing with
one card or on the CPU.
"""
from __future__ import annotations

import atexit
import dataclasses
import socket
from collections import Counter
from datetime import timedelta
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist


def _device_type(cfg) -> str:
    return torch.device(getattr(cfg, "device", "cuda")).type


def choose_backend(store, rank: int, world: int, cards: int) -> Tuple[str, int]:
    """Post this rank's host name and ``cards`` (the cards it may use, 0
    on the CPU) to ``store``, read every rank's → (the backend of the
    module's rule, the ranks on the busiest host). Every rank reads the
    same posts, so every rank returns the same."""
    store.set(f"cleanmarl/host/{rank}", f"{socket.gethostname()} {cards}")
    keys = [f"cleanmarl/host/{r}" for r in range(world)]
    store.wait(keys)
    ranks: Counter = Counter()
    cards_of = {}
    for k in keys:
        host, n = store.get(k).decode().rsplit(" ", 1)
        ranks[host] += 1
        cards_of[host] = int(n)
    own_card = all(0 < n <= cards_of[h] for h, n in ranks.items())
    return ("nccl" if own_card else "gloo"), max(ranks.values())


def maybe_initialize(cfg) -> bool:
    """Join the process group when the config carries a coordinator
    address (no-op otherwise). On the card, pins this rank to its card
    and writes it into ``cfg.device``. Returns True when it joined."""
    addr = getattr(cfg, "coordinator_address", "")
    if not addr or dist.is_initialized():
        return False
    world = int(getattr(cfg, "num_processes", 1))
    rank = int(getattr(cfg, "process_id", 0))
    if not 0 <= rank < world:
        raise ValueError(f"process_id={rank} is not in [0, num_processes={world})")
    on_card = _device_type(cfg) == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError(f"device={cfg.device!r} was requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    host, port = addr.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(minutes=30))
    backend, busiest = choose_backend(store, rank, world,
                                      torch.cuda.device_count() if on_card else 0)
    where = "cpu"
    if on_card:
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        cfg.device = where = f"cuda:{index}"
    dist.init_process_group(backend, store=store, world_size=world, rank=rank)
    atexit.register(_destroy)
    if rank == 0:
        why = ("a card per rank" if backend == "nccl" else
               "ranks share a card" if where != "cpu" else "CPU")
        print(f"[dist] {world} ranks, backend {backend} ({why}; at most {busiest} on "
              f"a host); rank 0 on {where}", flush=True)
    return True


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_ranks(cfg) -> int:
    """Ranks that ``--use_mesh`` asks for: one per visible card when the run
    is on the card, not already in a process group, and sees more than one
    card; else 1 (nothing to do)."""
    if (not getattr(cfg, "use_mesh", False) or dist.is_initialized()
            or _device_type(cfg) != "cuda" or not torch.cuda.is_available()):
        return 1
    return max(1, torch.cuda.device_count())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_rank(rank: int, fn: Callable, cfg: Any, world: int, port: int, results) -> None:
    cfg = dataclasses.replace(cfg, coordinator_address=f"localhost:{port}",
                              num_processes=world, process_id=rank, use_mesh=False)
    maybe_initialize(cfg)
    _, eval_metrics = fn(cfg)
    if rank == 0:
        results.put(eval_metrics)


def spawn_if_mesh(fn: Callable, cfg: Any, env=None, logger=None):
    """A family's ``train(cfg, env, logger)`` under ``--use_mesh``: on more
    than one card, ``fn(cfg)`` (``train`` itself, importable by name) runs
    on one spawned rank per card, which builds the env and logger itself,
    → (None, rank 0's last eval metrics); else None: train here."""
    ranks = mesh_ranks(cfg)
    if ranks == 1:
        return None
    if env is not None or logger is not None:
        raise ValueError("--use_mesh builds the env and logger in every rank: pass neither")
    return spawn_mesh(fn, cfg, ranks)


def spawn_mesh(fn: Callable, cfg: Any, world: int):
    """Run ``fn(cfg)`` (a family's ``train``, importable by name) on
    ``world`` spawned ranks, one per card, over a localhost rendezvous.
    The kernels are built here first, so the ranks load them and no two
    ``nvcc`` runs compete. → (None, rank 0's last eval metrics): the
    runners stay in the ranks."""
    import torch.multiprocessing as mp

    from cleanmarl_tpu_torch.ops import _build

    _build.build_all()
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.spawn(_mesh_rank, args=(fn, cfg, world, free_port(), results), nprocs=world,
             join=True)
    return None, results.get() if not results.empty() else {}
