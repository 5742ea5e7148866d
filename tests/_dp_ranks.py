"""Rank programs for ``tests/test_torch_distributed.py``.

``run_ranks`` starts ``world`` processes with the ``spawn`` method; each
runs one function of this module as one rank of a gloo process group on
a free localhost port and sends back its result. This module imports
neither JAX nor the JAX package, so a rank starts in about two seconds.
"""
from __future__ import annotations

import multiprocessing
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cleanmarl_tpu_torch.distributed.multihost import free_port


def join(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def _entry(fn, rank, world, port, args, out):
    torch.set_num_threads(1)
    try:
        out.put((rank, "ok", fn(rank, world, port, *args)))
    except BaseException:            # reported to the parent, which fails
        out.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """``fn(rank, world, port, *args)`` on ``world`` spawned ranks → the
    results, ordered by rank. Raises with a rank's traceback if it failed."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):          # drain before joining
            rank, status, value = out.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for p in procs:
        if p.exitcode != 0:
            raise RuntimeError(f"a rank exited with {p.exitcode}")
    return [results[r] for r in range(world)]


def _np(tree):
    from cleanmarl_tpu_torch.core.params import tree_map

    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)


def _shard(x, rank, world, dim):
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(rank, None, world)
    return torch.as_tensor(np.ascontiguousarray(x[tuple(idx)]))


def _opt(state):
    """A port optimizer state with numpy moments → tensors on the CPU."""
    from cleanmarl_tpu_torch.core.params import from_numpy_tree

    return dict(state, mu=from_numpy_tree(state["mu"], "cpu"),
                nu=from_numpy_tree(state["nu"], "cpu"))


def _ppo_full(kw, centralized, start, traj, h0):
    """A full single-process PPO runner made from ``start`` (before the
    process group exists, so ``make_train`` builds every env)."""
    from cleanmarl_tpu_torch.algos import ppo_common
    from cleanmarl_tpu_torch.core.params import from_numpy_tree

    cfg = ppo_common.PPOConfig(**kw, device="cpu")
    init_full, _, _, _ = ppo_common.make_train(cfg, centralized=centralized)
    return init_full(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(start["actor_params"], "cpu"),
        critic_params=from_numpy_tree(start["critic_params"], "cpu"),
        actor_opt=_opt(start["actor_opt"]), critic_opt=_opt(start["critic_opt"]),
        vnorm=from_numpy_tree(start["vnorm"], "cpu"),
        obs=torch.as_tensor(start["obs"]), state=torch.as_tensor(start["state"]),
        num_updates=start["num_updates"])


def _ppo_local(rank, world, full, kw, centralized, start, traj, h0):
    """One PPO update on this rank's share (``shard_runner``; the traj's
    env axis interleaved the same way)."""
    from cleanmarl_tpu_torch.algos import ppo_common
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, dp, shard_runner

    cfg = ppo_common.PPOConfig(**kw, device="cpu")
    _, _, _, meta = ppo_common.make_train(cfg, centralized=centralized)
    local = shard_runner(full, DATA_FIELD_DIMS["PPO"], rank, world)
    traj_l = {k: _shard(v, rank, world, 1) for k, v in traj.items()}
    traj_l["action"] = traj_l["action"].long()
    dp.COMM.reset()
    out, metrics = meta["ppo_update"](local, traj_l, _shard(h0, rank, world, 0))
    return dict(actor_params=_np(out.actor_params), critic_params=_np(out.critic_params),
                vnorm=_np(out.vnorm), metrics={k: float(v) for k, v in metrics.items()},
                num_updates=out.num_updates, local_envs=meta["local_envs"],
                collectives=dp.COMM.calls)


def _coma_full(kw, start, traj, h0, live, epsilon):
    from cleanmarl_tpu_torch.algos import coma
    from cleanmarl_tpu_torch.core.params import from_numpy_tree

    init_full, _, _, _ = coma.make_train(coma.COMAConfig(**kw, device="cpu"))
    return init_full(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(start["actor_params"], "cpu"),
        critic_params=from_numpy_tree(start["critic_params"], "cpu"),
        target_critic=from_numpy_tree(start["target_critic"], "cpu"),
        actor_opt=_opt(start["actor_opt"]), critic_opt=_opt(start["critic_opt"]),
        num_updates=start["num_updates"],
        **{k: torch.as_tensor(v) for k, v in live.items()})


def _coma_local(rank, world, full, kw, start, traj, h0, live, epsilon):
    """One COMA update on this rank's share of the full runner."""
    from cleanmarl_tpu_torch.algos import coma
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, shard_runner

    _, _, _, meta = coma.make_train(coma.COMAConfig(**kw, device="cpu"))
    local = shard_runner(full, DATA_FIELD_DIMS["COMA"], rank, world)
    traj_l = {k: _shard(v, rank, world, 1) for k, v in traj.items()}
    out, metrics = meta["update"](local, traj_l, _shard(h0, rank, world, 0), epsilon)
    return dict(actor_params=_np(out.actor_params), critic_params=_np(out.critic_params),
                target_critic=_np(out.target_critic),
                metrics={k: float(v) for k, v in metrics.items()},
                num_updates=out.num_updates)


_JOBS = {"ppo": (_ppo_full, _ppo_local), "coma": (_coma_full, _coma_local)}


def run_jobs(rank, world, port, jobs):
    """Each ``(kind, name, args)`` job: its full runner built first, then,
    in the process group, one update on this rank's share → {name: result}."""
    fulls = [_JOBS[kind][0](*args) for kind, _, args in jobs]
    join(rank, world, port)
    return {name: _JOBS[kind][1](rank, world, full, *args)
            for (kind, name, args), full in zip(jobs, fulls)}


def mappo_block(rank, world, port, kw):
    """``global_runner_init`` and one rollout (its rollout metrics and this
    rank's episode sums), then one driven ``train_block`` from the start."""
    from cleanmarl_tpu_torch.algos import mappo
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, dp

    join(rank, world, port)
    init, train_block, _, meta = mappo.make_train(mappo.PPOConfig(**kw, device="cpu"))
    gen = torch.Generator().manual_seed(dp.rank_seed(kw["seed"], rank))
    runner = dp.global_runner_init(init, gen, DATA_FIELD_DIMS["PPO"])
    init_params = _np(runner.actor_params)
    gen_state = gen.get_state().clone()
    r1, _, _ = meta["collect_rollout"](runner)
    s = r1.stats
    sums = [float(x) for x in (s.ret_sum, s.len_sum, s.won_sum, s.count)]
    rollout = to_host(s.rollout_metrics())
    gen.set_state(gen_state)               # the block replays the same rollout
    runner, metrics = train_block(runner)
    return dict(init_params=init_params, params=_np(runner.actor_params),
                critic=_np(runner.critic_params), obs=runner.obs.numpy(), sums=sums,
                rollout=rollout, metrics=to_host(metrics), step=runner.step,
                local_envs=meta["local_envs"])
