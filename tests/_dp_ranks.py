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

    return tree_map(lambda x: np.array(x.detach().cpu()) if isinstance(x, torch.Tensor) else x,
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


def ppo_optimizer_updates(rank, world, port, kw, names):
    """For each optimizer name: a single-process MAPPO runner, one rollout
    and one update from it (before the group exists), then, in the group,
    one update of this rank's share of the same runner and rollout →
    {name: dict(single=..., params=...)}, actor and critic params."""
    from cleanmarl_tpu_torch.algos import ppo_common
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, shard_runner

    def cfg(name):
        return ppo_common.PPOConfig(**dict(kw, optimizer=name), device="cpu")
    before = {}
    for name in names:
        init, _, _, meta = ppo_common.make_train(cfg(name), centralized=True)
        full, traj, h0 = meta["collect_rollout"](init(torch.Generator().manual_seed(0)))
        single, _ = meta["ppo_update"](full, traj, h0)
        before[name] = (full, _np(traj), h0.numpy(),
                        _np((single.actor_params, single.critic_params)))
    join(rank, world, port)
    out = {}
    for name, (full, traj, h0, single) in before.items():
        _, _, _, meta = ppo_common.make_train(cfg(name), centralized=True)
        local = shard_runner(full, DATA_FIELD_DIMS["PPO"], rank, world)
        traj_l = {k: _shard(v, rank, world, 1) for k, v in traj.items()}
        upd, _ = meta["ppo_update"](local, traj_l, _shard(h0, rank, world, 0))
        out[name] = dict(single=single, params=_np((upd.actor_params, upd.critic_params)),
                         count=upd.actor_opt["count"], local_envs=meta["local_envs"])
    return out


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


# ---------------------------------------------------------------------------
# the off-policy families (tests/test_torch_distributed_offpolicy.py and the
# driver-option tests of test_torch_{qmix,maddpg,facmac}.py)
# ---------------------------------------------------------------------------

def _ring_pair(kind, cap, length, example, num_envs, rank, world):
    from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
    from cleanmarl_tpu_torch.buffers.sequence import SequenceAccumulator, SequenceBuffer
    from cleanmarl_tpu_torch.buffers.transition import TransitionBuffer

    if kind == "episode":
        return (EpisodeBuffer.create(cap, length, example, rank, world),
                EpisodeAccumulator.create(num_envs, length, example))
    if kind == "sequence":
        return (SequenceBuffer.create(cap, length, example, rank, world),
                SequenceAccumulator.create(num_envs, length, example))
    return TransitionBuffer.create(cap, example, rank, world), None


def feed_ring(kind, cap, length, steps, rank=0, world=1, sample=(5, 6)):
    """A ring of ``kind`` (episode, sequence or transition) of ``cap`` global
    rows fed this rank's envs of every ``(record, ended)`` step (numpy,
    leading axis num_envs) → after each step (the ring's rows, lengths,
    cursor, size and the counts ``add_step`` returned), then
    ``ring.sample(Generator(seed), n)`` for ``sample = (seed, n)``."""
    rec0 = steps[0][0]
    example = {k: torch.zeros(v.shape[1:], dtype=torch.as_tensor(v).dtype)
               for k, v in rec0.items()}
    ring, acc = _ring_pair(kind, cap, length, example, rec0["obs"].shape[0] // world, rank,
                           world)
    snaps = []
    for rec, ended in steps:
        local = {k: _shard(v, rank, world, 0) for k, v in rec.items()}
        if kind == "transition":
            ring.add_batch(local)
            counts = None
        else:
            counts = acc.add_step(ring, local, _shard(ended, rank, world, 0))
        snaps.append(dict(data=_np(ring.data), cursor=ring.cursor, size=ring.size,
                          counts=counts, length=_np(getattr(ring, "length", None))))
    drawn = ring.sample(torch.Generator().manual_seed(sample[0]), sample[1])
    return dict(snaps=snaps, sample=_np(drawn))


def commit_rings(rank, world, port, cases):
    join(rank, world, port)
    return {name: feed_ring(*args, rank=rank, world=world) for name, args in cases.items()}


def _port_state(start):
    from cleanmarl_tpu_torch.core.params import from_numpy_tree

    return {k: (_opt(v) if "opt" in k else from_numpy_tree(v, "cpu"))
            for k, v in start.items()}


def _offpolicy_update(rank, world, family, kw, start, batch, mask, noise):
    """One update of ``family`` on this rank's rows ``rank::world`` of the
    sampled ``batch`` (and its mask and noise) from the ``start`` state."""
    from cleanmarl_tpu_torch.types import Transition

    mod, cls = _family(family)
    init, _, _, meta = mod.make_train(cls(**kw, device="cpu"))
    b = {k: _shard(v, rank, world, 0) for k, v in batch.items()}
    if "action" in b and b["action"].dtype == torch.int32:
        b["action"] = b["action"].long()
    m = None if mask is None else _shard(mask, rank, world, 0)
    st = _port_state(start)
    if family in ("maddpg", "facmac"):
        runner = init(torch.Generator().manual_seed(0)).replace(**st)
        out = meta["update"](runner, b, m, tuple(_shard(x, rank, world, 0) for x in noise))
        return dict(actor=_np(out[0]), critic=_np(out[1]),
                    metrics=[float(x) for x in out[4:]])
    args = (st["params"], st["target_params"], st["opt_state"])
    if family == "vdn":
        out = meta["update"](*args, Transition(**b))
    elif kw.get("replay") == "sequence":
        out = meta["update_seq"](*args, b)
    else:
        out = meta["update"](*args, b, m)
    return dict(params=_np(out[0]), metrics=[float(out[2]), float(out[3])],
                count=out[1]["count"])


def offpolicy_updates(rank, world, port, jobs):
    """Every ``name: (family, kw, start, batch, mask, noise)`` job as one
    update in the process group → {name: result}."""
    join(rank, world, port)
    from cleanmarl_tpu_torch.distributed import dp

    out = {}
    for name, args in jobs.items():
        dp.COMM.reset()
        out[name] = dict(_offpolicy_update(rank, world, *args), collectives=dp.COMM.calls)
    return out


def _family(family):
    from cleanmarl_tpu_torch.algos import facmac, maddpg, qmix, recurrent_q, vdn

    return {"qmix": (qmix, qmix.QMIXConfig), "vdn": (vdn, vdn.VDNConfig),
            "recq": (recurrent_q, recurrent_q.RecurrentQConfig),
            "maddpg": (maddpg, maddpg.MADDPGConfig),
            "facmac": (facmac, facmac.FACMACConfig)}[family]


def _params_of(runner):
    return {k: _np(getattr(runner, k)) for k in ("params", "actor_params", "critic_params")
            if hasattr(runner, k)}


def offpolicy_blocks(rank, world, port, jobs, blocks=2):
    """Each ``name: (family, kw)``: ``global_runner_init`` and ``blocks``
    train blocks on this rank → its params, host counters, ring layout and
    metrics."""
    from cleanmarl_tpu_torch.core.driver import to_host
    from cleanmarl_tpu_torch.core.params import tree_leaves
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, dp

    join(rank, world, port)
    out = {}
    for name, (family, kw) in jobs.items():
        mod, cls = _family(family)
        cfg = cls(**kw, device="cpu")
        init, train_block, _, meta = mod.make_train(cfg)
        table = DATA_FIELD_DIMS[{"recq": "RECURRENT_Q"}.get(family, family.upper())]
        runner = dp.global_runner_init(
            init, torch.Generator().manual_seed(dp.rank_seed(cfg.seed, rank)), table)
        init_params = _params_of(runner)
        metrics = []
        for _ in range(blocks):
            runner, m = train_block(runner)
            metrics.append(to_host(m))
        ring = getattr(runner, "ring", None) or runner.buffer
        out[name] = dict(init_params=init_params, params=_params_of(runner), metrics=metrics,
                         step=runner.step, episodes=getattr(runner, "episodes", None),
                         num_updates=runner.num_updates, cursor=ring.cursor, size=ring.size,
                         capacity=ring.capacity,
                         rows=tree_leaves(ring.data)[0].shape[0],
                         local_envs=meta["local_envs"], obs=runner.obs.numpy())
    return out


def driver_options(rank, world, port, family, kw, workdir):
    """``train`` of ``family`` in the process group with each driver option
    that needs the group: ``checkpoint_dir`` (then a resume to twice the
    budget), ``profile_dir`` and ``num_processes`` → what each left."""
    import dataclasses
    import os
    import types

    join(rank, world, port)
    mod, cls = _family(family)
    log = types.SimpleNamespace(log=lambda *a: None, close=lambda: None)
    base = cls(**kw, device="cpu")
    total = base.total_timesteps
    ckpt, prof = os.path.join(workdir, "ckpt"), os.path.join(workdir, "prof")
    out = {}
    runner, _ = mod.train(dataclasses.replace(base, checkpoint_dir=ckpt), logger=log)
    resumed, _ = mod.train(dataclasses.replace(base, checkpoint_dir=ckpt, resume=True,
                                               total_timesteps=2 * total), logger=log)
    out["checkpoint"] = dict(step=runner.step, resumed_step=resumed.step,
                             params=_params_of(resumed),
                             episodes=getattr(resumed, "episodes", None))
    runner, _ = mod.train(dataclasses.replace(base, profile_dir=prof), logger=log)
    out["profile"] = dict(step=runner.step)
    runner, _ = mod.train(dataclasses.replace(base, num_processes=world), logger=log)
    ring = getattr(runner, "ring", None) or runner.buffer
    out["multiprocess"] = dict(step=runner.step, params=_params_of(runner),
                               episodes=getattr(runner, "episodes", None),
                               cursor=ring.cursor, size=ring.size,
                               num_updates=runner.num_updates)
    return out


def check_driver_option(option, mod, cfg, workdir, ranks, monkeypatch):
    """What each driver option did for family ``mod`` (``driver_options``'s
    2-rank results ``ranks``; ``use_mesh`` over two mocked cards spawns
    ``mod.train`` on 2 ranks, mocked here)."""
    import json
    import os

    from cleanmarl_tpu_torch.distributed import multihost

    if option == "mesh":
        calls = []
        monkeypatch.setattr(multihost, "mesh_ranks", lambda c: 2)
        monkeypatch.setattr(multihost, "spawn_mesh", lambda fn, c, world: (
            calls.append((fn, c, world)), (None, {"eval/ep_reward": 1.0}))[1])
        out = mod.train(cfg.__class__(**{**vars(cfg), "use_mesh": True}))
        assert out == (None, {"eval/ep_reward": 1.0})
        fn, spawned, world = calls[0]
        assert world == 2 and spawned.use_mesh
        assert getattr(fn, "func", fn) is mod.train       # importable by name
        return
    r0, r1 = ranks[0][option], ranks[1][option]
    steps = cfg.total_timesteps // cfg.num_envs            # iterations of the budget
    if option == "checkpoint":
        ckpt = os.path.join(workdir, "ckpt")
        total = cfg.total_timesteps
        assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [total, 2 * total]
        with open(os.path.join(ckpt, str(2 * total), "meta.json")) as f:
            assert json.load(f)["world"] == 2
        assert sorted(os.listdir(os.path.join(ckpt, str(2 * total)))) == [
            "meta.json", "rank0.pt", "rank1.pt"]
        assert (r0["step"], r0["resumed_step"]) == (steps, 2 * steps)
        assert r0["episodes"] == r1["episodes"] > 0
    elif option == "profile":
        traces = os.listdir(os.path.join(workdir, "prof"))
        assert len(traces) == 2 and all(t.endswith(".pt.trace.json") for t in traces)
        assert r0["step"] == r1["step"] == steps
    else:
        assert r0["step"] == steps and r0["num_updates"] > 0
        for k in ("episodes", "cursor", "size", "num_updates"):
            assert r0[k] == r1[k], k
    from cleanmarl_tpu_torch.core.params import tree_leaves

    for a, b in zip(tree_leaves(r0.get("params", {})), tree_leaves(r1.get("params", {})),
                    strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# restore at another world size (tests/test_torch_elastic_resume.py)
# ---------------------------------------------------------------------------

def _kind(family):
    """(module, config class, ``DATA_FIELD_DIMS`` key) of a family."""
    from cleanmarl_tpu_torch.algos import coma, mappo

    if family == "mappo":
        return mappo, mappo.PPOConfig, "PPO"
    if family == "coma":
        return coma, coma.COMAConfig, "COMA"
    mod, cls = _family(family)
    return mod, cls, {"recq": "RECURRENT_Q"}.get(family, family.upper())


def fresh(family, kw, rank=0):
    """``make_train`` of ``family`` at this process's world and a fresh
    ``global_runner_init`` → (train_block, meta, runner, fields table)."""
    from cleanmarl_tpu_torch.distributed import DATA_FIELD_DIMS, dp

    mod, cls, table = _kind(family)
    cfg = cls(**kw, device="cpu")
    init, train_block, _, meta = mod.make_train(cfg)
    dims = DATA_FIELD_DIMS[table]
    gen = torch.Generator().manual_seed(dp.rank_seed(cfg.seed, rank))
    return train_block, meta, dp.global_runner_init(init, gen, dims), dims


def checkpointer(workdir, name, wrote, dims, kw):
    """The checkpoint directory of case ``name`` written by ``wrote`` ranks."""
    import os

    from cleanmarl_tpu_torch.core.checkpoint import Checkpointer

    return Checkpointer(os.path.join(workdir, name, str(wrote)), field_dims=dims,
                        seed=kw["seed"])


def restored_update(family, rank, world, meta, runner, args):
    """One update from a restored ``runner`` on this rank's share of a fixed
    input: MAPPO's ``ppo_update`` on ``(traj, h0)`` (env axis interleaved),
    recurrent Q's ``update`` on ``(batch, mask)`` (rows ``rank::world``)."""
    if family == "mappo":
        traj, h0 = args
        traj_l = {k: _shard(v, rank, world, 1) for k, v in traj.items()}
        traj_l["action"] = traj_l["action"].long()
        out, metrics = meta["ppo_update"](runner, traj_l, _shard(h0, rank, world, 0))
        return dict(actor_params=_np(out.actor_params), critic_params=_np(out.critic_params),
                    vnorm=_np(out.vnorm), metrics={k: float(v) for k, v in metrics.items()},
                    num_updates=out.num_updates)
    batch, mask = args
    b = {k: _shard(v, rank, world, 0) for k, v in batch.items()}
    if b["action"].dtype == torch.int32:
        b["action"] = b["action"].long()
    out = meta["update"](runner.params, runner.target_params, runner.opt_state, b,
                         _shard(mask, rank, world, 0))
    return dict(params=_np(out[0]), metrics=[float(out[2]), float(out[3])])


def elastic_save(rank, world, port, kinds, jax_jobs, workdir):
    """Each ``kinds`` case: ``global_runner_init``, one block and a save by
    the ``world`` ranks → this rank's runner as saved (``to_state``). Each
    ``jax_jobs`` case: the single-process checkpoint restored at ``world``
    ranks and saved again by them, then one update from it on this rank's
    share → its result. Tensors come back as numpy arrays."""
    from cleanmarl_tpu_torch.core.checkpoint import to_state

    join(rank, world, port)
    out = {}
    for name, (family, kw) in kinds.items():
        train_block, _, runner, dims = fresh(family, kw, rank)
        runner, _ = train_block(runner)
        checkpointer(workdir, name, world, dims, kw).save(runner.step, runner)
        out[name] = _np(to_state(runner))
    for name, (family, kw, args) in jax_jobs.items():
        _, meta, template, dims = fresh(family, kw, rank)
        ckpt = checkpointer(workdir, name, 1, dims, kw)
        runner = ckpt.restore(template)
        checkpointer(workdir, name, world, dims, kw).save(ckpt.latest_step(), runner)
        out[name] = restored_update(family, rank, world, meta, runner, args)
    return out


def elastic_restore(rank, world, port, kinds, workdir):
    """Each ``kinds`` case's single-process checkpoint restored at ``world``
    ranks → this rank's runner (``to_state``, numpy arrays)."""
    from cleanmarl_tpu_torch.core.checkpoint import to_state

    join(rank, world, port)
    out = {}
    for name, (family, kw) in kinds.items():
        _, _, template, dims = fresh(family, kw, rank)
        out[name] = _np(to_state(checkpointer(workdir, name, 1, dims, kw).restore(template)))
    return out
