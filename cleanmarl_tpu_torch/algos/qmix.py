"""QMIX: monotonic value factorisation with a state-conditioned
hypernetwork mixer (port of ``cleanmarl_tpu/algos/qmix.py``).

    target = r_t + γ(1−d_t)·Mixer'(max_a Q'(o_{t+1}), s_{t+1})
    loss   = Σ_{b,t} m_{b,t}·(target − Mixer(Q(o_t)[a_t], s_t))² / Σ m

Episodes are assembled on the device from the auto-reset env batch
(``buffers/episode.py:EpisodeAccumulator``) into a ring of padded
episodes; an update is the dense masked TD loss over a (B, T_max) block
of sampled episodes, with one optimizer over the Q-net and the mixer.
Updates and target steps follow the clock of completed episodes
(``core/cadence.py``).

The JAX package runs ``log_interval`` iterations as one compiled scan.
Here an iteration is eager PyTorch on the device with one host sync: the
count of episodes that ended, read once by ``add_step``, from which the
host runs exactly the updates that are due.

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs (the global envs ``rank, rank + world, ...``) and holds its
rows of the episode ring (global row ``i`` on rank ``i % world``); every
rank counts the episodes that ended on every rank, so the update clock is
global. An update takes this rank's ``batch_size / world`` episodes of
rank 0's sample; the mask sum (and ``normalize_reward``'s statistics) are
every rank's, each loss is the rank's sum over the global count, and the
gradients are summed over the ranks before Adam. With one rank nothing
is reduced.

    python -m cleanmarl_tpu_torch.algos.qmix --env_type mpe \
        --env_name simple_spread_v3 --num_envs 32      # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
from cleanmarl_tpu_torch.core import cadence
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.acting import eps_greedy, masked_argmax
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import tree_map, value_and_grad
from cleanmarl_tpu_torch.core.rewards import masked_count
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.external import as_vec


@dataclass
class QMIXConfig:
    # field names and defaults of the JAX package's QMIXConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    num_envs: int = 16
    buffer_size: int = 5000          # capacity in episodes
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    train_freq: int = 1              # update every N completed episodes
    optimizer: str = "adam"
    learning_rate: float = 5e-4
    batch_size: int = 10             # episodes per update
    start_e: float = 1.0
    end_e: float = 0.025
    exploration_fraction: float = 0.05
    hidden_dim: int = 64
    hyper_dim: int = 64
    embed_dim: int = 32
    num_layers: int = 1
    target_network_update_freq: int = 1  # target step every N completed episodes
    polyak: float = 0.01
    normalize_reward: bool = False   # masked per-batch standardize
    hard_target: bool = False        # full target copy instead of Polyak
    double_q: bool = True            # argmax by the online net, value by the target
    bootstrap_truncation: bool = False  # True: time limits bootstrap through
    memefficient: bool = False       # store each step once; next_* from t+1
    max_updates_per_iter: int = 0    # 0 = uncapped; the surplus carries as debt
    clip_gradients: float = -1.0
    log_interval: int = 500
    eval_steps: int = 5000
    num_eval_ep: int = 5
    checkpoint_dir: str = ""         # saves the whole runner (core/checkpoint.py)
    checkpoint_every: int = 200_000
    resume: bool = False
    use_wnb: bool = False
    wnb_project: str = ""
    wnb_entity: str = ""
    profile_dir: str = ""            # torch.profiler trace of block 1
    use_mesh: bool = False           # one rank per visible card (distributed/)
    coordinator_address: str = ""    # host:port of a multi-process run
    num_processes: int = 1
    process_id: int = 0
    seed: int = 1
    verbose: bool = True
    device: str = "cuda"             # the port runs on the card unless asked


@dataclass
class QMIXRunnerState:
    params: Any                  # {"q": mlp, "mixer": {hw1, hb1, hw2, hb2}}
    target_params: Any
    opt_state: Any
    ring: EpisodeBuffer
    acc: EpisodeAccumulator
    env_state: Any
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    stats: EpisodeStats
    step: int                    # vectorized iterations (host counters below)
    episodes: int                # completed episodes: the cadence clock
    update_debt: int             # due updates deferred by max_updates_per_iter
    last_loss: torch.Tensor
    last_gnorm: torch.Tensor
    num_updates: int
    generator: torch.Generator

    def replace(self, **kw) -> "QMIXRunnerState":
        return dataclasses.replace(self, **kw)


def make_train(cfg: QMIXConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"]`` is one
    gradient step on an already sampled batch."""
    device = resolve_device(cfg.device)
    if env is None:
        env = registry.make(cfg.env_type, cfg.env_name, agent_ids=cfg.agent_ids,
                            env_family=cfg.env_family, device=device)
    rank, world = dp.rank_world()
    N = dp.check_layout(cfg.num_envs, 1, world)     # this rank's envs
    dp.check_split(cfg.batch_size, world, "batch_size")
    vec = as_vec(env, N)
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    eps_duration = cfg.exploration_fraction * cfg.total_timesteps
    n_slots = cadence.num_slots(cfg.max_updates_per_iter, cfg.num_envs)
    n, A = env.n_agents, env.n_actions

    def example_record():
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        rec = {"obs": z(n, env.obs_dim), "state": z(env.state_dim),
               "action": z(n, dtype=torch.int64), "reward": z(),
               "done": z(dtype=torch.bool)}
        if cfg.memefficient:
            # store once: next_* is the t+1 slice at sample time, and the
            # last step of every episode trains on its reward alone
            rec["avail"] = z(n, A, dtype=torch.bool)
        else:
            rec.update(next_obs=z(n, env.obs_dim), next_state=z(env.state_dim),
                       next_avail=z(n, A, dtype=torch.bool))
        return rec

    def init(generator: torch.Generator) -> QMIXRunnerState:
        params = {
            "q": nets.mlp_init(generator, env.obs_dim, cfg.hidden_dim, A,
                               cfg.num_layers, device=device),
            "mixer": nets.mixer_init(generator, n, env.state_dim, cfg.embed_dim,
                                     cfg.hyper_dim, device=device),
        }
        env_state, ts = vec.reset(generator)
        zero = torch.zeros((), device=device)
        return QMIXRunnerState(
            params=params, target_params=tree_map(torch.clone, params),
            opt_state=opt.init(params),
            ring=EpisodeBuffer.create(cfg.buffer_size, env.episode_limit,
                                      example_record(), rank, world),
            acc=EpisodeAccumulator.create(N, env.episode_limit, example_record()),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            stats=EpisodeStats.create(N, device), step=0, episodes=0,
            update_debt=0, last_loss=zero, last_gnorm=zero.clone(), num_updates=0,
            generator=generator)

    def update(params, target_params, opt_state, batch, mask):
        """One TD step on ``batch`` (B, T_max, ...) with step ``mask`` (B,
        T_max), this rank's rows of the sampled batch → (params, opt_state,
        loss, grad norm)."""
        with torch.no_grad():
            reward, count = masked_count(batch["reward"], mask, cfg.normalize_reward)
            if cfg.memefficient:
                # the wrapped last row is cut by has_next
                next_obs = torch.roll(batch["obs"], -1, dims=1)
                next_state = torch.roll(batch["state"], -1, dims=1)
                next_avail = torch.roll(batch["avail"], -1, dims=1)
                has_next = torch.roll(mask, -1, dims=1)
                has_next[:, -1] = 0.0
            else:
                next_obs, next_state = batch["next_obs"], batch["next_state"]
                next_avail = batch["next_avail"]
                has_next = torch.ones_like(mask)
            q_next_t = nets.masked_q(nets.mlp_apply(target_params["q"], next_obs),
                                     next_avail)
            if cfg.double_q:
                q_next_o = nets.masked_q(nets.mlp_apply(params["q"], next_obs),
                                         next_avail)
                a_star = torch.argmax(q_next_o, dim=-1)
                q_next_max = torch.gather(q_next_t, -1, a_star[..., None])[..., 0]
            else:
                q_next_max = q_next_t.max(dim=-1).values
            qtot_next = nets.mixer_apply(target_params["mixer"], q_next_max, next_state)
            done = batch["done"].float()
            target = reward + cfg.gamma * (1.0 - done) * has_next * qtot_next

        def loss_fn(p):
            q = nets.mlp_apply(p["q"], batch["obs"])
            q_taken = torch.gather(q, -1, batch["action"][..., None])[..., 0]
            qtot = nets.mixer_apply(p["mixer"], q_taken, batch["state"])
            err = torch.square(target - qtot) * mask
            return torch.sum(err) / count, ()

        loss, _, grads = value_and_grad(loss_fn, params)
        grads, (loss,) = dp.all_reduce_sum([grads, [loss]])
        with torch.no_grad():
            gnorm = nets.global_norm(grads)
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, gnorm

    def train_iter(runner: QMIXRunnerState):
        """One env step of the batch, its record, and the updates and
        target step it makes due. → (runner, epsilon)."""
        gen = runner.generator
        epsilon = linear_schedule(cfg.start_e, cfg.end_e, eps_duration,
                                  runner.step * cfg.num_envs)
        with torch.no_grad():
            q = nets.mlp_apply(runner.params["q"], runner.obs)
            actions = eps_greedy(gen, q, runner.avail, epsilon)
            env_state, ts2, final = vec.step(runner.env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            record = {"obs": runner.obs, "state": runner.state, "action": actions,
                      "reward": ts2.reward,
                      "done": ts2.done if cfg.bootstrap_truncation else ended}
            if cfg.memefficient:
                record["avail"] = runner.avail.bool()
            else:
                record.update(next_obs=final.obs, next_state=final.state,
                              next_avail=final.avail.bool())
            n_new = runner.acc.add_step(runner.ring, record, ended)   # host sync
            stats = runner.stats.step(
                ts2.reward, ended, ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))

        # one update per train_freq completed episodes: a synchronized
        # batch finishes many at once (MPE: all envs truncate together),
        # so each crossing gets its own update, up to n_slots per iteration
        episodes = runner.episodes + n_new
        due = 0
        if runner.ring.size >= cfg.batch_size:
            due = episodes // cfg.train_freq - runner.episodes // cfg.train_freq
        n_run, debt = cadence.bounded_due(runner.update_debt, due, n_slots)
        params, opt_state = runner.params, runner.opt_state
        loss, gnorm = runner.last_loss, runner.last_gnorm
        for _ in range(n_run):
            batch, mask = runner.ring.sample(gen, cfg.batch_size)
            params, opt_state, loss, gnorm = update(params, runner.target_params,
                                                    opt_state, batch, mask)
        # k Polyak steps in a row are one step with τ = 1 − (1 − τ)^k
        # (float32, as the JAX package computes it)
        due_t = cadence.target_due(runner.num_updates, n_run, cfg.train_freq,
                                   cfg.target_network_update_freq)
        target_params = runner.target_params
        if due_t > 0:
            tau = 1.0 if cfg.hard_target else float(
                np.float32(1.0) - np.float32(1.0 - cfg.polyak) ** np.float32(due_t))
            with torch.no_grad():
                target_params = nets.soft_update(target_params, params, tau)
        runner = runner.replace(
            params=params, target_params=target_params, opt_state=opt_state,
            env_state=env_state, obs=ts2.obs, state=ts2.state, avail=ts2.avail,
            stats=stats, step=runner.step + 1, episodes=episodes, update_debt=debt,
            last_loss=loss, last_gnorm=gnorm, num_updates=runner.num_updates + n_run)
        return runner, epsilon

    def scalar(x):
        return torch.tensor(float(x), device=device)

    def train_block(runner: QMIXRunnerState):
        """``log_interval`` iterations; the metrics stay on the device."""
        for _ in range(cfg.log_interval):
            runner, epsilon = train_iter(runner)
        metrics = {
            **runner.stats.rollout_metrics(),
            "rollout/epsilon": scalar(epsilon),
            "train/loss": runner.last_loss,
            "train/grads": runner.last_gnorm,
            "train/num_updates": scalar(runner.num_updates),
            # nonzero: max_updates_per_iter deferred due updates
            "train/update_debt": scalar(runner.update_debt),
        }
        return runner.replace(stats=runner.stats.flush()), metrics

    def greedy_policy(params, carry, obs, avail, generator):
        return carry, masked_argmax(nets.mlp_apply(params["q"], obs), avail)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, greedy_policy)
    meta = {"update": update, "train_iter": train_iter,
            "steps_per_block": cfg.num_envs * cfg.log_interval, "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: QMIXConfig, env=None, logger=None):
    """``--use_mesh`` on more than one card trains on one spawned rank per
    card and returns (None, rank 0's last eval metrics)
    (``multihost.spawn_if_mesh``)."""
    from cleanmarl_tpu_torch.core.driver import run_training
    from cleanmarl_tpu_torch.distributed import multihost

    spawned = multihost.spawn_if_mesh(train, cfg, env, logger)
    if spawned is not None:
        return spawned
    init, train_block, eval_fn, meta = make_train(cfg, env)
    return run_training(
        "QMIX", cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.params,
        steps_of=lambda r: r.step * cfg.num_envs,
        print_keys=("rollout/ep_reward", "train/loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["QMIX"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    train(cli(QMIXConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
