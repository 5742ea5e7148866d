"""VDN: Value Decomposition Networks, team Q = Σ per-agent Q (port of
``cleanmarl_tpu/algos/vdn.py``).

Act → step → store → learn → Polyak, with the env batch, the replay ring
(``buffers/transition.py``), the ε-greedy branch, the TD target
``r + γ(1−d)·Σᵢ max_a Qᵢ'`` and the MSE on ``Σᵢ Qᵢ`` all on the device.
The cadence counts vectorized iterations (+num_envs env transitions
each): one update of ``batch_size·num_envs`` transitions every
``train_freq`` iterations and a Polyak step every
``target_network_update_freq`` iterations, once ``learning_starts``
transitions are stored. Both conditions are host integers, so an
iteration never waits for the device.

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs (the global envs ``rank, rank + world, ...``) and holds its
rows of the transition ring (global row ``i`` on rank ``i % world``;
where the ranks divide ``num_envs`` and ``buffer_size`` every env's row
is its own rank's). An update takes this rank's ``batch_size · num_envs
/ world`` transitions of rank 0's sample, its loss the rank's sum over
the global count, and the gradients are summed over the ranks before the
clipping and Adam. With one rank nothing is reduced.

    python -m cleanmarl_tpu_torch.algos.vdn --env_type mpe \
        --env_name simple_spread_v3 --num_envs 32      # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from cleanmarl_tpu_torch.buffers.transition import TransitionBuffer
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.acting import eps_greedy, masked_argmax
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import tree_map, value_and_grad
from cleanmarl_tpu_torch.core.rewards import standardize
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.external import as_vec
from cleanmarl_tpu_torch.types import Transition


@dataclass
class VDNConfig:
    # field names and defaults of the JAX package's VDNConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    num_envs: int = 16
    buffer_size: int = 50000            # capacity in transitions
    total_timesteps: int = 1_000_000    # env transitions
    gamma: float = 0.99
    learning_starts: int = 5000         # env transitions before updates
    train_freq: int = 2                 # update every N vectorized iterations
    optimizer: str = "adam"
    learning_rate: float = 5e-4
    batch_size: int = 16                # per env; an update takes batch_size*num_envs
    start_e: float = 1.0
    end_e: float = 0.05
    exploration_fraction: float = 0.05
    hidden_dim: int = 64
    num_layers: int = 1
    target_network_update_freq: int = 1  # Polyak every N vectorized iterations
    polyak: float = 0.005
    normalize_reward: bool = False       # per-batch standardize
    bootstrap_truncation: bool = False   # True: time limits bootstrap through
    clip_gradients: float = 5.0
    log_interval: int = 500             # vectorized iterations per host log
    eval_steps: int = 5000              # env transitions between evals
    num_eval_ep: int = 10
    checkpoint_dir: str = ""            # saves the whole runner (core/checkpoint.py)
    checkpoint_every: int = 200_000
    resume: bool = False
    use_wnb: bool = False
    wnb_project: str = ""
    wnb_entity: str = ""
    profile_dir: str = ""               # torch.profiler trace of block 1
    use_mesh: bool = False              # one rank per visible card (distributed/)
    coordinator_address: str = ""       # host:port of a multi-process run
    num_processes: int = 1
    process_id: int = 0
    seed: int = 1
    verbose: bool = True
    device: str = "cuda"                # the port runs on the card unless asked


@dataclass
class VDNRunnerState:
    params: Any
    target_params: Any
    opt_state: Any
    buffer: TransitionBuffer
    env_state: Any
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    stats: EpisodeStats
    step: int                # vectorized iterations so far
    last_loss: torch.Tensor
    last_gnorm: torch.Tensor
    num_updates: int
    generator: torch.Generator

    def replace(self, **kw) -> "VDNRunnerState":
        return dataclasses.replace(self, **kw)


def make_train(cfg: VDNConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"]`` is one
    gradient step on an already sampled ``Transition`` batch."""
    device = resolve_device(cfg.device)
    if env is None:
        env = registry.make(cfg.env_type, cfg.env_name, agent_ids=cfg.agent_ids,
                            env_family=cfg.env_family, device=device)
    rank, world = dp.rank_world()
    N = dp.check_layout(cfg.num_envs, 1, world)     # this rank's envs
    vec = as_vec(env, N)
    opt = make_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    eff_batch = cfg.batch_size * cfg.num_envs
    dp.check_split(eff_batch, world, "batch_size * num_envs")
    eps_duration = cfg.exploration_fraction * cfg.total_timesteps
    n, A = env.n_agents, env.n_actions

    def init(generator: torch.Generator) -> VDNRunnerState:
        params = nets.mlp_init(generator, env.obs_dim, cfg.hidden_dim, A,
                               cfg.num_layers, device=device)
        env_state, ts = vec.reset(generator)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        example = Transition(
            obs=z(n, env.obs_dim), state=z(env.state_dim), avail=z(n, A, dtype=torch.bool),
            action=z(n, dtype=torch.int64), reward=z(), done=z(dtype=torch.bool),
            next_obs=z(n, env.obs_dim), next_state=z(env.state_dim),
            next_avail=z(n, A, dtype=torch.bool))
        zero = torch.zeros((), device=device)
        return VDNRunnerState(
            params=params, target_params=tree_map(torch.clone, params),
            opt_state=opt.init(params),
            buffer=TransitionBuffer.create(cfg.buffer_size, example, rank, world),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            stats=EpisodeStats.create(N, device), step=0,
            last_loss=zero, last_gnorm=zero.clone(), num_updates=0,
            generator=generator)

    def update(params, target_params, opt_state, batch: Transition):
        """One TD step on this rank's rows of a sampled batch → (params,
        opt_state, loss, grad norm)."""
        with torch.no_grad():
            reward = standardize(batch.reward) if cfg.normalize_reward else batch.reward
            q_next = nets.masked_q(nets.mlp_apply(target_params, batch.next_obs),
                                   batch.next_avail)
            team_next = q_next.max(dim=-1).values.sum(dim=-1)
            target = reward + cfg.gamma * (1.0 - batch.done.float()) * team_next

        def loss_fn(p):
            q = nets.mlp_apply(p, batch.obs)
            q_taken = torch.gather(q, -1, batch.action[..., None])[..., 0]
            return dp.mean_share(torch.square(target - q_taken.sum(dim=-1))), ()

        loss, _, grads = value_and_grad(loss_fn, params)
        grads, (loss,) = dp.all_reduce_sum([grads, [loss]])
        with torch.no_grad():
            gnorm = nets.global_norm(grads)
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, gnorm

    def train_iter(runner: VDNRunnerState):
        """One env step of the batch, its transitions, and the update and
        Polyak step it makes due. → (runner, epsilon)."""
        gen = runner.generator
        epsilon = linear_schedule(cfg.start_e, cfg.end_e, eps_duration,
                                  runner.step * cfg.num_envs)
        with torch.no_grad():
            q = nets.mlp_apply(runner.params, runner.obs)
            actions = eps_greedy(gen, q, runner.avail, epsilon)
            env_state, ts2, final = vec.step(runner.env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            runner.buffer.add_batch(Transition(
                obs=runner.obs, state=runner.state, avail=runner.avail.bool(),
                action=actions, reward=ts2.reward,
                done=ts2.done if cfg.bootstrap_truncation else ended,
                next_obs=final.obs, next_state=final.state,
                next_avail=final.avail.bool()))
            stats = runner.stats.step(
                ts2.reward, ended, ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))

        step = runner.step + 1
        can_learn = step * cfg.num_envs > cfg.learning_starts
        params, opt_state = runner.params, runner.opt_state
        loss, gnorm, num_updates = runner.last_loss, runner.last_gnorm, runner.num_updates
        if can_learn and step % cfg.train_freq == 0:
            params, opt_state, loss, gnorm = update(
                params, runner.target_params, opt_state,
                runner.buffer.sample(gen, eff_batch))
            num_updates += 1
        target_params = runner.target_params
        if can_learn and step % cfg.target_network_update_freq == 0:
            with torch.no_grad():
                target_params = nets.soft_update(target_params, params, cfg.polyak)
        runner = runner.replace(
            params=params, target_params=target_params, opt_state=opt_state,
            env_state=env_state, obs=ts2.obs, state=ts2.state, avail=ts2.avail,
            stats=stats, step=step, last_loss=loss, last_gnorm=gnorm,
            num_updates=num_updates)
        return runner, epsilon

    def scalar(x):
        return torch.tensor(float(x), device=device)

    def train_block(runner: VDNRunnerState):
        """``log_interval`` iterations; the metrics stay on the device."""
        for _ in range(cfg.log_interval):
            runner, epsilon = train_iter(runner)
        metrics = {
            **runner.stats.rollout_metrics(),
            "rollout/epsilon": scalar(epsilon),
            "train/loss": runner.last_loss,
            "train/grads": runner.last_gnorm,
            "train/num_updates": scalar(runner.num_updates),
        }
        return runner.replace(stats=runner.stats.flush()), metrics

    def greedy_policy(params, carry, obs, avail, generator):
        return carry, masked_argmax(nets.mlp_apply(params, obs), avail)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, greedy_policy)
    meta = {"update": update, "train_iter": train_iter,
            "steps_per_block": cfg.num_envs * cfg.log_interval, "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: VDNConfig, env=None, logger=None):
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
        "VDN", cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.params,
        steps_of=lambda r: r.step * cfg.num_envs,
        print_keys=("rollout/ep_reward", "train/loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["VDN"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    train(cli(VDNConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
