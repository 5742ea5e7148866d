"""FACMAC: factored multi-agent centralized policy gradients, a
MADDPG-style actor with QMIX-style monotonic mixing of per-agent utilities
(port of ``cleanmarl_tpu/algos/facmac.py``).

- Per-agent utility Q(obs_i ‖ a_i one-hot) → scalar, mixed to a team
  Q_tot by the QMIX hypernetwork on the global state
  (``networks.mixer_apply``).
- Critic loss: masked MSE of Mixer(Q(o, a), s) against
  r + γ(1−ended)·Mixer'(Q'(o', â'), s') with â' hard Gumbel samples from
  the target actor; one optimizer over utility and mixer; the bootstrap
  dies at every episode end.
- Actor loss: −Q_tot with fresh soft actions for every agent at once
  (the centralized gradient through the mixer).
- Exploration: the ε-mixture of the Gumbel-softmax policy and the
  avail-uniform distribution, ε scheduled over training updates.

Feed-forward only, as in the JAX package: no kernel on this path. The
update takes its Gumbel noise as an argument (``maddpg.py``).

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs and holds its rows of the episode ring, and an update takes
this rank's ``batch_size / world`` episodes of rank 0's sample and noise,
as MADDPG's does: global mask sum and reward statistics, each loss the
rank's sum over the global count, the critic's and then the actor's
gradients summed over the ranks before Adam.

    python -m cleanmarl_tpu_torch.algos.facmac --env_type mpe \
        --env_name simple_speaker_listener_v4 --num_envs 32    # on the card
    ... --device cpu                                           # on the CPU
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch

from cleanmarl_tpu_torch.algos.maddpg import (
    draw_noise, example_record, gumbel_noise, gumbel_softmax, run_due_updates,
)
from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
from cleanmarl_tpu_torch.core import cadence
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.acting import masked_argmax
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import tree_map, value_and_grad
from cleanmarl_tpu_torch.core.rewards import masked_count
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.base import categorical
from cleanmarl_tpu_torch.envs.external import as_vec


@dataclass
class FACMACConfig:
    # field names and defaults of the JAX package's FACMACConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    num_envs: int = 16
    buffer_size: int = 5000
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    train_freq: int = 1
    optimizer: str = "adam"
    learning_rate_actor: float = 3e-4
    learning_rate_critic: float = 3e-4
    batch_size: int = 10
    actor_hidden_dim: int = 32
    actor_num_layers: int = 1
    critic_hidden_dim: int = 128
    critic_num_layers: int = 1
    hyper_dim: int = 64
    embed_dim: int = 32
    gumbel_tau: float = 1.0
    normalize_reward: bool = False   # masked per-batch standardize
    start_e: float = 0.5
    end_e: float = 0.002
    exploration_fraction: float = 750.0   # in training updates
    max_updates_per_iter: int = 0    # 0 = uncapped; the surplus carries as debt
    target_network_update_freq: int = 1
    polyak: float = 0.005
    clip_gradients: float = -1.0
    log_interval: int = 500
    eval_steps: int = 5000
    num_eval_ep: int = 10
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


def eps_mixture_probs(logits, avail, epsilon: float, noise, tau: float = 1.0):
    """(1−ε)·gumbel_softmax(logits, noise) + ε·uniform(avail)."""
    soft = gumbel_softmax(logits, noise, tau, hard=False)
    availf = avail.float()
    uni = availf / torch.clamp(availf.sum(-1, keepdim=True), min=1.0)
    return (1.0 - epsilon) * soft + epsilon * uni


def eps_mixture_sample(generator, logits, avail, epsilon: float, tau: float = 1.0):
    """One action per agent from the ε-mixture, categorical on
    log(probs + 1e-10), both draws from ``generator``."""
    probs = eps_mixture_probs(logits, avail, epsilon, gumbel_noise(generator, logits.shape),
                              tau)
    return categorical(torch.log(probs + 1e-10), generator)


@dataclass
class FACMACRunnerState:
    actor_params: Any
    critic_params: Any           # {"q": per-agent utility, "mixer": hypernet}
    target_actor: Any
    target_critic: Any
    actor_opt: Any
    critic_opt: Any
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
    last_actor_loss: torch.Tensor
    last_critic_loss: torch.Tensor
    last_actor_gnorm: torch.Tensor
    last_critic_gnorm: torch.Tensor
    num_updates: int
    generator: torch.Generator

    def replace(self, **kw) -> "FACMACRunnerState":
        return dataclasses.replace(self, **kw)


def make_train(cfg: FACMACConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"](runner,
    batch, mask, noise)`` is one critic and one actor step on a sampled
    batch with the Gumbel noise ``(g_target, g_fresh)``."""
    device = resolve_device(cfg.device)
    if env is None:
        env = registry.make(cfg.env_type, cfg.env_name, agent_ids=cfg.agent_ids,
                            env_family=cfg.env_family, device=device)
    rank, world = dp.rank_world()
    N = dp.check_layout(cfg.num_envs, 1, world)     # this rank's envs
    dp.check_split(cfg.batch_size, world, "batch_size")
    vec = as_vec(env, N)
    actor_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_actor, cfg.clip_gradients)
    critic_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_critic, cfg.clip_gradients)
    n_slots = cadence.num_slots(cfg.max_updates_per_iter, cfg.num_envs)
    n, A = env.n_agents, env.n_actions

    def actor_logits(params, obs, avail):
        return nets.masked_q(nets.mlp_apply(params, obs), avail)

    def utilities(qparams, obs, onehot):
        """Per-agent Q(obs_i ‖ a_i) → (..., n_agents)."""
        return nets.mlp_apply(qparams, torch.cat([obs, onehot], dim=-1))[..., 0]

    def q_tot(cparams, obs, onehot, state):
        return nets.mixer_apply(cparams["mixer"], utilities(cparams["q"], obs, onehot), state)

    def init(generator: torch.Generator) -> FACMACRunnerState:
        actor_params = nets.mlp_init(generator, env.obs_dim, cfg.actor_hidden_dim, A,
                                     cfg.actor_num_layers, final_gain=0.01, device=device)
        critic_params = {
            "q": nets.mlp_init(generator, env.obs_dim + A, cfg.critic_hidden_dim, 1,
                               cfg.critic_num_layers, device=device),
            "mixer": nets.mixer_init(generator, n, env.state_dim, cfg.embed_dim,
                                     cfg.hyper_dim, device=device),
        }
        env_state, ts = vec.reset(generator)
        zero = torch.zeros((), device=device)
        rec = example_record(env, device)
        return FACMACRunnerState(
            actor_params=actor_params, critic_params=critic_params,
            target_actor=tree_map(torch.clone, actor_params),
            target_critic=tree_map(torch.clone, critic_params),
            actor_opt=actor_opt.init(actor_params), critic_opt=critic_opt.init(critic_params),
            ring=EpisodeBuffer.create(cfg.buffer_size, env.episode_limit, rec, rank, world),
            acc=EpisodeAccumulator.create(N, env.episode_limit, rec),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            stats=EpisodeStats.create(N, device), step=0, episodes=0,
            update_debt=0, last_actor_loss=zero, last_critic_loss=zero.clone(),
            last_actor_gnorm=zero.clone(), last_critic_gnorm=zero.clone(), num_updates=0,
            generator=generator)

    def update(runner, batch, mask, noise):
        """One critic (utility + mixer) and one actor step → (actor_params,
        critic_params, actor_opt, critic_opt, actor loss, critic loss,
        actor grad norm, critic grad norm)."""
        g_target, g_fresh = noise
        with torch.no_grad():
            next_logits = actor_logits(runner.target_actor, batch["next_obs"],
                                       batch["next_avail"])
            a_next = gumbel_softmax(next_logits, g_target, cfg.gumbel_tau, hard=True)
            qtot_next = q_tot(runner.target_critic, batch["next_obs"], a_next,
                              batch["next_state"])
            reward, msum = masked_count(batch["reward"], mask, cfg.normalize_reward)
            target = reward + cfg.gamma * (1.0 - batch["ended"].float()) * qtot_next

        def critic_loss_fn(p):
            qt = q_tot(p, batch["obs"], batch["action"], batch["state"])
            return torch.sum(torch.square(target - qt) * mask) / msum, ()

        c_loss, _, c_grads = value_and_grad(critic_loss_fn, runner.critic_params)
        c_grads, (c_loss,) = dp.all_reduce_sum([c_grads, [c_loss]])
        with torch.no_grad():
            c_gnorm = nets.global_norm(c_grads)
            critic_params, c_opt = critic_opt.update(c_grads, runner.critic_opt,
                                                     runner.critic_params)

        def actor_loss_fn(p):
            logits = actor_logits(p, batch["obs"], batch["avail"])
            fresh = gumbel_softmax(logits, g_fresh, cfg.gumbel_tau, hard=False)
            qt = q_tot(critic_params, batch["obs"], fresh, batch["state"])
            return -torch.sum(qt * mask) / msum, ()

        a_loss, _, a_grads = value_and_grad(actor_loss_fn, runner.actor_params)
        a_grads, (a_loss,) = dp.all_reduce_sum([a_grads, [a_loss]])
        with torch.no_grad():
            a_gnorm = nets.global_norm(a_grads)
            actor_params, a_opt = actor_opt.update(a_grads, runner.actor_opt,
                                                   runner.actor_params)
        return actor_params, critic_params, a_opt, c_opt, a_loss, c_loss, a_gnorm, c_gnorm

    def train_iter(runner: FACMACRunnerState):
        """One env step of the batch, its record, and the updates and
        target step it makes due. → (runner, epsilon)."""
        gen = runner.generator
        epsilon = linear_schedule(cfg.start_e, cfg.end_e, cfg.exploration_fraction,
                                  runner.num_updates)
        with torch.no_grad():
            logits = actor_logits(runner.actor_params, runner.obs, runner.avail)
            actions = eps_mixture_sample(gen, logits, runner.avail, epsilon, cfg.gumbel_tau)
            onehot = torch.nn.functional.one_hot(actions, A).float()
            env_state, ts2, final = vec.step(runner.env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            record = {"obs": runner.obs, "state": runner.state, "avail": runner.avail.bool(),
                      "action": onehot, "reward": ts2.reward, "ended": ended,
                      "next_obs": final.obs, "next_state": final.state,
                      "next_avail": final.avail.bool()}
            n_new = runner.acc.add_step(runner.ring, record, ended)   # host sync
            stats = runner.stats.step(
                ts2.reward, ended, ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))

        runner = runner.replace(env_state=env_state, obs=ts2.obs, state=ts2.state,
                                avail=ts2.avail, stats=stats, step=runner.step + 1)
        return run_due_updates(cfg, runner, n_new, n_slots, update), epsilon

    def scalar(x):
        return torch.tensor(float(x), device=device)

    def train_block(runner: FACMACRunnerState):
        """``log_interval`` iterations; the metrics stay on the device."""
        for _ in range(cfg.log_interval):
            runner, epsilon = train_iter(runner)
        metrics = {
            **runner.stats.rollout_metrics(),
            "rollout/epsilon": scalar(epsilon),
            "train/actor_loss": runner.last_actor_loss,
            "train/critic_loss": runner.last_critic_loss,
            "train/actor_gradients": runner.last_actor_gnorm,
            "train/critic_gradients": runner.last_critic_gnorm,
            "train/num_updates": scalar(runner.num_updates),
            # nonzero: max_updates_per_iter deferred due updates
            "train/update_debt": scalar(runner.update_debt),
        }
        return runner.replace(stats=runner.stats.flush()), metrics

    def greedy_policy(params, carry, obs, avail, generator):
        return carry, masked_argmax(nets.mlp_apply(params, obs), avail)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, greedy_policy)
    meta = {"update": update, "train_iter": train_iter, "draw_noise": draw_noise,
            "steps_per_block": cfg.num_envs * cfg.log_interval, "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: FACMACConfig, env=None, logger=None):
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
        "FACMAC", cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.actor_params,
        steps_of=lambda r: r.step * cfg.num_envs,
        print_keys=("rollout/ep_reward", "train/critic_loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["FACMAC"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    return train(cli(FACMACConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
