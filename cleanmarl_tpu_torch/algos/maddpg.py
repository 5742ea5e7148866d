"""MADDPG: multi-agent DDPG with discrete straight-through Gumbel-softmax
actions (port of ``cleanmarl_tpu/algos/maddpg.py``).

- Behaviour actions are hard Gumbel-softmax samples of the avail-masked
  policy logits, stored one-hot in an episode ring
  (``buffers/episode.py``).
- The centralized critic is Q(state ‖ joint one-hot actions) → scalar.
- Critic target: r + γ(1−ended)·Q'(s', â') with â' hard-sampled from the
  target actor at the next obs; the bootstrap dies at every episode end.
- Actor loss: −E[Q(s, [â_i, a_−i])] with agent i's action re-sampled
  *soft* from the current policy and the others taken from the buffer:
  the n substituted joints are built at once by broadcasting an eye mask
  and go through one critic call.
- One update per ``train_freq`` completed episodes (``core/cadence.py``),
  Polyak on actor and critic on the serviced-update clock.

With ``recurrent=True`` the actor is fc1 → GRU → head; the update
recomputes it over whole episodes from a zero carry on the route
``networks.resolve_gru_impl`` picks (on the card, the CUDA GRU kernels:
the target stream is one K2 forward, the actor loss one K2 forward and
K3 with dw in its backward).

The update takes its Gumbel noise as an argument: ``train_iter`` draws it
from the runner's generator and ``meta["update"](runner, batch, mask,
noise)`` only computes. An iteration is eager PyTorch on the device with
one host sync, the count of episodes that ended (``add_step``).

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs (the global envs ``rank, rank + world, ...``) and holds its
rows of the episode ring (global row ``i`` on rank ``i % world``); the
update clock counts every rank's episodes. An update takes this rank's
``batch_size / world`` episodes of rank 0's sample and its rows of the
noise rank 0 draws at the full batch shape (on the card, the recurrent
actor's K2, K3 and dw at the rank's rows); the mask sum and the reward
statistics are every rank's, each loss is the rank's sum over the global
count, and the critic's and then the actor's gradients are summed over
the ranks before Adam. With one rank nothing is reduced.

    python -m cleanmarl_tpu_torch.algos.maddpg --env_type mpe \
        --env_name simple_speaker_listener_v4 --num_envs 32    # on the card
    ... --device cpu                                           # on the CPU
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

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
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.external import as_vec


@dataclass
class MADDPGConfig:
    # field names and defaults of the JAX package's MADDPGConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    num_envs: int = 16
    buffer_size: int = 5000          # episodes
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    train_freq: int = 1              # update every N completed episodes
    optimizer: str = "adam"
    learning_rate_actor: float = 3e-4
    learning_rate_critic: float = 3e-4
    batch_size: int = 10             # episodes per update
    recurrent: bool = False          # GRU actor
    actor_hidden_dim: int = 32
    actor_num_layers: int = 1
    critic_hidden_dim: int = 128
    critic_num_layers: int = 1
    gumbel_tau: float = 1.0
    normalize_reward: bool = True    # masked per-batch standardize
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


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u), u uniform on [tiny, 1), drawn
    from ``generator`` on its device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor, tau: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """softmax((logits + noise) / τ); ``hard`` returns the one-hot of its
    argmax with the soft sample's gradient (straight-through:
    one_hot − y.detach() + y, as the JAX package writes it)."""
    y = torch.softmax((logits + noise) / tau, dim=-1)
    if hard:
        one_hot = torch.nn.functional.one_hot(torch.argmax(y, dim=-1),
                                              logits.shape[-1]).to(y.dtype)
        y = (one_hot - y).detach() + y
    return y


@dataclass
class MADDPGRunnerState:
    actor_params: Any
    critic_params: Any
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
    actor_h: torch.Tensor        # (num_envs, n_agents, H); zeros when FF
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

    def replace(self, **kw) -> "MADDPGRunnerState":
        return dataclasses.replace(self, **kw)


def example_record(env, device):
    """One step's replay record: actions one-hot, next_* from the
    pre-reset (final) time step."""
    n, A = env.n_agents, env.n_actions

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"obs": z(n, env.obs_dim), "state": z(env.state_dim),
            "avail": z(n, A, dtype=torch.bool), "action": z(n, A), "reward": z(),
            "ended": z(dtype=torch.bool), "next_obs": z(n, env.obs_dim),
            "next_state": z(env.state_dim), "next_avail": z(n, A, dtype=torch.bool)}


def draw_noise(generator: torch.Generator, shape):
    """(g_target, g_fresh): an update's Gumbel noise, of ``shape``: the
    sampled batch's one-hot actions (B, T, n_agents, n_actions)."""
    return gumbel_noise(generator, shape), gumbel_noise(generator, shape)


def run_due_updates(cfg, runner, n_new: int, n_slots: int, update):
    """The cadence of MADDPG and FACMAC after ``n_new`` episodes ended: one
    update per ``train_freq`` completed episodes once the ring holds a
    batch (a synchronized env batch finishes many at once, so each
    crossing gets its own update, up to ``n_slots`` an iteration and the
    rest as debt), each on a fresh batch and fresh noise from the runner's
    generator (rank 0's in a process group, split over the ranks); then both targets' Polyak step, k steps in a row taken as
    one with τ = 1 − (1 − τ)^k (float32, as the JAX package computes it)
    on the serviced-update clock. → runner with the new params, targets,
    Adam states, last losses and counters."""
    gen = runner.generator
    episodes = runner.episodes + n_new
    due = 0
    if runner.ring.size >= cfg.batch_size:
        due = episodes // cfg.train_freq - runner.episodes // cfg.train_freq
    n_run, debt = cadence.bounded_due(runner.update_debt, due, n_slots)
    r = runner
    for _ in range(n_run):
        batch, mask = runner.ring.sample(gen, cfg.batch_size)
        shape = (cfg.batch_size,) + tuple(batch["action"].shape[1:])
        noise = dp.rank0_draw(lambda: draw_noise(gen, shape), 2, shape, mask.device)
        a_p, c_p, a_o, c_o, a_l, c_l, a_g, c_g = update(r, batch, mask, noise)
        r = r.replace(actor_params=a_p, critic_params=c_p, actor_opt=a_o, critic_opt=c_o,
                      last_actor_loss=a_l, last_critic_loss=c_l, last_actor_gnorm=a_g,
                      last_critic_gnorm=c_g)
    due_t = cadence.target_due(runner.num_updates, n_run, cfg.train_freq,
                               cfg.target_network_update_freq)
    if due_t > 0:
        tau = float(np.float32(1.0) - np.float32(1.0 - cfg.polyak) ** np.float32(due_t))
        with torch.no_grad():
            r = r.replace(target_actor=nets.soft_update(r.target_actor, r.actor_params, tau),
                          target_critic=nets.soft_update(r.target_critic, r.critic_params, tau))
    return r.replace(episodes=episodes, update_debt=debt, num_updates=runner.num_updates + n_run)


def make_train(cfg: MADDPGConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"](runner,
    batch, mask, noise)`` is one critic and one actor step on a sampled
    batch with the Gumbel noise ``(g_target, g_fresh)`` (``draw_noise``).
    The recurrent actor's sequence route is ``resolve_gru_impl("auto")``'s
    (``meta["gru_impl"]``: the kernels on the card, the scan on the CPU;
    the JAX config has no such field)."""
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
    n, A, H = env.n_agents, env.n_actions, cfg.actor_hidden_dim
    joint_dim = n * A
    critic_in = env.state_dim + joint_dim
    gru_impl = nets.resolve_gru_impl("auto", H, device=device) if cfg.recurrent else None

    def actor_step(params, h, obs, avail):
        """→ (h', masked logits). h passes through for the FF actor."""
        if cfg.recurrent:
            h2, logits = nets.rnn_apply(params, h, obs)
            return h2, nets.masked_q(logits, avail)
        return h, nets.masked_q(nets.mlp_apply(params, obs), avail)

    def time_major(x):
        return x.movedim(0, 1).contiguous()

    def actor_logits_episodes(params, obs_tm, avail):
        """Logits over episodes (B, T, n, ·). The GRU carry starts at zeros
        (episodes start at t=0) with no resets; ``obs_tm`` is the
        time-major obs of the recurrent actor, else the batch's obs."""
        if not cfg.recurrent:
            return nets.masked_q(nets.mlp_apply(params, obs_tm), avail)
        h0 = torch.zeros(obs_tm.shape[1:-1] + (H,), device=obs_tm.device)
        _, logits = nets.rnn_seq_apply(params, h0, obs_tm, impl=gru_impl)
        return nets.masked_q(logits.movedim(0, 1), avail)

    def target_next_logits_episodes(params, obs_tm, next_obs_tm, next_avail):
        """Target-actor logits at the next obs of every step: the hidden
        stream advances on obs_t and is read one GRU step ahead on
        next_obs_t."""
        if not cfg.recurrent:
            return nets.masked_q(nets.mlp_apply(params, next_obs_tm), next_avail)
        h0 = torch.zeros(obs_tm.shape[1:-1] + (H,), device=obs_tm.device)
        logits = nets.rnn_seq_eval_next(params, h0, obs_tm, next_obs_tm, impl=gru_impl)
        return nets.masked_q(logits.movedim(0, 1), next_avail)

    def critic_q(params, state, joint_onehot):
        """state (..., S), joint_onehot (..., n, A) → Q (...)."""
        flat = joint_onehot.reshape(joint_onehot.shape[:-2] + (joint_dim,))
        return nets.mlp_apply(params, torch.cat([state, flat], dim=-1))[..., 0]

    def init(generator: torch.Generator) -> MADDPGRunnerState:
        if cfg.recurrent:
            actor_params = nets.rnn_init(generator, env.obs_dim, H, A, final_gain=0.01,
                                         device=device)
        else:
            actor_params = nets.mlp_init(generator, env.obs_dim, H, A, cfg.actor_num_layers,
                                         final_gain=0.01, device=device)
        critic_params = nets.mlp_init(generator, critic_in, cfg.critic_hidden_dim, 1,
                                      cfg.critic_num_layers, device=device)
        env_state, ts = vec.reset(generator)
        zero = torch.zeros((), device=device)
        rec = example_record(env, device)
        return MADDPGRunnerState(
            actor_params=actor_params, critic_params=critic_params,
            target_actor=tree_map(torch.clone, actor_params),
            target_critic=tree_map(torch.clone, critic_params),
            actor_opt=actor_opt.init(actor_params), critic_opt=critic_opt.init(critic_params),
            ring=EpisodeBuffer.create(cfg.buffer_size, env.episode_limit, rec, rank, world),
            acc=EpisodeAccumulator.create(N, env.episode_limit, rec),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            actor_h=torch.zeros((N, n, H), device=device),
            stats=EpisodeStats.create(N, device), step=0, episodes=0,
            update_debt=0, last_actor_loss=zero, last_critic_loss=zero.clone(),
            last_actor_gnorm=zero.clone(), last_critic_gnorm=zero.clone(), num_updates=0,
            generator=generator)

    def update(runner, batch, mask, noise):
        """One critic and one actor step on ``batch`` (B, T_max, ...) with
        step ``mask`` (B, T_max) and Gumbel ``noise``, this rank's rows of
        the sampled batch and its noise → (actor_params,
        critic_params, actor_opt, critic_opt, actor loss, critic loss,
        actor grad norm, critic grad norm)."""
        g_target, g_fresh = noise
        seq = time_major if cfg.recurrent else (lambda x: x)
        obs, next_obs = seq(batch["obs"]), seq(batch["next_obs"])
        with torch.no_grad():
            next_logits = target_next_logits_episodes(runner.target_actor, obs, next_obs,
                                                      batch["next_avail"])
            a_next = gumbel_softmax(next_logits, g_target, cfg.gumbel_tau, hard=True)
            q_next = critic_q(runner.target_critic, batch["next_state"], a_next)
            reward, msum = masked_count(batch["reward"], mask, cfg.normalize_reward)
            target = reward + cfg.gamma * (1.0 - batch["ended"].float()) * q_next

        def critic_loss_fn(p):
            q = critic_q(p, batch["state"], batch["action"])
            return torch.sum(torch.square(target - q) * mask) / msum, ()

        c_loss, _, c_grads = value_and_grad(critic_loss_fn, runner.critic_params)
        c_grads, (c_loss,) = dp.all_reduce_sum([c_grads, [c_loss]])
        with torch.no_grad():
            c_gnorm = nets.global_norm(c_grads)
            critic_params, c_opt = critic_opt.update(c_grads, runner.critic_opt,
                                                     runner.critic_params)
        # joint i = fresh for agent i, stored for the others: all n at once
        eye = torch.eye(n, device=mask.device).reshape(n, 1, 1, n, 1)
        state_n = batch["state"].expand((n,) + tuple(batch["state"].shape))

        def actor_loss_fn(p):
            logits = actor_logits_episodes(p, obs, batch["avail"])
            fresh = gumbel_softmax(logits, g_fresh, cfg.gumbel_tau, hard=False)
            joint = eye * fresh + (1.0 - eye) * batch["action"]          # (n, B, T, n, A)
            q_all = critic_q(critic_params, state_n, joint)              # (n, B, T)
            return -torch.sum(q_all * mask) / msum, ()

        a_loss, _, a_grads = value_and_grad(actor_loss_fn, runner.actor_params)
        a_grads, (a_loss,) = dp.all_reduce_sum([a_grads, [a_loss]])
        with torch.no_grad():
            a_gnorm = nets.global_norm(a_grads)
            actor_params, a_opt = actor_opt.update(a_grads, runner.actor_opt,
                                                   runner.actor_params)
        return actor_params, critic_params, a_opt, c_opt, a_loss, c_loss, a_gnorm, c_gnorm

    def train_iter(runner: MADDPGRunnerState):
        """One env step of the batch, its record, and the updates and
        target step it makes due. → runner."""
        gen = runner.generator
        with torch.no_grad():
            h2, logits = actor_step(runner.actor_params, runner.actor_h, runner.obs,
                                    runner.avail)
            onehot = gumbel_softmax(logits, gumbel_noise(gen, logits.shape),
                                    cfg.gumbel_tau, hard=True)
            actions = torch.argmax(onehot, dim=-1)
            env_state, ts2, final = vec.step(runner.env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            h2 = torch.where(ended[:, None, None], 0.0, h2)
            record = {"obs": runner.obs, "state": runner.state, "avail": runner.avail.bool(),
                      "action": onehot, "reward": ts2.reward, "ended": ended,
                      "next_obs": final.obs, "next_state": final.state,
                      "next_avail": final.avail.bool()}
            n_new = runner.acc.add_step(runner.ring, record, ended)   # host sync
            stats = runner.stats.step(
                ts2.reward, ended, ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))

        runner = runner.replace(env_state=env_state, obs=ts2.obs, state=ts2.state,
                                avail=ts2.avail, actor_h=h2, stats=stats, step=runner.step + 1)
        return run_due_updates(cfg, runner, n_new, n_slots, update)

    def scalar(x):
        return torch.tensor(float(x), device=device)

    def train_block(runner: MADDPGRunnerState):
        """``log_interval`` iterations; the metrics stay on the device."""
        for _ in range(cfg.log_interval):
            runner = train_iter(runner)
        metrics = {
            **runner.stats.rollout_metrics(),
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
        carry, logits = actor_step(params, carry, obs, avail)
        return carry, masked_argmax(logits, avail)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, greedy_policy,
                             init_carry=lambda m: torch.zeros((m, n, H), device=device))
    meta = {"update": update, "train_iter": train_iter, "draw_noise": draw_noise,
            "steps_per_block": cfg.num_envs * cfg.log_interval, "gru_impl": gru_impl,
            "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: MADDPGConfig, env=None, logger=None, algo_name: str = "MADDPG"):
    """``--use_mesh`` on more than one card trains on one spawned rank per
    card and returns (None, rank 0's last eval metrics)
    (``multihost.spawn_if_mesh``)."""
    from cleanmarl_tpu_torch.core.driver import run_training
    from cleanmarl_tpu_torch.distributed import multihost

    spawned = multihost.spawn_if_mesh(functools.partial(train, algo_name=algo_name), cfg, env,
                                      logger)
    if spawned is not None:
        return spawned
    init, train_block, eval_fn, meta = make_train(cfg, env)
    return run_training(
        algo_name, cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.actor_params,
        steps_of=lambda r: r.step * cfg.num_envs,
        print_keys=("rollout/ep_reward", "train/critic_loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["MADDPG"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    return train(cli(MADDPGConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
