"""COMA: counterfactual multi-agent policy gradients (port of
``cleanmarl_tpu/algos/coma.py``).

- **Critic**: per-agent action values Q_i(·) over the input
  [state ‖ own obs ‖ one-hot actions of the OTHER agents]
  (``critic_input``: one gather from an index table of the others).
- **Targets**: TD(λ) against the TARGET critic's Q at the taken action,
  G_t = r + γ(1−ended)·(λ·G_{t+1} + (1−λ)·Q'_{t+1}[a_{t+1}]), over the
  auto-reset rollout stream; at the rollout cut the tail bootstraps with
  the expected-SARSA value Σ_a π(a)·Q'(a) from the live hidden state.
  ``use_tdlambda=False`` gives n-step targets (λ=0 for ``nsteps=1``).
  On the card the λ-returns are one launch of the λ-return kernel
  (``ops/returns.py``), reading the team reward and the end flag
  broadcast over the agents without a copy.
- **Advantage**: the counterfactual baseline
  A_i = Q_i[a_i] − Σ_a π_i(a)·Q_i(a), detached.
- **Actor**: the ε-softmax behaviour policy
  (1−ε)·softmax(masked logits) + ε·uniform(avail), ε scheduled over
  training updates; the gradient uses ε = 0; the entropy bonus is the
  reference's mean over actions. With ``recurrent=True`` the actor is
  fc1 → GRU → head, recomputed over the rollout from its carried start
  state with resets at episode ends (on the card: one K2 forward, K3 and
  dw in its backward).

``train_block`` runs ``log_interval`` rollouts, each followed by one
update. With ``bootstrap_truncation`` the train loop draws the sampled
action of the truncation bootstrap and passes it to
``meta["update"]``, which only computes.

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs (the global envs ``rank, rank + world, ...``); reward,
return and advantage normalization use every rank's statistics, each
loss is the rank's sum over the global count, and the critic's gradients
(every ``critic_epochs`` step) and the actor's are summed over the ranks
before Adam. With one rank nothing is reduced.

    python -m cleanmarl_tpu_torch.algos.coma --env_type smaclite \
        --env_name 3m --num_envs 64                    # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import tree_map, value_and_grad
from cleanmarl_tpu_torch.core.rewards import standardize
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.base import categorical
from cleanmarl_tpu_torch.envs.external import as_vec
from cleanmarl_tpu_torch.ops.returns import lambda_returns, nstep_returns


@dataclass
class COMAConfig:
    # field names and defaults of the JAX package's COMAConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    num_envs: int = 16
    rollout_len: int = 0              # 0 → episode_limit
    recurrent: bool = False           # GRU actor
    per_agent_rewards: bool = False   # un-aggregated env rewards (info["agent_rewards"])
    bootstrap_truncation: bool = False  # r + γQ'(s_T, a~π_ε) at time-limit
    # truncation instead of a zero tail; FF actor only
    actor_hidden_dim: int = 64
    actor_num_layers: int = 1
    critic_hidden_dim: int = 64
    critic_num_layers: int = 1
    optimizer: str = "adam"
    learning_rate_actor: float = 5e-4
    learning_rate_critic: float = 5e-4
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    td_lambda: float = 0.8
    use_tdlambda: bool = True         # False → n-step targets
    nsteps: int = 1                   # n-step horizon when use_tdlambda=False
    entropy_coef: float = 0.001
    anneal_entropy: bool = False      # linear entropy-coef decay to 0 over the run
    critic_epochs: int = 1            # critic gradient steps per rollout
    anneal_lr: bool = False           # linear LR decay to 0 over the run
    start_e: float = 0.5
    end_e: float = 0.002
    exploration_fraction: float = 750.0  # in training updates
    target_network_update_freq: int = 1  # in training updates
    polyak: float = 0.005
    normalize_reward: bool = False    # standardize batch rewards
    normalize_advantage: bool = True
    normalize_return: bool = False    # standardize critic targets (agent-mean)
    clip_gradients: float = -1.0
    log_interval: int = 8
    eval_steps: int = 50_000
    num_eval_ep: int = 10
    checkpoint_dir: str = ""          # saves the whole runner (core/checkpoint.py)
    checkpoint_every: int = 200_000
    resume: bool = False
    use_wnb: bool = False
    wnb_project: str = ""
    wnb_entity: str = ""
    profile_dir: str = ""             # torch.profiler trace of block 1
    use_mesh: bool = False            # one rank per visible card (distributed/)
    coordinator_address: str = ""     # host:port of a multi-process run
    num_processes: int = 1
    process_id: int = 0
    seed: int = 1
    verbose: bool = True
    device: str = "cuda"              # the port runs on the card unless asked


@dataclass
class COMARunnerState:
    actor_params: Any
    critic_params: Any
    target_critic: Any
    actor_opt: Any
    critic_opt: Any
    env_state: Any
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    actor_h: torch.Tensor        # (num_envs, n_agents, H); zeros when FF
    stats: EpisodeStats
    step: int                    # global env transitions so far (host counter)
    num_updates: int             # a float32 counter in JAX; exact below 2**24
    generator: torch.Generator

    def replace(self, **kw) -> "COMARunnerState":
        return dataclasses.replace(self, **kw)


def others_index(n: int, device="cpu") -> torch.Tensor:
    """(n, n−1): row i lists every agent but i in order (``jnp.delete``)."""
    idx = torch.arange(n, device=device)
    return torch.stack([torch.cat([idx[:i], idx[i + 1:]]) for i in range(n)])


def critic_input(state, obs, actions, others, n_actions: int):
    """[state ‖ own obs ‖ one-hot of the others' actions] per agent:
    state (..., S), obs (..., n, O), actions (..., n) int → (..., n,
    S + O + (n−1)·A)."""
    n = obs.shape[-2]
    onehot = torch.nn.functional.one_hot(actions, n_actions).float()       # (..., n, A)
    other = onehot[..., others, :]                                         # (..., n, n-1, A)
    other = other.reshape(other.shape[:-2] + ((n - 1) * n_actions,))
    state_b = state[..., None, :].expand(state.shape[:-1] + (n, state.shape[-1]))
    return torch.cat([state_b, obs, other], dim=-1)


def counterfactual_advantage(q, pi, actions):
    """A_i = Q_i[a_i] − Σ_a π_i(a)·Q_i(a): q, pi (..., A), actions (...)."""
    q_taken = torch.gather(q, -1, actions[..., None])[..., 0]
    return q_taken - torch.sum(pi * q, dim=-1)


def eps_mix(logits, avail, epsilon: float):
    """(1−ε)·softmax(masked logits) + ε·uniform(avail)."""
    probs = torch.softmax(logits, dim=-1)
    availf = avail.float()
    uni = availf / torch.clamp(availf.sum(-1, keepdim=True), min=1.0)
    return (1.0 - epsilon) * probs + epsilon * uni


def check_config(cfg: COMAConfig, env) -> None:
    """The JAX package's guards, with its messages."""
    if cfg.bootstrap_truncation and cfg.recurrent:
        raise ValueError(
            "--bootstrap_truncation requires a feed-forward actor "
            "(--recurrent false): the truncation bootstrap re-runs the "
            "actor on the terminal observation, which has no GRU hidden "
            "stream to resume (reference coma_lbf.py is feed-forward)"
        )
    if cfg.per_agent_rewards:
        if hasattr(env, "make_vec"):        # a host family declares it
            reports = env.provides_agent_rewards
        else:
            _, ts = env.reset(1, torch.Generator(env.device).manual_seed(0))
            reports = "agent_rewards" in ts.info
        if not reports:
            raise ValueError(
                "--per_agent_rewards needs an env that reports per-agent "
                "rewards in info['agent_rewards'] (LBF with "
                f"reward_aggr='none', envs/lbf.py); env "
                f"{cfg.env_type}:{cfg.env_name or '<default>'} does not"
            )


def make_train(cfg: COMAConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"](runner,
    traj, h0, epsilon, a_last=None)`` is one update on a rollout that
    ``meta["collect_rollout"](runner, epsilon)`` collected; ``a_last`` is
    the action sampled at the terminal observations that
    ``bootstrap_truncation`` needs (the train loop draws it). The recurrent
    actor's sequence route is ``resolve_gru_impl("auto")``'s
    (``meta["gru_impl"]``: the kernels on the card, the scan on the CPU;
    the JAX config has no such field)."""
    device = resolve_device(cfg.device)
    if env is None:
        env = registry.make(cfg.env_type, cfg.env_name, agent_ids=cfg.agent_ids,
                            env_family=cfg.env_family, device=device)
    check_config(cfg, env)
    world = dp.rank_world()[1]
    N = dp.check_layout(cfg.num_envs, 1, world)     # this rank's envs
    vec = as_vec(env, N)
    rollout_len = cfg.rollout_len or env.episode_limit
    total_updates = max(cfg.total_timesteps // (rollout_len * cfg.num_envs), 1)
    n_updates = total_updates if cfg.anneal_lr else 0
    actor_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_actor, cfg.clip_gradients,
                               n_updates)
    # the LR schedule counts optimizer steps: the critic takes
    # critic_epochs of them per rollout
    critic_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_critic, cfg.clip_gradients,
                                n_updates * max(1, cfg.critic_epochs))
    n, A, H = env.n_agents, env.n_actions, cfg.actor_hidden_dim
    critic_in = env.state_dim + env.obs_dim + (n - 1) * A
    lam = cfg.td_lambda if cfg.use_tdlambda else 0.0
    others = others_index(n, device)
    gru_impl = nets.resolve_gru_impl("auto", H, device=device) if cfg.recurrent else None

    def actor_step(params, h, obs, avail, epsilon):
        """→ (h', probs). h passes through for the FF actor."""
        if cfg.recurrent:
            h2, logits = nets.rnn_apply(params, h, obs)
        else:
            h2, logits = h, nets.mlp_apply(params, obs)
        return h2, eps_mix(nets.masked_q(logits, avail), avail, epsilon)

    def actor_probs(params, obs, avail, epsilon):
        """FF probabilities (no carry)."""
        return actor_step(params, None, obs, avail, epsilon)[1]

    def actor_probs_seq(params, h0, obs_seq, avail_seq, ended_seq, epsilon):
        """Probs over a (T, B, n, ·) stream, the GRU carry reset at
        episode ends (FF: per step)."""
        if not cfg.recurrent:
            return actor_probs(params, obs_seq, avail_seq, epsilon)
        _, logits = nets.rnn_seq_apply(params, h0, obs_seq, reset_seq=ended_seq,
                                       impl=gru_impl)
        return eps_mix(nets.masked_q(logits, avail_seq), avail_seq, epsilon)

    def critic_q(params, state, obs, actions):
        """→ Q (..., n, A): per-agent action values given the others'
        taken actions."""
        return nets.mlp_apply(params, critic_input(state, obs, actions, others, A))

    def taken(q, actions):
        return torch.gather(q, -1, actions[..., None])[..., 0]

    def init(generator: torch.Generator) -> COMARunnerState:
        if cfg.recurrent:
            actor_params = nets.rnn_init(generator, env.obs_dim, H, A, final_gain=0.01,
                                         device=device)
        else:
            actor_params = nets.mlp_init(generator, env.obs_dim, H, A, cfg.actor_num_layers,
                                         final_gain=0.01, device=device)
        critic_params = nets.mlp_init(generator, critic_in, cfg.critic_hidden_dim, A,
                                      cfg.critic_num_layers, device=device)
        env_state, ts = vec.reset(generator)
        return COMARunnerState(
            actor_params=actor_params, critic_params=critic_params,
            target_critic=tree_map(torch.clone, critic_params),
            actor_opt=actor_opt.init(actor_params), critic_opt=critic_opt.init(critic_params),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            actor_h=torch.zeros((N, n, H), device=device),
            stats=EpisodeStats.create(N, device), step=0, num_updates=0,
            generator=generator)

    @torch.no_grad()
    def collect_rollout(runner: COMARunnerState, epsilon: float):
        """``rollout_len`` steps of the ε-mixture policy → (runner, traj,
        h0): the team reward is stored (T, N) and broadcast over the
        agents at the update; h0 is the carry at the rollout's start."""
        gen = runner.generator
        T = rollout_len

        def empty(shape, dtype=torch.float32):
            return torch.empty((T,) + tuple(shape), dtype=dtype, device=device)
        traj = {"obs": empty(runner.obs.shape), "state": empty(runner.state.shape),
                "avail": empty(runner.avail.shape, torch.bool),
                "action": empty((N, n), torch.int64),
                "reward": empty((N, n) if cfg.per_agent_rewards else (N,)),
                "ended": empty((N,), torch.bool)}
        if cfg.bootstrap_truncation:
            traj.update(trunc_only=empty((N,), torch.bool), final_obs=empty(runner.obs.shape),
                        final_state=empty(runner.state.shape),
                        final_avail=empty(runner.avail.shape, torch.bool))
        env_state, obs, state, avail = runner.env_state, runner.obs, runner.state, runner.avail
        h0 = h = runner.actor_h
        stats = runner.stats
        for t in range(T):
            h2, probs = actor_step(runner.actor_params, h, obs, avail, epsilon)
            actions = categorical(torch.log(probs + 1e-10), gen)
            env_state, ts2, final = vec.step(env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            h = torch.where(ended[:, None, None], 0.0, h2)
            stats = stats.step(ts2.reward, ended,
                               ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))
            reward = ts2.info["agent_rewards"] if cfg.per_agent_rewards else ts2.reward
            step = {"obs": obs, "state": state, "avail": avail, "action": actions,
                    "reward": reward, "ended": ended}
            if cfg.bootstrap_truncation:
                step.update(trunc_only=ts2.truncated & ~ts2.done, final_obs=final.obs,
                            final_state=final.state, final_avail=final.avail.bool())
            for k, v in step.items():
                traj[k][t] = v
            obs, state, avail = ts2.obs, ts2.state, ts2.avail
        runner = runner.replace(env_state=env_state, obs=obs, state=state, avail=avail,
                                actor_h=h, stats=stats, step=runner.step + T * cfg.num_envs)
        return runner, traj, h0

    @torch.no_grad()
    def truncation_actions(runner: COMARunnerState, traj, epsilon: float):
        """The bootstrap_truncation sample: a ~ π_ε at every terminal
        (pre-reset) observation of the rollout, (T, N, n)."""
        pi_last = actor_probs(runner.actor_params, traj["final_obs"], traj["final_avail"],
                              epsilon)
        return categorical(torch.log(pi_last + 1e-10), runner.generator)

    def update(runner: COMARunnerState, traj, h0, epsilon: float, a_last=None):
        """One critic fit (``critic_epochs`` Adam steps) and one actor step
        on a rollout → (runner, metrics)."""
        with torch.no_grad():
            q_taken_tgt = taken(critic_q(runner.target_critic, traj["state"], traj["obs"],
                                         traj["action"]), traj["action"])      # (T, B, n)
            # expected-SARSA bootstrap at the rollout cut (live hidden
            # state); the cut-state critic takes the policy argmax for the
            # others' actions
            _, pi_boot = actor_step(runner.actor_params, runner.actor_h, runner.obs,
                                    runner.avail, 0.0)
            a_boot = torch.argmax(pi_boot, dim=-1)
            q_boot = critic_q(runner.target_critic, runner.state, runner.obs, a_boot)
            v_boot = torch.sum(pi_boot * q_boot, dim=-1)                      # (B, n)
            reward = traj["reward"]
            if cfg.normalize_reward:
                reward = standardize(reward)
            if not cfg.per_agent_rewards:
                reward = reward[..., None].expand(q_taken_tgt.shape)          # a view
            if cfg.bootstrap_truncation:
                # G at a time-limit cut = r + γ·Q'(s_T, a~π_ε): the bootstrap
                # folded into the reward at truncated steps
                q_last = taken(critic_q(runner.target_critic, traj["final_state"],
                                        traj["final_obs"], a_last), a_last)
                reward = reward + cfg.gamma * q_last * traj["trunc_only"][..., None].float()
            ended = traj["ended"][..., None].expand(q_taken_tgt.shape)          # a view
            if cfg.use_tdlambda or cfg.nsteps <= 1:
                returns = lambda_returns(reward, ended, q_taken_tgt, v_boot, cfg.gamma, lam)
            else:
                returns = nstep_returns(reward, ended, q_taken_tgt, v_boot, cfg.gamma,
                                        cfg.nsteps)
            if cfg.normalize_return:
                # agent-mean convention, critic targets only
                mu, std = dp.global_mean_std(returns.mean(dim=-1))
                returns = (returns - mu) / (std + 1e-8)

        def critic_loss_fn(p):
            q = critic_q(p, traj["state"], traj["obs"], traj["action"])
            return dp.mean_share(torch.square(taken(q, traj["action"]) - returns)), ()

        critic_params, c_opt = runner.critic_params, runner.critic_opt
        for _ in range(max(1, cfg.critic_epochs)):
            c_loss, _, c_grads = value_and_grad(critic_loss_fn, critic_params)
            c_grads, (c_loss,) = dp.all_reduce_sum([c_grads, [c_loss]])
            with torch.no_grad():
                c_gnorm = nets.global_norm(c_grads)
                critic_params, c_opt = critic_opt.update(c_grads, c_opt, critic_params)

        with torch.no_grad():
            q_new = critic_q(critic_params, traj["state"], traj["obs"], traj["action"])
        ent_coef = cfg.entropy_coef
        if cfg.anneal_entropy:
            frac = np.float32(1.0) - np.float32(runner.num_updates) / np.float32(total_updates)
            ent_coef = float(np.float32(cfg.entropy_coef) * np.clip(frac, 0.0, 1.0))

        def actor_loss_fn(p):
            pi = actor_probs_seq(p, h0, traj["obs"], traj["avail"], traj["ended"], 0.0)
            log_pi = torch.log(pi + 1e-8)
            adv = counterfactual_advantage(q_new, pi, traj["action"]).detach()
            if cfg.normalize_advantage:
                mu, std = dp.global_mean_std(adv)
                adv = (adv - mu) / (std + 1e-8)
            entropy = -torch.sum(pi * log_pi, dim=-1) / A    # the reference's mean over A
            ent = dp.mean_share(entropy)
            pg = dp.mean_share(taken(log_pi, traj["action"]) * adv)
            return -pg - ent_coef * ent, (ent,)

        a_loss, (entropy,), a_grads = value_and_grad(actor_loss_fn, runner.actor_params)
        a_grads, (a_loss, entropy) = dp.all_reduce_sum([a_grads, [a_loss, entropy]])
        with torch.no_grad():
            a_gnorm = nets.global_norm(a_grads)
            actor_params, a_opt = actor_opt.update(a_grads, runner.actor_opt,
                                                   runner.actor_params)
            num_updates = runner.num_updates + 1
            target_critic = runner.target_critic
            if num_updates % cfg.target_network_update_freq == 0:
                target_critic = nets.soft_update(target_critic, critic_params, cfg.polyak)
        runner = runner.replace(actor_params=actor_params, critic_params=critic_params,
                                target_critic=target_critic, actor_opt=a_opt,
                                critic_opt=c_opt, num_updates=num_updates)
        metrics = {"train/actor_loss": a_loss, "train/critic_loss": c_loss,
                   "train/entropy": entropy, "train/actor_gradients": a_gnorm,
                   "train/critic_gradients": c_gnorm}
        return runner, metrics

    def rollout_and_update(runner: COMARunnerState):
        epsilon = linear_schedule(cfg.start_e, cfg.end_e, cfg.exploration_fraction,
                                  runner.num_updates)
        runner, traj, h0 = collect_rollout(runner, epsilon)
        a_last = truncation_actions(runner, traj, epsilon) if cfg.bootstrap_truncation else None
        runner, metrics = update(runner, traj, h0, epsilon, a_last)
        metrics["rollout/epsilon"] = torch.tensor(epsilon, device=device)
        return runner, metrics

    def train_block(runner: COMARunnerState):
        """``log_interval`` rollouts and updates; the metrics stay on the
        device."""
        ms: Dict[str, torch.Tensor] = {}
        for _ in range(cfg.log_interval):
            runner, ms = rollout_and_update(runner)
        metrics = {**runner.stats.rollout_metrics(), **ms,
                   "train/num_updates": torch.tensor(float(runner.num_updates), device=device)}
        return runner.replace(stats=runner.stats.flush()), metrics

    def sampled_policy(params, carry, obs, avail, generator):
        carry, probs = actor_step(params, carry, obs, avail, 0.0)
        return carry, categorical(torch.log(probs + 1e-10), generator)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, sampled_policy,
                             init_carry=lambda m: torch.zeros((m, n, H), device=device))
    meta = {"update": update, "collect_rollout": collect_rollout, "rollout_len": rollout_len,
            "steps_per_block": rollout_len * cfg.num_envs * cfg.log_interval,
            "gru_impl": gru_impl, "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: COMAConfig, env=None, logger=None):
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
        "COMA", cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.actor_params,
        print_keys=("rollout/ep_reward", "train/critic_loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["COMA"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    return train(cli(COMAConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
