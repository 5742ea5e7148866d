"""Shared IPPO/MAPPO machinery: clipped PPO on auto-reset rollout
streams with λ-returns, feed-forward and recurrent (port of
``cleanmarl_tpu/algos/ppo_common.py``).

``make_train`` returns ``(init, train_block, eval_fn, meta)`` with the
JAX package's metric keys. The JAX ``lax.scan`` loops become Python
loops over batched tensor ops that stay on the device:

- ``collect_rollout``: ``rollout_len`` steps of the actor (one GRU cell
  step per env step), Gumbel-max sampling from the runner's
  ``torch.Generator``, the batched env step with auto-reset, and the
  carry zeroed where an episode ended;
- ``ppo_update``: values and λ-advantages with the pre-update critic
  (one λ-return kernel launch on CUDA), then ``epochs`` passes over
  ``num_minibatches`` contiguous env-axis slices. The recurrent actor
  re-runs the GRU over each slice's whole rollout: on CUDA through the
  fused GRU kernels with their hand-written backward
  (``ops/gru_kernel.py``), else the step-by-step scan;
- ``train_block``: ``log_interval`` rollouts and updates, returning
  device tensors; the driver moves them to the host once per block.

In a process group (``distributed/dp.py``) each rank steps
``num_envs / world`` envs, the global envs ``rank, rank + world, ...``;
``num_envs`` stays the global count and ``runner.step`` counts global env
steps. Reward, advantage and return statistics are reduced over the
ranks, each loss is the rank's masked sum over the global count, and the
gradients (with the loss metrics) are summed over the ranks in one
all-reduce a minibatch before the norm, clipping and Adam, so every rank
takes the same step. K1 runs over the rank's own columns, K2, K3 and dw
over its rows of each minibatch. With one rank nothing is reduced.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.utils.checkpoint

from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import value_and_grad
from cleanmarl_tpu_torch.core.rewards import standardize
from cleanmarl_tpu_torch.core.tracing import count, span
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.base import categorical
from cleanmarl_tpu_torch.envs.external import as_vec
from cleanmarl_tpu_torch.ops.returns import lambda_advantages


@dataclass
class PPOConfig:
    # field names and defaults of the JAX package's PPOConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    # SMAClite's opt-in unit push-out; the JAX recipe builds that env by
    # hand (scripts/mappo_3m_run.py --unit_collisions), the port's CLI
    # takes it as a flag
    unit_collisions: bool = False
    num_envs: int = 16
    rollout_len: int = 0            # 0 → env.episode_limit
    recurrent: bool = False         # GRU actor
    tbptt: int = 0                  # 0 → full BPTT through the rollout
    actor_hidden_dim: int = 32
    actor_num_layers: int = 1
    critic_hidden_dim: int = 32
    critic_num_layers: int = 1
    optimizer: str = "adam"
    learning_rate_actor: float = 8e-4
    learning_rate_critic: float = 8e-4
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    td_lambda: float = 0.95
    normalize_reward: bool = False
    normalize_advantage: bool = False
    normalize_return: bool = False
    ppo_clip: float = 0.2
    entropy_coef: float = 0.001
    anneal_entropy: bool = False
    epochs: int = 3
    num_minibatches: int = 1        # >1: env-axis slices per epoch (split over ranks)
    remat_actor: bool = False       # recompute the actor sequence in backward
    gru_impl: str = "auto"          # auto | scan | kernel (xla | pallas aliases)
    compute_dtype: str = "float32"  # "bfloat16": bf16 operands, f32 accumulate
    anneal_lr: bool = False
    death_masking: bool = False
    normalize_values: bool = False
    clip_gradients: float = -1.0
    log_interval: int = 8           # rollouts per host log
    eval_steps: int = 50_000
    num_eval_ep: int = 10
    checkpoint_dir: str = ""        # saves the whole runner (core/checkpoint.py)
    checkpoint_every: int = 200_000
    resume: bool = False
    use_wnb: bool = False
    wnb_project: str = ""
    wnb_entity: str = ""
    profile_dir: str = ""           # torch.profiler trace of block 1
    use_mesh: bool = False          # one rank per visible card (distributed/)
    coordinator_address: str = ""   # host:port of a multi-process run
    num_processes: int = 1
    process_id: int = 0
    seed: int = 1
    verbose: bool = True
    device: str = "cuda"            # the port runs on the card unless asked


@dataclass
class PPORunnerState:
    actor_params: Any
    critic_params: Any
    actor_opt: Any
    critic_opt: Any
    env_state: Any
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    actor_h: torch.Tensor      # (num_envs, n_agents, H); zeros when FF
    stats: EpisodeStats
    step: int                  # global env transitions so far (host counter)
    num_updates: int
    vnorm: Dict[str, torch.Tensor]
    generator: torch.Generator

    def replace(self, **kw) -> "PPORunnerState":
        return dataclasses.replace(self, **kw)


def alive_mask(avail):
    """1.0 where the agent is alive: any action besides the no-op is
    available, or the no-op itself is unavailable."""
    a = avail.float()
    return torch.where((a.sum(-1) > 1.0) | (a[..., 0] == 0.0), 1.0, 0.0)


def wmean(x, w):
    """Weighted mean over all elements of every rank; ``w=None`` → plain
    mean."""
    if w is None:
        return dp.global_mean(x)
    num, den = dp.global_sum((x * w).sum(), w.sum())
    return num / torch.clamp(den, min=1.0)


def wstandardize(x, w):
    m = wmean(x, w)
    var = wmean(torch.square(x - m), w)
    return (x - m) / (torch.sqrt(var) + 1e-8)


def vnorm_init(device):
    return dict(mean=torch.zeros((), device=device),
                var=torch.ones((), device=device),
                count=torch.full((), 1e-4, device=device))


def vnorm_update(vn, batch, w=None):
    """Welford merge of one returns batch (of every rank) into the running
    stats."""
    bm = wmean(batch, w)
    bv = wmean(torch.square(batch - bm), w)
    if w is None:
        bc = float(batch.numel() * dp.rank_world()[1])
    else:
        bc = torch.clamp(dp.global_sum(w.sum())[0], min=1.0)
    tot = vn["count"] + bc
    delta = bm - vn["mean"]
    mean = vn["mean"] + delta * bc / tot
    m2 = vn["var"] * vn["count"] + bv * bc + torch.square(delta) * vn["count"] * bc / tot
    return dict(mean=mean, var=m2 / tot, count=tot)


def make_train(cfg: PPOConfig, env=None, centralized: bool = False,
               algo_name: str = "IPPO"):
    device = resolve_device(cfg.device)
    if cfg.unit_collisions and (env is not None or cfg.env_type != "smaclite"):
        raise ValueError("--unit_collisions applies to --env_type smaclite built from "
                         "the config")
    if env is None:
        env_kw = {"unit_collisions": True} if cfg.unit_collisions else {}
        env = registry.make(cfg.env_type, cfg.env_name, agent_ids=cfg.agent_ids,
                            env_family=cfg.env_family, device=device, **env_kw)
    rollout_len = cfg.rollout_len or env.episode_limit
    n_mb = max(1, cfg.num_minibatches)
    if cfg.num_envs % n_mb:
        raise ValueError(f"num_envs={cfg.num_envs} not divisible by "
                         f"num_minibatches={n_mb}")
    world = dp.rank_world()[1]
    N = dp.check_layout(cfg.num_envs, n_mb, world)     # this rank's envs
    vec = as_vec(env, N)
    total_updates = cfg.epochs * n_mb * max(
        cfg.total_timesteps // (rollout_len * cfg.num_envs), 1)
    n_updates = total_updates if cfg.anneal_lr else 0
    actor_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_actor,
                               cfg.clip_gradients, n_updates)
    critic_opt = make_optimizer(cfg.optimizer, cfg.learning_rate_critic,
                                cfg.clip_gradients, n_updates)
    critic_in = env.state_dim if centralized else env.obs_dim
    H = cfg.actor_hidden_dim
    n_agents = env.n_agents
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32|bfloat16, "
                         f"got {cfg.compute_dtype!r}")
    mm_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    # "auto" never resolves to the kernel with tbptt or bf16; an explicit
    # kernel request with either is refused here, before any work
    gru_impl = nets.resolve_gru_impl(cfg.gru_impl, H, tbptt=cfg.tbptt,
                                     bf16=mm_dtype is not None, device=device)
    if gru_impl == "kernel" and cfg.tbptt:
        raise ValueError(f"gru_impl={cfg.gru_impl!r} does not support tbptt>0")
    if gru_impl == "kernel" and mm_dtype is not None:
        raise ValueError(f"gru_impl={cfg.gru_impl!r} with compute_dtype='bfloat16' "
                         "is not supported (the fused kernel's recurrent matmul "
                         "is f32)")
    if cfg.normalize_values and cfg.normalize_return:
        raise ValueError("normalize_values (running-stat) and normalize_return "
                         "(per-batch) are mutually exclusive critic-target "
                         "transforms")

    def actor_step(actor_params, h, obs, avail):
        """One actor forward → (h', masked logits)."""
        if cfg.recurrent:
            h2, logits = nets.rnn_apply(actor_params, h, obs)
            return h2, nets.masked_q(logits, avail)
        return h, nets.masked_q(nets.mlp_apply(actor_params, obs), avail)

    def actor_logits_seq(actor_params, h0, obs_seq, avail_seq, ended_seq):
        """Logits over a (T, B, n, ·) stream, the GRU carry reset at
        episode boundaries."""
        if not cfg.recurrent:
            return nets.masked_q(nets.mlp_apply(actor_params, obs_seq, dtype=mm_dtype),
                                 avail_seq)
        _, logits = nets.rnn_seq_apply(actor_params, h0, obs_seq,
                                       reset_seq=ended_seq, tbptt=cfg.tbptt,
                                       dtype=mm_dtype, impl=gru_impl)
        return nets.masked_q(logits, avail_seq)

    def critic_values(critic_params, batch_obs, batch_state, dtype=None):
        """→ values broadcast per agent (..., n_agents)."""
        if centralized:
            v = nets.mlp_apply(critic_params, batch_state, dtype=dtype)[..., 0]
            return v[..., None].expand(v.shape + (n_agents,))
        return nets.mlp_apply(critic_params, batch_obs, dtype=dtype)[..., 0]

    def init(generator: torch.Generator) -> PPORunnerState:
        if cfg.recurrent:
            actor_params = nets.rnn_init(generator, env.obs_dim, H, env.n_actions,
                                         final_gain=0.01, device=device)
        else:
            actor_params = nets.mlp_init(generator, env.obs_dim, H, env.n_actions,
                                         cfg.actor_num_layers, final_gain=0.01,
                                         device=device)
        critic_params = nets.mlp_init(generator, critic_in, cfg.critic_hidden_dim,
                                      1, cfg.critic_num_layers, device=device)
        env_state, ts = vec.reset(generator)
        return PPORunnerState(
            actor_params=actor_params, critic_params=critic_params,
            actor_opt=actor_opt.init(actor_params),
            critic_opt=critic_opt.init(critic_params),
            env_state=env_state, obs=ts.obs, state=ts.state, avail=ts.avail,
            actor_h=torch.zeros((N, n_agents, H), device=device),
            stats=EpisodeStats.create(N, device), step=0,
            num_updates=0, vnorm=vnorm_init(device), generator=generator,
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect_rollout(runner: PPORunnerState):
        with span("ppo.rollout"):
            return _collect_rollout(runner)

    def _collect_rollout(runner: PPORunnerState):
        gen = runner.generator
        traj = {
            "obs": torch.empty((rollout_len,) + tuple(runner.obs.shape), device=device),
            "state": torch.empty((rollout_len,) + tuple(runner.state.shape),
                                 device=device),
            "avail": torch.empty((rollout_len,) + tuple(runner.avail.shape),
                                 dtype=torch.bool, device=device),
            "action": torch.empty((rollout_len, N, n_agents), dtype=torch.int64,
                                  device=device),
            "logp": torch.empty((rollout_len, N, n_agents), device=device),
            "reward": torch.empty((rollout_len, N), device=device),
            "ended": torch.empty((rollout_len, N), dtype=torch.bool, device=device),
        }
        env_state, obs, state, avail = (runner.env_state, runner.obs, runner.state,
                                        runner.avail)
        h0 = h = runner.actor_h
        stats = runner.stats
        for t in range(rollout_len):
            with span("ppo.rollout_step"):
                h2, logits = actor_step(runner.actor_params, h, obs, avail)
                actions = categorical(logits, gen)
                logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                    actions[..., None])[..., 0]
                env_state, ts2, _ = vec.step(env_state, actions, gen)
                ended = torch.logical_or(ts2.done, ts2.truncated)
                h = torch.where(ended[:, None, None], 0.0, h2)
                stats = stats.step(ts2.reward, ended,
                                   ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))
                for k, v in (("obs", obs), ("state", state), ("avail", avail),
                             ("action", actions), ("logp", logp),
                             ("reward", ts2.reward), ("ended", ended)):
                    traj[k][t] = v
                obs, state, avail = ts2.obs, ts2.state, ts2.avail
        runner = runner.replace(env_state=env_state, obs=obs, state=state,
                                avail=avail, actor_h=h, stats=stats,
                                step=runner.step + rollout_len * cfg.num_envs)
        return runner, traj, h0

    # ------------------------------------------------------------------
    def ppo_update(runner: PPORunnerState, traj, h0):
        with span("ppo.update"):
            return _ppo_update(runner, traj, h0)

    def _ppo_update(runner: PPORunnerState, traj, h0):
        with torch.no_grad(), span("ppo.returns"):
            alive = None
            if cfg.death_masking:
                with span("ppo.death_mask"):
                    alive = alive_mask(traj["avail"])
                    count("ppo.agent_steps", alive.numel())
                    count("ppo.alive_agent_steps", alive)
            values = critic_values(runner.critic_params, traj["obs"], traj["state"])
            vboot = critic_values(runner.critic_params, runner.obs, runner.state)
            if cfg.normalize_values:
                with span("ppo.value_norm"):
                    sigma = torch.sqrt(runner.vnorm["var"]) + 1e-8
                    values = values * sigma + runner.vnorm["mean"]
                    vboot = vboot * sigma + runner.vnorm["mean"]
            team_reward = traj["reward"]
            if cfg.normalize_reward:
                team_reward = standardize(team_reward)
            reward = team_reward[..., None].expand(values.shape)
            ended = traj["ended"][..., None].expand(values.shape)
            returns, adv = lambda_advantages(reward, ended, values, vboot,
                                             cfg.gamma, cfg.td_lambda)
            if cfg.normalize_advantage:
                with span("ppo.adv_norm"):
                    adv = wstandardize(adv, alive)
            if cfg.normalize_return:
                mu, std = dp.global_mean_std(returns.mean(-1))
                returns = (returns - mu) / (std + 1e-8)
            vnorm = runner.vnorm
            if cfg.normalize_values:
                with span("ppo.value_norm"):
                    vnorm = vnorm_update(vnorm, returns, alive)
                    returns = (returns - vnorm["mean"]) / (torch.sqrt(vnorm["var"]) + 1e-8)

        ent_coef = cfg.entropy_coef
        if cfg.anneal_entropy:
            frac = np.float32(1.0) - np.float32(runner.num_updates) / np.float32(total_updates)
            ent_coef = float(np.float32(cfg.entropy_coef) * np.clip(frac, 0.0, 1.0))

        logits_seq = actor_logits_seq
        if cfg.remat_actor:
            def logits_seq(*args):
                return torch.utils.checkpoint.checkpoint(
                    actor_logits_seq, *args, use_reentrant=False)

        def share(x, mb, alive_count):
            """This rank's share of the minibatch's (alive-weighted) mean:
            its sum over the count of every rank (the mean on one rank)."""
            w = mb.get("alive")
            if w is not None:
                return (x * w).sum() / alive_count
            return dp.mean_share(x)

        def actor_loss_fn(actor_params, mb, alive_count=None):
            logits = logits_seq(actor_params, mb["h0"], mb["obs"], mb["avail"],
                                mb["ended"])
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = torch.gather(logp_all, -1, mb["action"][..., None])[..., 0]
            log_ratio = logp - mb["logp"]
            ratio = torch.exp(log_ratio)
            pg1 = mb["adv"] * ratio
            pg2 = mb["adv"] * torch.clamp(ratio, 1.0 - cfg.ppo_clip, 1.0 + cfg.ppo_clip)
            pg = share(torch.minimum(pg1, pg2), mb, alive_count)
            p = torch.exp(logp_all)
            entropy = share(-torch.sum(p * logp_all, dim=-1), mb, alive_count)
            loss = -pg - ent_coef * entropy
            kl = share((ratio - 1.0) - log_ratio, mb, alive_count)
            clipped = share((torch.abs(ratio - 1.0) > cfg.ppo_clip).float(), mb,
                            alive_count)
            return loss, (entropy, kl, clipped)

        def critic_loss_fn(critic_params, mb, alive_count=None):
            v = critic_values(critic_params, mb["obs"], mb["state"], dtype=mm_dtype)
            return share(torch.square(v - mb["returns"]), mb, alive_count), ()

        full = {k: traj[k] for k in ("obs", "state", "avail", "action", "logp", "ended")}
        full["adv"], full["returns"] = adv, returns
        if cfg.death_masking:
            full["alive"] = alive

        a_params, c_params = runner.actor_params, runner.critic_params
        a_opt, c_opt = runner.actor_opt, runner.critic_opt
        mb_size = N // n_mb
        slices = [slice(i * mb_size, (i + 1) * mb_size) for i in range(n_mb)]
        if cfg.death_masking:
            with span("ppo.death_mask"):
                # every minibatch's alive count over the ranks, in one collective
                counts = dp.global_sum(*(alive[:, sl].sum() for sl in slices))
        epoch_ms = []
        for _ in range(cfg.epochs):
            with span("ppo.epoch"):
                mb_ms = []
                for i, sl in enumerate(slices):
                    with span("ppo.minibatch"):
                        mb = {k: v[:, sl] for k, v in full.items()}
                        mb["h0"] = h0[sl]
                        a_fn, c_fn = actor_loss_fn, critic_loss_fn
                        if cfg.death_masking:
                            # every entry of mb is an env-axis slice; the count is not
                            n_alive = torch.clamp(counts[i], min=1.0)
                            a_fn = functools.partial(actor_loss_fn, alive_count=n_alive)
                            c_fn = functools.partial(critic_loss_fn, alive_count=n_alive)
                        with span("ppo.actor_grad"):
                            a_loss, (entropy, kl, clipped), a_grads = value_and_grad(
                                a_fn, a_params, mb)
                        with span("ppo.critic_grad"):
                            c_loss, _, c_grads = value_and_grad(c_fn, c_params, mb)
                        # the gradients and the loss metrics of every rank, summed
                        a_grads, c_grads, (a_loss, c_loss, entropy, kl, clipped) = (
                            dp.all_reduce_sum([a_grads, c_grads,
                                               [a_loss, c_loss, entropy, kl, clipped]]))
                        with torch.no_grad():
                            a_gnorm = nets.global_norm(a_grads)
                            c_gnorm = nets.global_norm(c_grads)
                            a_params, a_opt = actor_opt.update(a_grads, a_opt, a_params)
                            c_params, c_opt = critic_opt.update(c_grads, c_opt, c_params)
                        mb_ms.append(torch.stack([a_loss, c_loss, entropy, kl, clipped,
                                                  a_gnorm, c_gnorm]))
                epoch_ms.append(torch.stack(mb_ms).mean(0))
        m = torch.stack(epoch_ms).mean(0)
        keys = ("train/actor_loss", "train/critic_loss", "train/entropy",
                "train/kl_divergence", "train/clipped_ratios",
                "train/actor_gradients", "train/critic_gradients")
        metrics = dict(zip(keys, m.unbind(0)))
        if cfg.normalize_values:
            metrics["train/value_norm_mean"] = vnorm["mean"]
            metrics["train/value_norm_std"] = torch.sqrt(vnorm["var"])
        runner = runner.replace(
            actor_params=a_params, critic_params=c_params, actor_opt=a_opt,
            critic_opt=c_opt, num_updates=runner.num_updates + cfg.epochs * n_mb,
            vnorm=vnorm)
        return runner, metrics

    # ------------------------------------------------------------------
    def train_block(runner: PPORunnerState):
        """``log_interval`` rollouts + updates. Metrics stay on the
        device; the caller moves them to the host once."""
        ms = {}
        for _ in range(cfg.log_interval):
            runner, traj, h0 = collect_rollout(runner)
            runner, ms = ppo_update(runner, traj, h0)
        metrics = {
            **runner.stats.rollout_metrics(), **ms,
            "train/num_updates": torch.tensor(float(runner.num_updates), device=device),
        }
        return runner.replace(stats=runner.stats.flush()), metrics

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def phase_timer(runner, iters: int = 3):
        """Per-phase wall time, rollout vs PPO update, each timed alone
        on the same runner and ended with a device synchronize. The
        runner's generator is put back as it was, so a run that times its
        phases trains on the same stream as one that does not."""
        gen_state = runner.generator.get_state()
        try:
            return _phase_times(runner, iters)
        finally:
            runner.generator.set_state(gen_state)

    def _phase_times(runner, iters):
        collect_rollout(runner)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            collect_rollout(runner)
        _sync()
        rollout_s = (time.perf_counter() - t0) / iters
        r2, traj, h0 = collect_rollout(runner)
        ppo_update(r2, traj, h0)
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            ppo_update(r2, traj, h0)
        _sync()
        update_s = (time.perf_counter() - t0) / iters
        return {
            "perf/rollout_s": rollout_s,
            "perf/update_s": update_s,
            "perf/rollout_frac": rollout_s / max(rollout_s + update_s, 1e-9),
        }

    def sampled_policy(params, carry, obs, avail, generator):
        carry, logits = actor_step(params, carry, obs, avail)
        return carry, categorical(logits, generator)

    eval_fn = make_evaluator(
        env, cfg.num_eval_ep, sampled_policy,
        init_carry=lambda m: torch.zeros((m, n_agents, H), device=device))

    # analytic model FLOPs per env transition (matmul MACs x 2), as the
    # JAX package counts them: env.obs_dim is the wrapped width, bias
    # adds and gating are excluded, backward ≈ 2x forward
    macs_actor = (
        env.obs_dim * H + H * 3 * H + H * 3 * H + H * env.n_actions
        if cfg.recurrent else
        env.obs_dim * H + cfg.actor_num_layers * H * H + H * env.n_actions
    )
    Hc = cfg.critic_hidden_dim
    macs_critic = critic_in * Hc + cfg.critic_num_layers * Hc * Hc + Hc
    n_critic = 1 if centralized else n_agents
    critic_evals = 1 + 1.0 / rollout_len + 3 * cfg.epochs
    per_step_macs = (n_agents * macs_actor * (1 + 3 * cfg.epochs)
                     + n_critic * macs_critic * critic_evals)
    meta = {
        "rollout_len": rollout_len,
        "steps_per_block": rollout_len * cfg.num_envs * cfg.log_interval,
        "algo_name": algo_name,
        "phase_timer": phase_timer,
        "model_flops_per_step": 2.0 * per_step_macs,
        "gru_impl": gru_impl,
        "device": device,
        "collect_rollout": collect_rollout,
        "ppo_update": ppo_update,
        "local_envs": N,
    }
    return init, train_block, eval_fn, meta


def train(cfg: PPOConfig, env=None, centralized: bool = False,
          algo_name: str = "IPPO", logger=None):
    """``--use_mesh`` on more than one card trains on one spawned rank per
    card and returns (None, rank 0's last eval metrics)
    (``multihost.spawn_if_mesh``)."""
    from cleanmarl_tpu_torch.core.driver import run_training
    from cleanmarl_tpu_torch.distributed import multihost

    spawned = multihost.spawn_if_mesh(functools.partial(
        train, centralized=centralized, algo_name=algo_name), cfg, env, logger)
    if spawned is not None:
        return spawned
    init, train_block, eval_fn, meta = make_train(cfg, env, centralized, algo_name)
    return run_training(
        algo_name, cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.actor_params,
        print_keys=("rollout/ep_reward", "train/actor_loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["PPO"],
        phase_timer=meta["phase_timer"],
    )
