"""Recurrent value decomposition: GRU Q-nets for VDN and QMIX (port of
``cleanmarl_tpu/algos/recurrent_q.py``).

The Q-net is fc1 → GRU → head. ``mixing="vdn"`` sums the per-agent Qs,
``mixing="qmix"`` mixes them with the monotonic hypernetwork on the
global state. Two storage models:

- ``replay="episode"`` (default): whole episodes padded to
  ``episode_limit`` with a step mask (``buffers/episode.py``); every
  hidden state is recomputed from t = 0, and one update per
  ``train_freq`` completed episodes (``core/cadence.py``):

      target = r_t + γ(1−d_t)·mix'(max_a Q'(h'_t ⊕ o'_{t+1}), s'_{t+1})
      loss   = Σ m·(target − mix(Q(h_t, o_t)[a_t], s_t))² / max(Σ m, 1)

  where the target stream advances on ``obs`` and is read one GRU step
  ahead on ``next_obs`` (``networks.rnn_seq_eval_next``); ``tbptt=k``
  cuts the gradient through the carry every k steps;
- ``replay="sequence"`` (VDN only): ``seq_length``-step chunks with a
  back-filled last chunk (``buffers/sequence.py``), both streams warmed
  from zeros over the first ``burn_in`` steps without gradient, an
  unmasked VDN TD loss on the rest, and one update per ``train_freq``
  iterations.

The sequence recomputes of the update go through ``rnn_seq_apply`` and
``rnn_seq_eval_next`` on the route ``resolve_gru_impl`` picks: on the
card, the CUDA GRU kernels (K2 forward, K3 backward); the acting step is
one eager GRU cell. The JAX package runs ``log_interval`` iterations as
one compiled scan. Here an iteration is eager PyTorch on the device with
one host sync: the counts that ``add_step`` reads (episodes, or chunks
and episodes), from which the host runs exactly the updates that are due.

In a process group (``distributed/dp.py``) each rank steps ``num_envs /
world`` envs (the global envs ``rank, rank + world, ...``) with their GRU
carries and holds its rows of the ring (global row ``i`` on rank ``i %
world``); the counts that ``add_step`` reads are every rank's, so the
update clock is global. An update takes this rank's ``batch_size /
world`` rows of rank 0's sample, so its sequence recomputes run at the
rank's rows (on the card, K2, K3 and dw at ``batch_size / world ·
n_agents`` rows); the mask sum and the reward statistics are every
rank's, each loss is the rank's sum over the global count, and the
gradients are summed over the ranks before Adam. With one rank nothing
is reduced.

    python -m cleanmarl_tpu_torch.algos.qmix_rnn --env_type smaclite \
        --env_name 3m --num_envs 64                    # on the card
    ... --device cpu                                   # on the CPU
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Union

import numpy as np
import torch

from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
from cleanmarl_tpu_torch.buffers.sequence import SequenceAccumulator, SequenceBuffer
from cleanmarl_tpu_torch.core import cadence
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.acting import eps_greedy, masked_argmax
from cleanmarl_tpu_torch.core.device import resolve_device
from cleanmarl_tpu_torch.core.evaluation import make_evaluator
from cleanmarl_tpu_torch.core.metrics import EpisodeStats
from cleanmarl_tpu_torch.core.optim import make_optimizer
from cleanmarl_tpu_torch.core.params import tree_map, value_and_grad
from cleanmarl_tpu_torch.core.rewards import masked_count, standardize
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.core.tracing import count, span
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.external import as_vec


@dataclass
class RecurrentQConfig:
    # field names and defaults of the JAX package's RecurrentQConfig
    env_type: str = "matrix"
    env_name: str = ""
    env_family: str = "mpe"
    agent_ids: bool = True
    mixing: str = "vdn"              # "vdn" | "qmix"
    replay: str = "episode"          # "episode" | "sequence" (VDN only)
    seq_length: int = 10             # chunk length (replay="sequence")
    burn_in: int = 8                 # no-grad warm-up steps of each chunk
    normalize_reward: bool = False   # per-sampled-batch standardize
    bootstrap_truncation: bool = False  # True: time limits bootstrap through
    num_envs: int = 16
    buffer_size: int = 2000          # episodes (or chunks when replay=sequence)
    total_timesteps: int = 1_000_000
    gamma: float = 0.99
    train_freq: int = 1              # update every N completed episodes (iterations
    # when replay=sequence)
    optimizer: str = "adam"
    learning_rate: float = 5e-4
    batch_size: int = 10             # episodes (or chunks) per update
    start_e: float = 1.0
    end_e: float = 0.05
    exploration_fraction: float = 0.05
    hidden_dim: int = 64
    hyper_dim: int = 64
    embed_dim: int = 32
    tbptt: int = 0                   # 0 = full BPTT over the episode
    max_updates_per_iter: int = 0    # 0 = uncapped; the surplus carries as debt
    compute_dtype: str = "float32"   # "bfloat16": bf16 operands, f32 accumulate
    gru_impl: str = "auto"           # auto | scan | kernel (xla | pallas aliases)
    target_network_update_freq: int = 1
    polyak: float = 0.01
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
class RecQRunnerState:
    params: Any                  # {"q": rnn, ["mixer": hypernet]}
    target_params: Any
    opt_state: Any
    ring: Union[EpisodeBuffer, SequenceBuffer]
    acc: Union[EpisodeAccumulator, SequenceAccumulator]
    env_state: Any
    obs: torch.Tensor
    state: torch.Tensor
    avail: torch.Tensor
    h: torch.Tensor              # (num_envs, n_agents, H)
    stats: EpisodeStats
    step: int                    # vectorized iterations (host counters below)
    episodes: int                # completed episodes: the episode-replay clock
    update_debt: int             # due updates deferred by max_updates_per_iter
    last_loss: torch.Tensor
    last_gnorm: torch.Tensor
    num_updates: int
    generator: torch.Generator

    def replace(self, **kw) -> "RecQRunnerState":
        return dataclasses.replace(self, **kw)


def check_config(cfg: RecurrentQConfig) -> None:
    """The JAX package's guards, with its messages."""
    if cfg.mixing not in ("vdn", "qmix"):
        raise ValueError(f"--mixing must be 'vdn' or 'qmix', got {cfg.mixing!r}")
    if cfg.replay not in ("episode", "sequence"):
        raise ValueError(f"--replay must be 'episode' or 'sequence', got {cfg.replay!r}")
    if cfg.replay == "sequence":
        if cfg.mixing != "vdn":
            raise ValueError(
                "--replay sequence supports --mixing vdn only: the QMIX mixer needs "
                "whole padded episodes (reference qmix_lstm.py uses episode replay + "
                "TBPTT; sequence chunks are vdn_lstm.py's storage model)")
        if not 0 <= cfg.burn_in < cfg.seq_length:
            raise ValueError(
                f"--burn_in must satisfy 0 <= burn_in < seq_length, got "
                f"burn_in={cfg.burn_in} seq_length={cfg.seq_length}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32|bfloat16, got {cfg.compute_dtype!r}")
    if cfg.gru_impl not in ("auto", "xla", "pallas", "scan", "kernel"):
        raise ValueError(f"gru_impl must be auto|scan|kernel (or xla|pallas), "
                         f"got {cfg.gru_impl!r}")
    if cfg.gru_impl in ("pallas", "kernel") and cfg.tbptt:
        raise ValueError(f"gru_impl={cfg.gru_impl!r} does not support tbptt>0")
    if cfg.gru_impl in ("pallas", "kernel") and cfg.compute_dtype == "bfloat16":
        raise ValueError(f"gru_impl={cfg.gru_impl!r} with compute_dtype='bfloat16' is "
                         f"not supported (the kernels' recurrent matmul is float32)")


def make_train(cfg: RecurrentQConfig, env=None):
    """→ (init, train_block, eval_fn, meta). ``meta["update"]`` (episode
    replay) and ``meta["update_seq"]`` (sequence replay) are one gradient
    step on an already sampled batch; ``meta["train_iter"]`` is one
    iteration, ``meta["act_iter"]`` followed by ``meta["update_iter"]``."""
    check_config(cfg)
    device = resolve_device(cfg.device)
    use_seq = cfg.replay == "sequence"
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
    n, A, H = env.n_agents, env.n_actions, cfg.hidden_dim
    use_mixer = cfg.mixing == "qmix"
    mm_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    gru_impl = nets.resolve_gru_impl(cfg.gru_impl, H, tbptt=cfg.tbptt,
                                     bf16=mm_dtype is not None, device=device)

    def mix(params, agent_qs, state):
        """Team value from per-agent values."""
        if use_mixer:
            return nets.mixer_apply(params["mixer"], agent_qs, state)
        return agent_qs.sum(dim=-1)

    def example_record():
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)
        return {"obs": z(n, env.obs_dim), "state": z(env.state_dim),
                "action": z(n, dtype=torch.int64), "reward": z(),
                "done": z(dtype=torch.bool), "next_obs": z(n, env.obs_dim),
                "next_state": z(env.state_dim), "next_avail": z(n, A, dtype=torch.bool)}

    def init(generator: torch.Generator) -> RecQRunnerState:
        params = {"q": nets.rnn_init(generator, env.obs_dim, H, A, device=device)}
        if use_mixer:
            params["mixer"] = nets.mixer_init(generator, n, env.state_dim, cfg.embed_dim,
                                              cfg.hyper_dim, device=device)
        env_state, ts = vec.reset(generator)
        if use_seq:
            ring = SequenceBuffer.create(cfg.buffer_size, cfg.seq_length, example_record(),
                                         rank, world)
            acc = SequenceAccumulator.create(N, cfg.seq_length, example_record())
        else:
            ring = EpisodeBuffer.create(cfg.buffer_size, env.episode_limit,
                                        example_record(), rank, world)
            acc = EpisodeAccumulator.create(N, env.episode_limit, example_record())
        zero = torch.zeros((), device=device)
        return RecQRunnerState(
            params=params, target_params=tree_map(torch.clone, params),
            opt_state=opt.init(params), ring=ring, acc=acc, env_state=env_state,
            obs=ts.obs, state=ts.state, avail=ts.avail,
            h=nets.rnn_initial_state((N, n), H, device),
            stats=EpisodeStats.create(N, device), step=0, episodes=0,
            update_debt=0, last_loss=zero, last_gnorm=zero.clone(), num_updates=0,
            generator=generator)

    def time_major(batch):
        """(B, T, ...) → (T, B, ...), made contiguous once: every sequence
        recompute below then reads it without a copy of its own."""
        return tree_map(lambda x: x.movedim(0, 1).contiguous(), batch)

    def step_params(params, opt_state, loss_fn):
        with span("rq.td_grad"):
            loss, _, grads = value_and_grad(loss_fn, params)
        grads, (loss,) = dp.all_reduce_sum([grads, [loss]])
        with torch.no_grad():
            gnorm = nets.global_norm(grads)
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, gnorm

    def update(params, target_params, opt_state, batch, mask):
        """One TD step on sampled episodes ``batch`` (B, T_max, ...) with
        step ``mask`` (B, T_max), this rank's rows of the sampled batch →
        (params, opt_state, loss, grad norm). Counts the sampled steps
        (``rq.valid_steps``, on the device) and the padded rows they lie
        in (``rq.padded_steps``)."""
        with span("rq.update"):
            count("rq.valid_steps", mask)
            count("rq.padded_steps", mask.numel())
            with torch.no_grad(), span("rq.target"):
                tm = time_major(batch)
                mask_tm = mask.t()
                reward, n_valid = masked_count(tm["reward"], mask_tm, cfg.normalize_reward)
                h0 = nets.rnn_initial_state(tm["obs"].shape[1:3], H, device)
                q_next = nets.rnn_seq_eval_next(target_params["q"], h0, tm["obs"],
                                                tm["next_obs"], dtype=mm_dtype, impl=gru_impl)
                q_next_max = nets.masked_q(q_next, tm["next_avail"]).max(dim=-1).values
                team_next = mix(target_params, q_next_max, tm["next_state"])   # (T, B)
                target = reward + cfg.gamma * (1.0 - tm["done"].float()) * team_next

            def loss_fn(p):
                _, q = nets.rnn_seq_apply(p["q"], h0, tm["obs"], tbptt=cfg.tbptt,
                                          dtype=mm_dtype, impl=gru_impl)
                q_taken = torch.gather(q, -1, tm["action"][..., None])[..., 0]  # (T, B, n)
                team = mix(p, q_taken, tm["state"])
                err = torch.square(target - team) * mask_tm
                return torch.sum(err) / n_valid, ()

            return step_params(params, opt_state, loss_fn)

    def update_seq(params, target_params, opt_state, batch):
        """One TD step on sampled chunks ``batch`` (B, L, ...), this rank's
        rows of the sampled batch: zero-start
        hidden states warmed over the first ``burn_in`` steps without
        gradient, the VDN TD loss on the rest → (params, opt_state, loss,
        grad norm)."""
        bi = cfg.burn_in
        with span("rq.update"):
            with torch.no_grad(), span("rq.target"):
                tm = time_major(batch)
                reward = tm["reward"]
                if cfg.normalize_reward:
                    reward = standardize(reward)
                h_t = h_u = nets.rnn_initial_state(tm["obs"].shape[1:3], H, device)
                if bi:
                    # target stream on next_obs, online stream on obs; on the
                    # kernel route each is one K2 forward, read at h_final
                    h_t = nets.rnn_seq_apply(target_params["q"], h_t, tm["next_obs"][:bi],
                                             dtype=mm_dtype, impl=gru_impl)[0]
                    h_u = nets.rnn_seq_apply(params["q"], h_u, tm["obs"][:bi],
                                             dtype=mm_dtype, impl=gru_impl)[0]
                _, q_next = nets.rnn_seq_apply(target_params["q"], h_t, tm["next_obs"][bi:],
                                               dtype=mm_dtype, impl=gru_impl)
                q_next_max = nets.masked_q(q_next, tm["next_avail"][bi:]).max(dim=-1).values
                done = tm["done"][bi:].float()
                target = reward[bi:] + cfg.gamma * (1.0 - done) * q_next_max.sum(dim=-1)

            def loss_fn(p):
                _, q = nets.rnn_seq_apply(p["q"], h_u, tm["obs"][bi:], dtype=mm_dtype,
                                          impl=gru_impl)
                q_taken = torch.gather(q, -1, tm["action"][bi:][..., None])[..., 0]
                return dp.mean_share(torch.square(target - q_taken.sum(dim=-1))), ()

            return step_params(params, opt_state, loss_fn)

    def act_iter(runner: RecQRunnerState):
        """One env step of the batch and its record in the ring → (runner,
        episodes ended, epsilon)."""
        gen = runner.generator
        epsilon = linear_schedule(cfg.start_e, cfg.end_e, eps_duration,
                                  runner.step * cfg.num_envs)
        with torch.no_grad():
            with span("rq.act"):
                h2, q = nets.rnn_apply(runner.params["q"], runner.h, runner.obs)
                actions = eps_greedy(gen, q, runner.avail, epsilon)
            env_state, ts2, final = vec.step(runner.env_state, actions, gen)
            ended = torch.logical_or(ts2.done, ts2.truncated)
            h2 = torch.where(ended[:, None, None], 0.0, h2)
            record = {"obs": runner.obs, "state": runner.state, "action": actions,
                      "reward": ts2.reward,
                      "done": ts2.done if cfg.bootstrap_truncation else ended,
                      "next_obs": final.obs, "next_state": final.state,
                      "next_avail": final.avail.bool()}
            if use_seq:
                _, n_ended = runner.acc.add_step(runner.ring, record, ended)   # host sync
            else:
                n_ended = runner.acc.add_step(runner.ring, record, ended)      # host sync
            stats = runner.stats.step(
                ts2.reward, ended, ts2.info.get("battle_won", torch.zeros_like(ts2.reward)))
        runner = runner.replace(env_state=env_state, obs=ts2.obs, state=ts2.state,
                                avail=ts2.avail, h=h2, stats=stats, step=runner.step + 1,
                                episodes=runner.episodes + n_ended)
        return runner, n_ended, epsilon

    def update_iter(runner: RecQRunnerState, n_ended: int) -> RecQRunnerState:
        """The updates that ``act_iter``'s step (which ended ``n_ended``
        episodes) makes due, the debt, and the target step → runner."""
        gen = runner.generator
        step, episodes = runner.step, runner.episodes
        due = 0
        if runner.ring.size >= cfg.batch_size:
            if use_seq:
                # one update every train_freq iterations (the reference's
                # env-step cadence, scaled by the env batch)
                due = int(step % max(cfg.train_freq, 1) == 0)
            else:
                # one update per train_freq completed episodes: a batch of
                # envs may finish several in one iteration
                due = episodes // cfg.train_freq - (episodes - n_ended) // cfg.train_freq
        n_run, debt = cadence.bounded_due(runner.update_debt, due, n_slots)
        params, opt_state = runner.params, runner.opt_state
        loss, gnorm = runner.last_loss, runner.last_gnorm
        for _ in range(n_run):
            if use_seq:
                params, opt_state, loss, gnorm = update_seq(
                    params, runner.target_params, opt_state,
                    runner.ring.sample(gen, cfg.batch_size))
            else:
                params, opt_state, loss, gnorm = update(
                    params, runner.target_params, opt_state,
                    *runner.ring.sample(gen, cfg.batch_size))
        # k Polyak steps in a row are one step with τ = 1 − (1 − τ)^k
        # (float32, as the JAX package computes it)
        due_t = cadence.target_due(runner.num_updates, n_run, cfg.train_freq,
                                   cfg.target_network_update_freq)
        target_params = runner.target_params
        if due_t > 0:
            tau = float(np.float32(1.0) - np.float32(1.0 - cfg.polyak) ** np.float32(due_t))
            with torch.no_grad():
                target_params = nets.soft_update(target_params, params, tau)
        return runner.replace(
            params=params, target_params=target_params, opt_state=opt_state,
            update_debt=debt, last_loss=loss, last_gnorm=gnorm,
            num_updates=runner.num_updates + n_run)

    def train_iter(runner: RecQRunnerState):
        """One env step of the batch, its record, and the updates and
        target step it makes due. → (runner, epsilon)."""
        runner, n_ended, epsilon = act_iter(runner)
        return update_iter(runner, n_ended), epsilon

    def scalar(x):
        return torch.tensor(float(x), device=device)

    def train_block(runner: RecQRunnerState):
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
        h2, q = nets.rnn_apply(params["q"], carry, obs)
        return h2, masked_argmax(q, avail)

    eval_fn = make_evaluator(env, cfg.num_eval_ep, greedy_policy,
                             init_carry=lambda m: nets.rnn_initial_state((m, n), H, device))
    meta = {"update": update, "update_seq": update_seq, "train_iter": train_iter,
            "act_iter": act_iter, "update_iter": update_iter,
            "steps_per_block": cfg.num_envs * cfg.log_interval, "gru_impl": gru_impl,
            "local_envs": N}
    return init, train_block, eval_fn, meta


def train(cfg: RecurrentQConfig, env=None, logger=None):
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
        "VDN-RNN" if cfg.mixing == "vdn" else "QMIX-RNN", cfg, init, train_block, eval_fn,
        steps_per_block=meta["steps_per_block"],
        eval_params=lambda r: r.params,
        steps_of=lambda r: r.step * cfg.num_envs,
        print_keys=("rollout/ep_reward", "train/loss"),
        logger=logger,
        data_field_dims=dp.DATA_FIELD_DIMS["RECURRENT_Q"],
    )


def main(argv=None):
    from cleanmarl_tpu_torch.core.cli import cli

    train(cli(RecurrentQConfig, argv, description=__doc__))


if __name__ == "__main__":
    main()
