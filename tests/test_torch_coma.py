"""Port parity: COMA of ``cleanmarl_tpu_torch`` (``algos/coma.py``) against
the JAX package, on the CPU.

- the critic input [state ‖ own obs ‖ one-hot of the others' actions]
  equals the JAX package's (``coma.py:174-175, 208-219``, the ``jnp.delete``
  index table) exactly; the counterfactual advantage is zero for a Q that
  is constant over actions (``tests/test_coma.py:10``); the ε-mixture
  probabilities equal ``coma.py:178-190``'s at 1e-6;
- one update (``meta["update"]``) against the same update assembled here
  from the JAX package's functions as ``coma.py:293-426`` does, from
  copied params and Adam states, an injected rollout (episode ends inside
  it) and the live state at its cut: losses, entropy, grad norms and new
  params at 1e-5, for the feed-forward actor, the GRU actor from a
  non-zero h0 with resets on the scan route and on the kernel route
  (whose CPU path runs the kernels' plain versions), and the options
  ``use_tdlambda=False, nsteps=3``, ``bootstrap_truncation`` (with the
  sampled action injected), ``normalize_reward``, ``normalize_return``,
  ``critic_epochs=2``, ``anneal_entropy``, ``anneal_lr`` and
  ``clip_gradients``;
- two ``train_block``s on the matrix game against the JAX ``make_train``:
  the JAX metric keys, finite values, ``train/num_updates`` and
  ``rollout/epsilon`` equal; feed-forward, GRU, n-step and
  bootstrap_truncation; one sampled ``eval_fn``;
- the GRU carry is zero after an episode end; the guards' messages
  (``tests/test_coma.py:145-160``); the CLI; the driver options with one
  rank; ``device="cuda"`` raising without a card.

The matrix-game learning tests of ``tests/test_coma.py`` are mirrored
with their configs and thresholds (each run takes seconds on one CPU
worker): GRU, bootstrap_truncation and n-step at the JAX tests' seeds.
Feed-forward COMA's outcome there is seed sensitive (``test_coma.py:34-36``:
seeds 0 and 2 stay at a local optimum in JAX) and torch cannot replay
JAX's RNG streams, so its mirror asks two of the seeds 0, 1 and 2 to
clear the threshold rather than one chosen seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleanmarl_tpu.algos import coma as jcoma
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu.envs.matrix_game import MatrixGame as JMatrixGame
from cleanmarl_tpu.ops.returns import lambda_returns as jlambda_returns
from cleanmarl_tpu.ops.returns import nstep_returns as jnstep_returns
from cleanmarl_tpu_torch.algos import coma
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_map,
)
from cleanmarl_tpu_torch.envs import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def assert_tree_close(port_tree, np_tree_, **tol):
    """Leaf by leaf, matched by key (the JAX tree's dict order differs)."""
    tree_map(lambda a, b: np.testing.assert_allclose(a.detach().numpy(), b, **tol),
             port_tree, np_tree_)


def jax_critic_input(state, obs, actions, n, A):
    """``coma.py:174-175, 212-218``."""
    idx = jnp.arange(n)
    others = jax.vmap(lambda i: jnp.delete(idx, i, assume_unique_indices=True))(idx)
    onehot = jax.nn.one_hot(actions, A)
    other = onehot[..., others, :]
    other = other.reshape(other.shape[:-2] + ((n - 1) * A,))
    state_b = jnp.broadcast_to(state[..., None, :], state.shape[:-1] + (n, state.shape[-1]))
    return jnp.concatenate([state_b, obs, other], axis=-1)


def jax_eps_mix(logits, avail, epsilon):
    """``coma.py:178-182``."""
    probs = jax.nn.softmax(logits, axis=-1)
    availf = avail.astype(jnp.float32)
    uni = availf / jnp.maximum(availf.sum(-1, keepdims=True), 1.0)
    return (1.0 - epsilon) * probs + epsilon * uni


@pytest.mark.parametrize("n", [2, 3, 5])
def test_critic_input_matches_jax_exactly(n):
    rng = np.random.RandomState(n)
    A, S, O = 4, 7, 6
    state = rng.randn(3, 2, S).astype(np.float32)
    obs = rng.randn(3, 2, n, O).astype(np.float32)
    actions = rng.randint(0, A, (3, 2, n))
    want = np.asarray(jax_critic_input(jnp.asarray(state), jnp.asarray(obs),
                                       jnp.asarray(actions), n, A))
    others = coma.others_index(n)
    assert others.tolist() == [[j for j in range(n) if j != i] for i in range(n)]
    got = coma.critic_input(torch.as_tensor(state), torch.as_tensor(obs),
                            torch.as_tensor(actions), others, A)
    np.testing.assert_array_equal(got.numpy(), want)


def test_counterfactual_advantage_zero_for_uniform_q():
    q = torch.full((4, 2, 3), 5.0)
    pi = torch.softmax(torch.randn(4, 2, 3, generator=torch.Generator().manual_seed(0)), -1)
    adv = coma.counterfactual_advantage(q, pi, torch.zeros(4, 2, dtype=torch.int64))
    np.testing.assert_allclose(adv.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("epsilon", [0.0, 0.25, 1.0])
def test_eps_mix_matches_jax(epsilon):
    rng = np.random.RandomState(2)
    avail = rng.rand(5, 3, 9) < 0.5
    avail[..., 0] = True
    logits = np.where(avail, 2.0 * rng.randn(5, 3, 9), -1e9).astype(np.float32)
    want = np.asarray(jax_eps_mix(jnp.asarray(logits), jnp.asarray(avail), epsilon))
    got = coma.eps_mix(torch.as_tensor(logits), torch.as_tensor(avail), epsilon)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

T, B, H = 10, 4, 16
UPDATE_CASES = {
    "ff": dict(),
    "ff_clip_anneal_lr_no_adv_norm": dict(clip_gradients=0.05, anneal_lr=True,
                                          normalize_advantage=False),
    "ff_nstep3_truncation_normalize_epochs2": dict(
        use_tdlambda=False, nsteps=3, bootstrap_truncation=True, normalize_reward=True,
        normalize_return=True, critic_epochs=2, target_network_update_freq=2),
    "rnn_scan_anneal_entropy": dict(recurrent=True, anneal_entropy=True),
    "rnn_kernel_route_normalize_return": dict(recurrent=True, normalize_return=True,
                                              gru_impl="kernel"),
}


def jax_update(cfg, env, st, traj, h0, live, epsilon, a_last):
    """``coma.py:293-426`` from the JAX package's own functions, on a
    collected rollout; ``a_last`` is the truncation bootstrap's sample."""
    actor_p, critic_p, tgt_critic, a_opt_s, c_opt_s, num_updates = st
    n, A = env.n_agents, env.n_actions
    rollout_len = cfg.rollout_len or env.episode_limit
    total_updates = max(cfg.total_timesteps // (rollout_len * cfg.num_envs), 1)
    n_updates = total_updates if cfg.anneal_lr else 0
    a_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_actor, cfg.clip_gradients,
                            n_updates)
    c_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_critic, cfg.clip_gradients,
                            n_updates * max(1, cfg.critic_epochs))
    lam = cfg.td_lambda if cfg.use_tdlambda else 0.0

    def critic_q(p, state, obs, actions):
        return jnets.mlp_apply(p, jax_critic_input(state, obs, actions, n, A))

    def actor_step(p, h, obs, avail, eps):
        if cfg.recurrent:
            h2, logits = jnets.rnn_apply(p, h, obs)
        else:
            h2, logits = h, jnets.mlp_apply(p, obs)
        return h2, jax_eps_mix(jnets.masked_q(logits, avail), avail, eps)

    def probs_seq(p, obs, avail, ended):
        if not cfg.recurrent:
            return actor_step(p, None, obs, avail, 0.0)[1]
        _, logits = jnets.rnn_seq_apply(p, h0, obs, reset_seq=ended)
        return jax_eps_mix(jnets.masked_q(logits, avail), avail, 0.0)

    def taken(q, a):
        return jnp.take_along_axis(q, a[..., None], axis=-1)[..., 0]

    q_taken_tgt = taken(critic_q(tgt_critic, traj["state"], traj["obs"], traj["action"]),
                        traj["action"])
    _, pi_boot = actor_step(actor_p, live["actor_h"], live["obs"], live["avail"], 0.0)
    a_boot = jnp.argmax(pi_boot, axis=-1).astype(jnp.int32)
    v_boot = jnp.sum(pi_boot * critic_q(tgt_critic, live["state"], live["obs"], a_boot), -1)
    reward = jnp.broadcast_to(traj["reward"][..., None], q_taken_tgt.shape)
    if cfg.normalize_reward:
        reward = jstandardize(reward)
    if cfg.bootstrap_truncation:
        q_last = taken(critic_q(tgt_critic, traj["final_state"], traj["final_obs"], a_last),
                       a_last)
        reward = reward + cfg.gamma * q_last * traj["trunc_only"][..., None].astype(jnp.float32)
    ended = jnp.broadcast_to(traj["ended"][..., None], q_taken_tgt.shape)
    if cfg.use_tdlambda or cfg.nsteps <= 1:
        returns = jlambda_returns(reward, ended, q_taken_tgt, v_boot, cfg.gamma, lam)
    else:
        returns = jnstep_returns(reward, ended, q_taken_tgt, v_boot, cfg.gamma, cfg.nsteps)
    if cfg.normalize_return:
        ret_am = returns.mean(axis=-1)
        returns = (returns - ret_am.mean()) / (ret_am.std() + 1e-8)

    def critic_loss(p):
        q = critic_q(p, traj["state"], traj["obs"], traj["action"])
        return jnp.mean(jnp.square(taken(q, traj["action"]) - returns))

    for _ in range(max(1, cfg.critic_epochs)):
        c_loss, c_grads = jax.value_and_grad(critic_loss)(critic_p)
        c_gnorm = jnets.global_norm(c_grads)
        up, c_opt_s = c_opt.update(c_grads, c_opt_s, critic_p)
        critic_p = optax.apply_updates(critic_p, up)
    q_new = critic_q(critic_p, traj["state"], traj["obs"], traj["action"])
    ent_coef = cfg.entropy_coef
    if cfg.anneal_entropy:
        ent_coef = cfg.entropy_coef * jnp.clip(1.0 - num_updates / total_updates, 0.0, 1.0)

    def actor_loss(p):
        pi = probs_seq(p, traj["obs"], traj["avail"], traj["ended"])
        log_pi = jnp.log(pi + 1e-8)
        adv = jax.lax.stop_gradient(taken(q_new, traj["action"]) - jnp.sum(pi * q_new, -1))
        if cfg.normalize_advantage:
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        entropy = -jnp.sum(pi * log_pi, axis=-1) / A
        return -jnp.mean(taken(log_pi, traj["action"]) * adv) - ent_coef * jnp.mean(entropy), \
            jnp.mean(entropy)

    (a_loss, ent), a_grads = jax.value_and_grad(actor_loss, has_aux=True)(actor_p)
    up, a_opt_s = a_opt.update(a_grads, a_opt_s, actor_p)
    actor_p = optax.apply_updates(actor_p, up)
    num_updates = num_updates + 1.0
    tgt_critic = jax.lax.cond(jnp.mod(num_updates, cfg.target_network_update_freq) == 0,
                              lambda: jnets.soft_update(tgt_critic, critic_p, cfg.polyak),
                              lambda: tgt_critic)
    return ((actor_p, critic_p, tgt_critic, a_opt_s, c_opt_s, num_updates),
            (a_loss, c_loss, ent, jnets.global_norm(a_grads), c_gnorm))


def make_rollout(rng, env, cfg):
    """A rollout with episode ends inside it, its start carry and the live
    state at its cut (numpy)."""
    n, A, O, S = env.n_agents, env.n_actions, env.obs_dim, env.state_dim

    def avail(*lead):
        a = rng.rand(*lead, n, A) < 0.6
        a[..., rng.randint(A)] = True
        return a
    av = avail(T, B)
    traj = {"obs": rng.randn(T, B, n, O).astype(np.float32),
            "state": rng.randn(T, B, S).astype(np.float32), "avail": av,
            "action": (rng.rand(T, B, n, A) * av).argmax(-1),
            "reward": rng.randn(T, B).astype(np.float32),
            "ended": rng.rand(T, B) < 0.2}
    if cfg.bootstrap_truncation:
        traj.update(trunc_only=traj["ended"] & (rng.rand(T, B) < 0.6),
                    final_obs=rng.randn(T, B, n, O).astype(np.float32),
                    final_state=rng.randn(T, B, S).astype(np.float32), final_avail=avail(T, B))
    live = {"obs": rng.randn(B, n, O).astype(np.float32),
            "state": rng.randn(B, S).astype(np.float32), "avail": avail(B),
            "actor_h": (0.5 * rng.randn(B, n, H)).astype(np.float32) * cfg.recurrent}
    h0 = (0.5 * rng.randn(B, n, H)).astype(np.float32)
    a_last = (rng.rand(T, B, n, A) * traj["final_avail"]).argmax(-1) if (
        cfg.bootstrap_truncation) else None
    return traj, h0, live, a_last


def start(cfg, env, seed):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    n, A = env.n_agents, env.n_actions
    if cfg.recurrent:
        actor = jnets.rnn_init(k[0], env.obs_dim, H, A, final_gain=0.01)
    else:
        actor = jnets.mlp_init(k[0], env.obs_dim, H, A, 1, final_gain=0.01)
    critic = jnets.mlp_init(k[1], env.state_dim + env.obs_dim + (n - 1) * A, H, A, 1)
    leaves, tdef = jax.tree.flatten(critic)
    keys = jax.random.split(k[2], len(leaves))
    target = jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(kk, p.shape)
                                       for p, kk in zip(leaves, keys)])
    rollout_len = cfg.rollout_len or env.episode_limit
    n_up = max(cfg.total_timesteps // (rollout_len * cfg.num_envs), 1) if cfg.anneal_lr else 0
    a_opt = jmake_optimizer("adam", cfg.learning_rate_actor, cfg.clip_gradients, n_up)
    c_opt = jmake_optimizer("adam", cfg.learning_rate_critic, cfg.clip_gradients,
                            n_up * max(1, cfg.critic_epochs))
    return (actor, critic, target, a_opt.init(actor), c_opt.init(critic), jnp.zeros(()))


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case, monkeypatch):
    kw = dict(UPDATE_CASES[case])
    gru_impl = kw.pop("gru_impl", "auto")
    if gru_impl == "kernel":
        # the kernel route on CPU tensors: the kernels' plain versions
        monkeypatch.setattr(nets, "resolve_gru_impl", lambda *a, **k: "kernel")
    kw.update(env_type="smaclite", env_name="3m", num_envs=B, rollout_len=T,
              total_timesteps=12 * T * B, actor_hidden_dim=H, critic_hidden_dim=H,
              learning_rate_actor=3e-3, learning_rate_critic=3e-3, entropy_coef=0.05)
    env = treg.make("smaclite", "3m", agent_ids=True, device="cpu")
    jcfg = jcoma.COMAConfig(**kw)
    st = start(jcfg, env, seed=len(case))
    rng = np.random.RandomState(len(case))
    jupdate = jax.jit(functools.partial(jax_update, jcfg, env), static_argnums=(4,))
    jt = lambda d: None if d is None else jax.tree.map(jnp.asarray, d)  # noqa: E731
    r0 = make_rollout(rng, env, jcfg)
    st, _ = jupdate(st, jt(r0[0]), jnp.asarray(r0[1]), jt(r0[2]), 0.3, jt(r0[3]))
    traj, h0, live, a_last = make_rollout(rng, env, jcfg)
    want_st, want = jupdate(st, jt(traj), jnp.asarray(h0), jt(live), 0.3, jt(a_last))

    init, _, _, meta = coma.make_train(coma.COMAConfig(**kw, device="cpu"), env)
    assert meta["gru_impl"] == ({"auto": "scan"}.get(gru_impl, gru_impl)
                                if jcfg.recurrent else None)
    actor, critic, target, a_opt, c_opt, _ = (np_tree(x) for x in st)
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    runner = init(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(actor, "cpu"), critic_params=from_numpy_tree(critic, "cpu"),
        target_critic=from_numpy_tree(target, "cpu"), actor_opt=opt_state_from_numpy(a_opt, "cpu"),
        critic_opt=opt_state_from_numpy(c_opt, "cpu"), num_updates=int(st[5]),
        **{k: torch.as_tensor(v) for k, v in live.items()})
    got_runner, metrics = meta["update"](
        runner, t(traj), torch.as_tensor(h0), 0.3,
        None if a_last is None else torch.as_tensor(a_last))
    keys = ("train/actor_loss", "train/critic_loss", "train/entropy",
            "train/actor_gradients", "train/critic_gradients")
    for k, w in zip(keys, want):
        np.testing.assert_allclose(float(metrics[k]), float(w), **TOL, err_msg=k)
    assert_tree_close(got_runner.actor_params, np_tree(want_st[0]), **TOL)
    assert_tree_close(got_runner.critic_params, np_tree(want_st[1]), **TOL)
    assert_tree_close(got_runner.target_critic, np_tree(want_st[2]), **TOL)
    assert got_runner.num_updates == int(want_st[5]) == 2
    assert got_runner.critic_opt["count"] == 2 * max(1, jcfg.critic_epochs)
    if jcfg.clip_gradients > 0:
        assert float(want[3]) > jcfg.clip_gradients          # the clip acted


def test_update_reads_broadcast_rewards_and_flags_without_copies(monkeypatch):
    """The λ-returns get the team reward and the end flag as views broadcast
    over the agents (stride 0), which the kernel reads without a copy."""
    from cleanmarl_tpu_torch.ops import returns_kernel

    seen = []
    real = coma.lambda_returns

    def spy(reward, ended, values, boot, gamma, lam):
        seen.append((returns_kernel.repeat_base(reward)[1], returns_kernel.repeat_base(ended)[1],
                     returns_kernel.repeat_base(values)[1]))
        return real(reward, ended, values, boot, gamma, lam)
    monkeypatch.setattr(coma, "lambda_returns", spy)
    cfg = coma.COMAConfig(env_type="smaclite", env_name="3m", num_envs=B, rollout_len=T,
                          actor_hidden_dim=H, critic_hidden_dim=H, device="cpu")
    init, _, _, meta = coma.make_train(cfg)
    runner, traj, h0 = meta["collect_rollout"](init(torch.Generator().manual_seed(0)), 0.5)
    assert traj["reward"].shape == (T, B) and traj["ended"].shape == (T, B)
    meta["update"](runner, traj, h0, 0.5)
    assert seen == [(3, 3, 1)]


# ---------------------------------------------------------------------------
# the slice: train blocks, hidden resets, guards, eval, CLI
# ---------------------------------------------------------------------------

TINY = dict(env_type="matrix", num_envs=4, log_interval=2, actor_hidden_dim=8,
            critic_hidden_dim=8, exploration_fraction=5.0, num_eval_ep=2,
            total_timesteps=4 * 8 * 2 * 2, seed=0, verbose=False)
BLOCK_CASES = {"ff": dict(), "recurrent": dict(recurrent=True),
               "nstep3": dict(use_tdlambda=False, nsteps=3),
               "truncation_rollout5": dict(bootstrap_truncation=True, rollout_len=5)}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_train_blocks_match_jax(case):
    kw = dict(TINY, **BLOCK_CASES[case])
    jinit, jblock, jeval, jmeta = jcoma.make_train(jcoma.COMAConfig(**kw), JMatrixGame())
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = coma.make_train(coma.COMAConfig(**kw, device="cpu"))
    assert meta["steps_per_block"] == jmeta["steps_per_block"]
    runner = init(torch.Generator().manual_seed(0))
    for _ in range(2):
        jrunner, jmetrics = jblock(jrunner)
        runner, metrics = train_block(runner)
        host = to_host(metrics)
        assert sorted(host) == sorted(jmetrics)
        assert all(np.isfinite(v) for v in host.values())
        assert host["train/num_updates"] == float(jmetrics["train/num_updates"])
        np.testing.assert_allclose(host["rollout/epsilon"], float(jmetrics["rollout/epsilon"]),
                                   rtol=1e-6)
        assert runner.step == int(jrunner.step)
    assert runner.num_updates == 4
    evals = to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))
    assert sorted(evals) == sorted(jax.eval_shape(jeval, jrunner.actor_params,
                                                  jax.random.PRNGKey(1)))
    assert evals["eval/ep_length"] == 8.0 and all(np.isfinite(v) for v in evals.values())


def test_recurrent_carry_resets_at_episode_end():
    init, _, _, meta = coma.make_train(coma.COMAConfig(**TINY, recurrent=True, rollout_len=5,
                                                       device="cpu"))
    runner = init(torch.Generator().manual_seed(0))
    runner, traj, h0 = meta["collect_rollout"](runner, 0.5)
    assert float(h0.abs().sum()) == 0.0 and float(runner.actor_h.abs().sum()) > 0
    runner, traj, h0 = meta["collect_rollout"](runner, 0.5)
    assert float(h0.abs().sum()) > 0                       # carried into the rollout
    assert traj["ended"][2].all() and not traj["ended"][3].any()   # step 8 of 10
    assert float(runner.actor_h.abs().sum()) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(bootstrap_truncation=True, recurrent=True), "requires a feed-forward actor"),
    (dict(per_agent_rewards=True), r"info\['agent_rewards'\]")],
    ids=["truncation_recurrent", "per_agent_rewards"])
def test_guard_messages_match_jax(kw, match):
    with pytest.raises(ValueError, match=match) as want:
        jcoma.make_train(jcoma.COMAConfig(env_type="matrix", **kw), JMatrixGame())
    with pytest.raises(ValueError, match=match) as got:
        coma.make_train(coma.COMAConfig(env_type="matrix", device="cpu", **kw))
    assert str(got.value) == str(want.value)


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    runner, _ = coma.main(["--env_type", "smaclite", "--env_name", "3m", "--device", "cpu",
                           "--num_envs", "4", "--rollout_len", "10", "--log_interval", "2",
                           "--total_timesteps", "160", "--eval_steps", "80",
                           "--num_eval_ep", "2", "--actor_hidden_dim", "8",
                           "--critic_hidden_dim", "8", "--recurrent", "true"])
    out = capsys.readouterr().out
    assert "[COMA] step=80" in out and "[COMA] step=160" in out
    assert "[COMA] eval step=160 ep_reward=" in out
    assert runner.num_updates == 4 and "gru" in runner.actor_params
    assert any(p.name.startswith("COMA-smaclite__3m") for p in (tmp_path / "runs").iterdir())


@pytest.mark.parametrize("option", [dict(checkpoint_dir="ckpt"), dict(use_mesh=True),
                                    dict(profile_dir="prof"), dict(num_processes=2)],
                         ids=["checkpoint", "mesh", "profile", "multiprocess"])
def test_unported_driver_options_raise(option, tmp_path, monkeypatch):
    """The driver options that raised before they were ported now run for
    COMA with one rank: the checkpoint leaves the final step's directory,
    the profile a trace, ``use_mesh`` on the CPU does nothing, and
    ``num_processes`` without a coordinator runs one process, as in the
    JAX package. What still raises is an off-policy family with more than
    one rank (the same test in their files); COMA's 2-rank path is held
    in ``tests/test_torch_distributed.py``."""
    monkeypatch.chdir(tmp_path)
    runner, _ = coma.train(coma.COMAConfig(**TINY, device="cpu", **option))
    assert runner.step == TINY["total_timesteps"]
    if "checkpoint_dir" in option:
        assert (tmp_path / "ckpt" / str(TINY["total_timesteps"])).is_dir()
    if "profile_dir" in option:
        assert any((tmp_path / "prof").iterdir())


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coma.main(["--env_type", "matrix"])


# ---------------------------------------------------------------------------
# learning on the matrix game (tests/test_coma.py:21-189)
# ---------------------------------------------------------------------------

LEARN = dict(env_type="matrix", num_envs=16, total_timesteps=80_000, learning_rate_actor=2e-3,
             learning_rate_critic=3e-3, entropy_coef=0.003, td_lambda=0.8,
             exploration_fraction=100.0, polyak=0.05, log_interval=4, num_eval_ep=8,
             verbose=False, device="cpu")


def learned_reward(seed, **kw):
    cfg = coma.COMAConfig(**dict(LEARN, **kw), seed=seed)
    init, train_block, eval_fn, meta = coma.make_train(cfg)
    runner = init(torch.Generator().manual_seed(seed))
    for _ in range(cfg.total_timesteps // meta["steps_per_block"]):
        runner, _ = train_block(runner)
    return to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))[
        "eval/ep_reward"]


def test_coma_learns_matrix_game():
    rewards = [learned_reward(seed) for seed in (0, 1, 2)]
    assert sum(r > 6.8 for r in rewards) >= 2, rewards


@pytest.mark.parametrize("kw,seed,threshold", [
    (dict(recurrent=True, total_timesteps=60_000), 0, 5.0),
    (dict(bootstrap_truncation=True), 0, 6.8),
    (dict(use_tdlambda=False, nsteps=3, total_timesteps=40_000, learning_rate_actor=3e-3), 1,
     5.5)], ids=["recurrent", "bootstrap_truncation", "nstep3"])
def test_coma_variants_learn_matrix_game(kw, seed, threshold):
    reward = learned_reward(seed, **kw)
    assert reward > threshold, reward
