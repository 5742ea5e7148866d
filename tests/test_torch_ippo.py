"""Port parity: IPPO of ``cleanmarl_tpu_torch`` (``algos/ippo.py``, the
decentralized obs-input critic of ``ppo_common``) against the JAX package,
and COMA with per-agent LBF rewards.

- one ``ppo_update`` against the JAX package's own (reached through
  ``meta["phase_timer"]``'s closure, no edit to the JAX package), from
  copied params and Adam states and one numpy-made trajectory: FF on
  pursuit (8 agents) and on LBF with the normalising options, GRU on LBF
  on the scan route and on the kernel route (whose CPU path runs the
  kernels' plain versions); the 7 ``train/*`` metrics and every new param
  at rtol=atol=1e-5;
- the λ-return kernel's inputs on this path: the team reward and end flag
  broadcast over the agents reach it as their (T, N) bases (R = agents)
  and the per-agent values as they are (R = 1), none copied;
- the critic reads obs (IPPO) or state (MAPPO); the JAX package's IPPO
  learning test on the matrix game at its config and threshold; the CLI;
- COMA with ``per_agent_rewards`` on LBF: one update against the JAX
  package's own ``update`` (reached through ``train_block``'s closures),
  FF and GRU, at 1e-5; one ``collect_rollout`` at the ``coma_lbf`` and
  ``coma_rnn_lbf`` widths against the JAX package's own (its resets and
  action draws fed in): the ε-mixture probabilities at 1e-5, the stored
  per-agent rewards, flags, terminal views and runner at 1e-6; and a
  train block as ``tests/test_coma.py:76``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.algos import coma as jcoma
from cleanmarl_tpu.algos import ippo as jippo
from cleanmarl_tpu.algos.ppo_common import PPOConfig as JaxPPOConfig
from cleanmarl_tpu.envs.lbf import LBF as JLBF
from cleanmarl_tpu_torch.algos import coma, ippo, mappo, ppo_common
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_leaves, tree_map,
)
from cleanmarl_tpu_torch.envs import registry
from cleanmarl_tpu_torch.envs.base import state_from_numpy
from cleanmarl_tpu_torch.envs.lbf import LBF, LBFState
from cleanmarl_tpu_torch.ops import returns_kernel

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T, N, H = 10, 8, 16
LBF_NAME = "Foraging-8x8-2p-3f-v3"

CASES = {
    "ff_pursuit": dict(env_type="pursuit", recurrent=False, normalize_advantage=True),
    "ff_lbf_levers": dict(env_type="lbf", env_name=LBF_NAME, recurrent=False,
                          normalize_advantage=True, normalize_values=True,
                          anneal_entropy=True, clip_gradients=0.5, entropy_coef=0.01),
    "gru_scan_lbf": dict(env_type="lbf", env_name=LBF_NAME, recurrent=True,
                         normalize_advantage=True, normalize_reward=True),
    "gru_kernel_route_lbf": dict(env_type="lbf", env_name=LBF_NAME, recurrent=True,
                                 gru_impl="pallas", normalize_return=True, anneal_lr=True),
}


def closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


def _trajectory(env, rng):
    n, A = env.n_agents, env.n_actions
    avail = np.ones((T, N, n, A), bool)
    action = rng.randint(0, A, (T, N, n))
    return {
        "obs": rng.randn(T, N, n, env.obs_dim).astype(np.float32),
        "state": rng.randn(T, N, env.state_dim).astype(np.float32),
        "avail": avail,
        "action": action.astype(np.int32),
        "logp": (-np.log(A) + 0.1 * rng.randn(T, N, n)).astype(np.float32),
        "reward": rng.rand(T, N).astype(np.float32),
        "ended": rng.rand(T, N) < 0.1,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_ippo_update_matches_jax(case):
    kw = dict(num_envs=N, rollout_len=T, actor_hidden_dim=H, critic_hidden_dim=H, epochs=2,
              num_minibatches=2, total_timesteps=10 * T * N, seed=0, verbose=False,
              **CASES[case])
    jinit, _, _, jmeta = jippo.make_train(JaxPPOConfig(**kw))
    j_update = closure(jmeta["phase_timer"])["ppo_update"]
    tinit, _, _, tmeta = ippo.make_train(PPOConfig(**kw, device="cpu"))
    assert tmeta["algo_name"] == "IPPO"

    rng = np.random.RandomState(len(case))
    tenv = registry.make(kw["env_type"], kw.get("env_name", ""), agent_ids=True, device="cpu")
    runner_j = jinit(jax.random.PRNGKey(0))
    traj = _trajectory(tenv, rng)
    boot_obs = rng.randn(N, tenv.n_agents, tenv.obs_dim).astype(np.float32)
    boot_state = rng.randn(N, tenv.state_dim).astype(np.float32)
    h0 = (0.3 * rng.randn(N, tenv.n_agents, H)).astype(np.float32)
    runner_j = runner_j.replace(obs=jnp.asarray(boot_obs), state=jnp.asarray(boot_state))
    out_j, m_j = j_update(runner_j, jax.tree.map(jnp.asarray, traj), jnp.asarray(h0))

    runner_t = tinit(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(np_tree(runner_j.actor_params), "cpu"),
        critic_params=from_numpy_tree(np_tree(runner_j.critic_params), "cpu"),
        actor_opt=opt_state_from_numpy(np_tree(runner_j.actor_opt), "cpu"),
        critic_opt=opt_state_from_numpy(np_tree(runner_j.critic_opt), "cpu"),
        obs=torch.as_tensor(boot_obs), state=torch.as_tensor(boot_state),
        vnorm=from_numpy_tree(np_tree(runner_j.vnorm), "cpu"))
    # the critic is per agent: its first layer reads the obs
    assert runner_t.critic_params["layers"][0]["w"].shape[0] == tenv.obs_dim
    traj_t = {k: torch.as_tensor(v) for k, v in traj.items()}
    traj_t["action"] = traj_t["action"].long()
    out_t, m_t = tmeta["ppo_update"](runner_t, traj_t, torch.as_tensor(h0))

    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL, err_msg=k)
    for which in ("actor_params", "critic_params"):
        want = jax.tree.leaves(getattr(out_j, which))
        got = tree_leaves(getattr(out_t, which))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=which)
    assert out_t.num_updates == int(out_j.num_updates)


def test_returns_read_the_team_reward_in_place(monkeypatch):
    """On IPPO's update the λ-returns see the team reward and end flag as
    (T, N) bases broadcast over the agents and the per-agent values as
    they are: the kernel's view takes no copy."""
    seen = []
    real = ppo_common.lambda_advantages

    def spy(reward, ended, values, boot, gamma, lam):
        (r, e, v, b), Rr, Rv = returns_kernel.kernel_args(reward, ended, values, boot)
        seen.append((Rr, Rv, r.data_ptr() == traj["reward"].data_ptr(),
                     e.data_ptr() == traj["ended"].data_ptr(),
                     v.data_ptr() == values.data_ptr(), tuple(values.shape)))
        return real(reward, ended, values, boot, gamma, lam)
    monkeypatch.setattr(ppo_common, "lambda_advantages", spy)
    cfg = PPOConfig(env_type="lbf", env_name=LBF_NAME, num_envs=4, rollout_len=6,
                    actor_hidden_dim=8, critic_hidden_dim=8, epochs=1, device="cpu")
    init, _, _, meta = ippo.make_train(cfg)
    runner, traj, h0 = meta["collect_rollout"](init(torch.Generator().manual_seed(0)))
    meta["ppo_update"](runner, traj, h0)
    assert seen == [(2, 1, True, True, True, (6, 4, 2))]


def test_critic_reads_obs_for_ippo_and_state_for_mappo():
    cfg = PPOConfig(env_type="matrix", num_envs=2, critic_hidden_dim=8, device="cpu")
    env = registry.make("matrix", "", agent_ids=True, device="cpu")
    r_i = ippo.make_train(cfg)[0](torch.Generator().manual_seed(0))
    r_m = mappo.make_train(cfg)[0](torch.Generator().manual_seed(0))
    assert r_i.critic_params["layers"][0]["w"].shape[0] == env.obs_dim
    assert r_m.critic_params["layers"][0]["w"].shape[0] == env.state_dim


def test_ippo_learns_matrix_game():
    """``tests/test_ppo.py::test_ippo_learns_matrix_game`` at its config
    and threshold (≥ 85 % of the optimum 8, sampled policy)."""
    from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

    cfg = PPOConfig(env_type="matrix", num_envs=16, total_timesteps=60_000,
                    learning_rate_actor=3e-3, learning_rate_critic=3e-3, entropy_coef=0.01,
                    epochs=3, log_interval=4, num_eval_ep=8, seed=0, verbose=False,
                    device="cpu")
    env = MatrixGame(n_agents=2, n_actions=3, episode_limit=8, device="cpu")
    init, train_block, eval_fn, meta = ippo.make_train(cfg, env)
    runner = init(torch.Generator().manual_seed(0))
    for _ in range(cfg.total_timesteps // meta["steps_per_block"]):
        runner, metrics = train_block(runner)
    out = to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))
    assert out["eval/ep_reward"] > 6.8, out


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    runner, _ = ippo.main(["--env_type", "lbf", "--env_name", LBF_NAME, "--device", "cpu",
                           "--recurrent", "true", "--num_envs", "4", "--rollout_len", "10",
                           "--log_interval", "2", "--total_timesteps", "160",
                           "--eval_steps", "80", "--num_eval_ep", "2",
                           "--actor_hidden_dim", "8", "--critic_hidden_dim", "8"])
    out = capsys.readouterr().out
    assert "[IPPO] step=80" in out and "[IPPO] eval step=160 ep_reward=" in out
    assert runner.num_updates == 4 * 3 and "gru" in runner.actor_params
    assert any(p.name.startswith("IPPO-lbf") for p in (tmp_path / "runs").iterdir())


# ---------------------------------------------------------------------------
# COMA with per-agent LBF rewards
# ---------------------------------------------------------------------------

COMA_SMALL = dict(actor_hidden_dim=H, critic_hidden_dim=H, learning_rate_actor=3e-3,
                  learning_rate_critic=3e-3, entropy_coef=0.05)
# the coma_lbf recipe's widths and options (scripts/validate_baselines.py:442-455)
COMA_LBF = dict(actor_hidden_dim=64, critic_hidden_dim=128, learning_rate_actor=1e-4,
                learning_rate_critic=3e-4, entropy_coef=0.003, exploration_fraction=3000.0,
                anneal_lr=True, bootstrap_truncation=True)
COMA_CASES = {"ff": COMA_SMALL,
              "gru_normalize_reward": dict(COMA_SMALL, recurrent=True, normalize_reward=True),
              "coma_lbf_recipe": COMA_LBF}


@pytest.mark.parametrize("case", sorted(COMA_CASES))
def test_coma_per_agent_rewards_update_matches_jax(case):
    """At the recipe's widths too, with its truncation bootstrap: the
    terminal observations' actions are the JAX update's own draw (from its
    runner key), passed to the port's update."""
    kw = dict(env_type="lbf", num_envs=N, rollout_len=T, total_timesteps=10 * T * N,
              per_agent_rewards=True, seed=0, **COMA_CASES[case])
    Ha = kw["actor_hidden_dim"]
    env_kw = dict(grid_size=6, n_agents=2, n_foods=2, time_limit=20)
    jenv, tenv = JLBF(**env_kw), LBF(**env_kw, device="cpu")
    jinit, jblock, _, _ = jcoma.make_train(jcoma.COMAConfig(**kw), jenv)
    j_update = closure(closure(jblock.__wrapped__)["rollout_and_update"])["update"]
    runner_j = jinit(jax.random.PRNGKey(1))
    n, A = tenv.n_agents, tenv.n_actions
    rng = np.random.RandomState(len(case))
    traj = {"obs": rng.randn(T, N, n, tenv.obs_dim).astype(np.float32),
            "state": rng.randn(T, N, tenv.state_dim).astype(np.float32),
            "avail": np.ones((T, N, n, A), bool),
            "action": rng.randint(0, A, (T, N, n)).astype(np.int32),
            # sparse per-agent food shares, as LBF pays them
            "reward": (rng.rand(T, N, n) * (rng.rand(T, N, n) < 0.2)).astype(np.float32),
            "ended": rng.rand(T, N) < 0.15}
    a_last = None
    if kw.get("bootstrap_truncation"):
        traj.update(trunc_only=traj["ended"] & (rng.rand(T, N) < 0.7),
                    final_obs=rng.randn(T, N, n, tenv.obs_dim).astype(np.float32),
                    final_state=rng.randn(T, N, tenv.state_dim).astype(np.float32),
                    final_avail=np.ones((T, N, n, A), bool))
        # coma.py:316-323: the draw the JAX update makes from its runner key
        pi_last = closure(j_update)["actor_probs"](
            runner_j.actor_params, jnp.asarray(traj["final_obs"]),
            jnp.asarray(traj["final_avail"]), 0.3)
        a_last = np.array(jax.random.categorical(
            jax.random.split(runner_j.key)[1], jnp.log(pi_last + 1e-10)))
    live = {"obs": rng.randn(N, n, tenv.obs_dim).astype(np.float32),
            "state": rng.randn(N, tenv.state_dim).astype(np.float32),
            "avail": np.ones((N, n, A), bool),
            "actor_h": (0.5 * rng.randn(N, n, Ha) * kw.get("recurrent", False)).astype(
                np.float32)}
    h0 = (0.5 * rng.randn(N, n, Ha)).astype(np.float32)
    runner_j = runner_j.replace(**{k: jnp.asarray(v) for k, v in live.items()})
    out_j, m_j = j_update(runner_j, jax.tree.map(jnp.asarray, traj), jnp.asarray(h0), 0.3)

    init, _, _, meta = coma.make_train(coma.COMAConfig(**kw, device="cpu"), tenv)
    runner = init(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(np_tree(runner_j.actor_params), "cpu"),
        critic_params=from_numpy_tree(np_tree(runner_j.critic_params), "cpu"),
        target_critic=from_numpy_tree(np_tree(runner_j.target_critic), "cpu"),
        actor_opt=opt_state_from_numpy(np_tree(runner_j.actor_opt), "cpu"),
        critic_opt=opt_state_from_numpy(np_tree(runner_j.critic_opt), "cpu"),
        **{k: torch.as_tensor(v) for k, v in live.items()})
    traj_t = {k: torch.as_tensor(v) for k, v in traj.items()}
    traj_t["action"] = traj_t["action"].long()
    out_t, m_t = meta["update"](runner, traj_t, torch.as_tensor(h0), 0.3,
                                None if a_last is None else torch.as_tensor(a_last).long())
    for k in m_t:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL, err_msg=k)
    for which in ("actor_params", "critic_params", "target_critic"):
        tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=which),
                 getattr(out_t, which), np_tree(getattr(out_j, which)))


ROLLOUT_CASES = {"coma_lbf_recipe": COMA_LBF,
                 "coma_rnn_lbf_recipe": dict(COMA_LBF, recurrent=True,
                                             bootstrap_truncation=False)}


@pytest.mark.parametrize("case", sorted(ROLLOUT_CASES))
def test_coma_per_agent_rewards_rollout_matches_jax(case, monkeypatch):
    """One ``collect_rollout`` on LBF against the JAX package's own, from
    the same params, env states and carry, at the recipe's widths: the
    port's env resets are the JAX rollout's (its reset keys replayed) and
    its action draws are the JAX actions, so the ε-mixture probabilities
    (as the logits handed to the draw), the stored per-agent rewards, the
    end and truncation flags, the terminal (pre-reset) views and the
    runner after the rollout are held at 1e-6 (probabilities at 1e-5)."""
    Tr, Nr, eps = 14, 16, 0.5
    kw = dict(env_type="lbf", num_envs=Nr, rollout_len=Tr, total_timesteps=10 * Tr * Nr,
              per_agent_rewards=True, seed=0, **ROLLOUT_CASES[case])
    env_kw = dict(grid_size=5, n_agents=2, n_foods=3, time_limit=6)
    jenv, tenv = JLBF(**env_kw), LBF(**env_kw, device="cpu")
    jinit, jblock, _, _ = jcoma.make_train(jcoma.COMAConfig(**kw), jenv)
    j_collect = closure(closure(jblock.__wrapped__)["rollout_and_update"])["collect_rollout"]
    j_actor_step = closure(j_collect)["actor_step"]
    runner_j = jinit(jax.random.PRNGKey(3))
    runner_j = runner_j.replace(actor_h=0.5 * jax.random.normal(
        jax.random.PRNGKey(4), runner_j.actor_h.shape) * kw.get("recurrent", False))
    out_j, traj_j, h0_j = jax.jit(j_collect)(runner_j, eps)
    traj_j = np_tree(traj_j)

    # the JAX rollout's reset states, step by step (envs/base.py VecEnv.step)
    resets, key = [], jax.random.split(runner_j.key)[1]
    for _ in range(Tr):
        key, _, k_step = jax.random.split(key, 3)
        reset_keys = jax.random.split(jax.random.split(k_step, Nr + 1)[0], Nr)
        resets.append(_np_state(jax.vmap(jenv.reset)(reset_keys)[0]))

    def fake_reset(num_envs, generator):
        s = state_from_numpy(LBFState, resets.pop(0), "cpu")
        zf, fb = torch.zeros(num_envs), torch.zeros(num_envs, dtype=torch.bool)
        return s, tenv._timestep(s, zf, fb, fb, torch.zeros(num_envs, tenv.n_agents))

    logits = []

    def fed_draw(lg, generator):
        logits.append(lg.clone())
        return torch.tensor(traj_j["action"][len(logits) - 1]).long()

    init, _, _, meta = coma.make_train(coma.COMAConfig(**kw, device="cpu"), tenv)
    runner = init(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(np_tree(runner_j.actor_params), "cpu"),
        env_state=state_from_numpy(LBFState, _np_state(runner_j.env_state), "cpu"),
        **{k: torch.as_tensor(np.array(getattr(runner_j, k)))
           for k in ("obs", "state", "avail", "actor_h")})
    monkeypatch.setattr(tenv, "_reset", fake_reset)
    monkeypatch.setattr(coma, "categorical", fed_draw)
    out, traj, h0 = meta["collect_rollout"](runner, eps)
    assert not resets and len(logits) == Tr

    np.testing.assert_allclose(h0.numpy(), np.asarray(h0_j), atol=1e-6)
    h = runner_j.actor_h
    for t in range(Tr):                    # the JAX policy's probabilities at step t
        h2, probs = j_actor_step(runner_j.actor_params, h, traj_j["obs"][t],
                                 traj_j["avail"][t], eps)
        h = jnp.where(traj_j["ended"][t][:, None, None], 0.0, h2)
        np.testing.assert_allclose(logits[t].numpy(), np.log(np.asarray(probs) + 1e-10),
                                   rtol=1e-5, atol=1e-5, err_msg=f"probabilities, t={t}")
    assert sorted(traj) == sorted(traj_j)
    for k, v in traj.items():
        np.testing.assert_allclose(v.numpy(), traj_j[k], atol=1e-6, err_msg=k)
    assert traj["reward"].shape == (Tr, Nr, 2) and float(traj["reward"].sum()) > 0
    assert bool(traj["ended"].any())
    if kw["bootstrap_truncation"]:
        assert bool(traj["trunc_only"].any())
        assert bool((traj["final_obs"][:-1] != traj["obs"][1:]).any())   # resets inside
    for k in ("obs", "state", "avail", "actor_h"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(out_j, k)),
                                   atol=1e-6, err_msg=k)
    for k in ("player_pos", "player_level", "food_pos", "food_level", "total_food", "t"):
        np.testing.assert_array_equal(getattr(out.env_state, k).numpy(),
                                      np.asarray(getattr(out_j.env_state, k)), err_msg=k)
    for k in ("ep_ret", "ep_len", "ret_sum", "len_sum", "count"):
        np.testing.assert_allclose(getattr(out.stats, k).numpy(),
                                   np.asarray(getattr(out_j.stats, k)), atol=1e-6, err_msg=k)
    assert out.step == int(out_j.step)


def test_coma_per_agent_rewards_trains_on_lbf():
    """``tests/test_coma.py:76``: a train block with per-agent LBF rewards
    stored (T, N, agents), finite critic loss."""
    env = LBF(grid_size=6, n_agents=2, n_foods=2, time_limit=20, device="cpu")
    cfg = coma.COMAConfig(env_type="lbf", num_envs=8, total_timesteps=1280,
                          per_agent_rewards=True, rollout_len=20, log_interval=2, seed=0,
                          verbose=False, device="cpu")
    init, train_block, _, meta = coma.make_train(cfg, env)
    runner = init(torch.Generator().manual_seed(0))
    runner, traj, _ = meta["collect_rollout"](runner, 0.5)
    assert traj["reward"].shape == (20, 8, 2)
    runner, metrics = train_block(runner)
    assert np.isfinite(float(metrics["train/critic_loss"])) and runner.num_updates == 2


def test_unit_collisions_flag_builds_the_collision_env(monkeypatch):
    """``--unit_collisions true`` (the collisions recipe of
    ``scripts/mappo_3m_run.py``) reaches SMAClite through the registry;
    with another env type, or an env passed in, it is refused."""
    seen = []
    real = registry.make

    def spy(*args, **kw):
        env = real(*args, **kw)
        seen.append(env)
        return env
    monkeypatch.setattr(registry, "make", spy)
    mappo.main(["--env_type", "smaclite", "--env_name", "3m", "--device", "cpu",
                "--unit_collisions", "true", "--num_envs", "2", "--rollout_len", "5",
                "--log_interval", "1", "--total_timesteps", "10", "--eval_steps", "10",
                "--num_eval_ep", "1", "--actor_hidden_dim", "8", "--critic_hidden_dim", "8",
                "--verbose", "false"])
    assert len(seen) == 1 and seen[0].env.unit_collisions
    for kw in (dict(env_type="lbf", env_name=LBF_NAME), dict(env_type="smaclite", env_name="3m")):
        env = None if kw["env_type"] == "lbf" else real("smaclite", "3m", device="cpu")
        with pytest.raises(ValueError, match="unit_collisions"):
            ippo.make_train(PPOConfig(**kw, unit_collisions=True, device="cpu"), env)
