"""Port parity: FACMAC of ``cleanmarl_tpu_torch`` (``algos/facmac.py``)
against the JAX package, on the CPU.

- the ε-mixture probabilities (``eps_mixture_probs``) against the JAX
  formula of ``facmac.py:149-157`` on the noise ``jax.random.gumbel``
  draws from the same key, at 1e-6; the sampler never picks an
  unavailable action;
- one update (``meta["update"]``) against the same update assembled here
  from the JAX package's functions as ``facmac.py:209-256`` does, from
  copied params (the critic is the dict ``{"q", "mixer"}``) and both Adam
  states, an injected batch and the Gumbel noise the JAX keys draw:
  losses, grad norms and new params at 1e-5, plain and with
  ``normalize_reward`` and ``clip_gradients``;
- two ``train_block``s on speaker-listener against the JAX
  ``make_train``: the JAX metric keys, finite values, and
  ``train/num_updates``, ``train/update_debt`` and ``rollout/epsilon``
  (ε runs on the update clock) equal, uncapped and capped; one
  ``eval_fn``; the CLI; the driver options over 2 gloo ranks (checkpoint and
  resume, profile, ``num_processes``) and ``use_mesh``'s spawn, mocked.

The JAX learning test (``tests/test_facmac.py:8``, 40,000 env steps with
an update per completed episode) is not mirrored: eager updates take
minutes on one CPU worker. The card's learning receipts stand in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _dp_ranks
from cleanmarl_tpu.algos import facmac as jfacmac
from cleanmarl_tpu.algos.maddpg import gumbel_softmax as jgumbel_softmax
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu_torch.algos import facmac
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_map,
)
from cleanmarl_tpu_torch.envs import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ENV = ("mpe", "simple_speaker_listener_v4")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def assert_tree_close(port_tree, np_tree_, **tol):
    """Leaf by leaf, matched by key (the JAX tree's dict order differs)."""
    tree_map(lambda a, b: np.testing.assert_allclose(a.detach().numpy(), b, **tol),
             port_tree, np_tree_)


@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_eps_mixture_probs_match_jax(epsilon):
    rng = np.random.RandomState(1)
    logits = (2.0 * rng.randn(7, 3, 5)).astype(np.float32)
    avail = rng.rand(7, 3, 5) < 0.6
    avail[..., 2] = True
    logits = np.where(avail, logits, -1e9).astype(np.float32)
    key = jax.random.PRNGKey(4)
    # facmac.py:149-157 before its categorical draw
    soft = jgumbel_softmax(key, jnp.asarray(logits), 0.9, hard=False)
    availf = jnp.asarray(avail, jnp.float32)
    uni = availf / jnp.maximum(availf.sum(-1, keepdims=True), 1.0)
    want = np.asarray((1.0 - epsilon) * soft + epsilon * uni)
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, logits.shape)))
    got = facmac.eps_mixture_probs(torch.as_tensor(logits), torch.as_tensor(avail), epsilon,
                                   noise, 0.9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    big = torch.as_tensor(logits).repeat(50, 1, 1)
    acts = facmac.eps_mixture_sample(gen, big, torch.as_tensor(avail).repeat(50, 1, 1),
                                     epsilon, 0.9)
    assert torch.gather(torch.as_tensor(avail).repeat(50, 1, 1), -1, acts[..., None]).all()


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

B, H = 5, 16
UPDATE_CASES = {
    "plain": dict(),
    "normalize_clip": dict(normalize_reward=True, clip_gradients=0.05),
}


def jax_update(cfg, state, batch, mask, keys):
    """``facmac.py:209-256`` from the JAX package's own functions, on a
    batch that is already sampled, with the keys of its two Gumbel draws."""
    actor_p, critic_p, tgt_actor, tgt_critic, a_opt_s, c_opt_s = state
    k_tgt, k_fresh = keys
    a_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_actor, cfg.clip_gradients)
    c_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_critic, cfg.clip_gradients)

    def q_tot(cp, obs, onehot, state):
        u = jnets.mlp_apply(cp["q"], jnp.concatenate([obs, onehot], axis=-1))[..., 0]
        return jnets.mixer_apply(cp["mixer"], u, state)

    def logits(p, obs, avail):
        return jnets.masked_q(jnets.mlp_apply(p, obs), avail)

    msum = jnp.maximum(jnp.sum(mask), 1.0)
    a_next = jgumbel_softmax(k_tgt, logits(tgt_actor, batch["next_obs"], batch["next_avail"]),
                             cfg.gumbel_tau, hard=True)
    qtot_next = q_tot(tgt_critic, batch["next_obs"], a_next, batch["next_state"])
    reward = jstandardize(batch["reward"], mask) if cfg.normalize_reward else batch["reward"]
    target = reward + cfg.gamma * (1.0 - batch["ended"].astype(jnp.float32)) * qtot_next

    def critic_loss(p):
        qt = q_tot(p, batch["obs"], batch["action"], batch["state"])
        return jnp.sum(jnp.square(target - qt) * mask) / msum

    c_loss, c_grads = jax.value_and_grad(critic_loss)(critic_p)
    c_up, c_opt_s = c_opt.update(c_grads, c_opt_s, critic_p)
    critic_p = optax.apply_updates(critic_p, c_up)

    def actor_loss(p):
        fresh = jgumbel_softmax(k_fresh, logits(p, batch["obs"], batch["avail"]),
                                cfg.gumbel_tau, hard=False)
        return -jnp.sum(q_tot(critic_p, batch["obs"], fresh, batch["state"]) * mask) / msum

    a_loss, a_grads = jax.value_and_grad(actor_loss)(actor_p)
    a_up, a_opt_s = a_opt.update(a_grads, a_opt_s, actor_p)
    actor_p = optax.apply_updates(actor_p, a_up)
    return ((actor_p, critic_p, tgt_actor, tgt_critic, a_opt_s, c_opt_s),
            (a_loss, c_loss, jnets.global_norm(a_grads), jnets.global_norm(c_grads)))


def make_batch(rng, env, T):
    n, A, O, S = env.n_agents, env.n_actions, env.obs_dim, env.state_dim

    def avail():
        a = rng.rand(B, T, n, A) < 0.7
        a[..., rng.randint(A)] = True
        return a
    av = avail()
    batch = {"obs": rng.randn(B, T, n, O).astype(np.float32),
             "state": rng.randn(B, T, S).astype(np.float32), "avail": av,
             "action": np.eye(A, dtype=np.float32)[(rng.rand(B, T, n, A) * av).argmax(-1)],
             "reward": rng.randn(B, T).astype(np.float32) - 1.0, "ended": rng.rand(B, T) < 0.1,
             "next_obs": rng.randn(B, T, n, O).astype(np.float32),
             "next_state": rng.randn(B, T, S).astype(np.float32), "next_avail": avail()}
    return batch, (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(np.float32)


def start(cfg, env, seed):
    k = jax.random.split(jax.random.PRNGKey(seed), 5)
    n, A = env.n_agents, env.n_actions
    actor = jnets.mlp_init(k[0], env.obs_dim, H, A, 1, final_gain=0.01)
    critic = {"q": jnets.mlp_init(k[1], env.obs_dim + A, H, 1, 1),
              "mixer": jnets.mixer_init(k[2], n, env.state_dim, cfg.embed_dim, cfg.hyper_dim)}

    def perturb(tree, key):
        leaves, tdef = jax.tree.flatten(tree)
        keys = jax.random.split(key, len(leaves))
        return jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(kk, p.shape)
                                         for p, kk in zip(leaves, keys)])
    a_opt = jmake_optimizer("adam", cfg.learning_rate_actor, cfg.clip_gradients)
    c_opt = jmake_optimizer("adam", cfg.learning_rate_critic, cfg.clip_gradients)
    return (actor, critic, perturb(actor, k[3]), perturb(critic, k[4]), a_opt.init(actor),
            c_opt.init(critic))


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    kw = dict(UPDATE_CASES[case], env_type=ENV[0], env_name=ENV[1], actor_hidden_dim=H,
              critic_hidden_dim=H, hyper_dim=H, embed_dim=8, learning_rate_actor=3e-3,
              learning_rate_critic=3e-3)
    env = treg.make(*ENV, agent_ids=True, device="cpu")
    jcfg = jfacmac.FACMACConfig(**kw)
    state = start(jcfg, env, seed=len(case))
    rng = np.random.RandomState(len(case))
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    jupdate = jax.jit(functools.partial(jax_update, jcfg))
    keys = jax.random.split(jax.random.PRNGKey(len(case) + 10), 4)
    b0, m0 = make_batch(rng, env, env.episode_limit)
    state, _ = jupdate(state, jb(b0), jnp.asarray(m0), (keys[0], keys[1]))
    b1, m1 = make_batch(rng, env, env.episode_limit)
    want_state, want = jupdate(state, jb(b1), jnp.asarray(m1), (keys[2], keys[3]))
    noise = tuple(torch.as_tensor(np.array(jax.random.gumbel(k, b1["action"].shape)))
                  for k in (keys[2], keys[3]))

    init, _, _, meta = facmac.make_train(facmac.FACMACConfig(**kw, device="cpu"), env)
    actor, critic, tgt_actor, tgt_critic, a_opt, c_opt = (np_tree(x) for x in state)
    runner = init(torch.Generator().manual_seed(0)).replace(
        actor_params=from_numpy_tree(actor, "cpu"), critic_params=from_numpy_tree(critic, "cpu"),
        target_actor=from_numpy_tree(tgt_actor, "cpu"),
        target_critic=from_numpy_tree(tgt_critic, "cpu"),
        actor_opt=opt_state_from_numpy(a_opt, "cpu"), critic_opt=opt_state_from_numpy(c_opt,
                                                                                      "cpu"))
    assert sorted(runner.critic_opt["mu"]) == ["mixer", "q"]
    got = meta["update"](runner, {k: torch.as_tensor(v) for k, v in b1.items()},
                         torch.as_tensor(m1), noise)
    for g, w in zip(got[4:], want):
        np.testing.assert_allclose(float(g), float(w), **TOL)
    assert_tree_close(got[0], np_tree(want_state[0]), **TOL)
    assert_tree_close(got[1], np_tree(want_state[1]), **TOL)
    want_nu = opt_state_from_numpy(np_tree(want_state[5]), "cpu")["nu"]
    assert_tree_close(got[3]["nu"], tree_map(lambda x: x.numpy(), want_nu), **TOL)
    assert got[2]["count"] == got[3]["count"] == 2
    if jcfg.clip_gradients > 0:
        assert min(float(want[2]), float(want[3])) > jcfg.clip_gradients   # the clip acted


# ---------------------------------------------------------------------------
# the slice: train blocks, eval, CLI
# ---------------------------------------------------------------------------

TINY = dict(env_type=ENV[0], env_name=ENV[1], num_envs=4, buffer_size=10, batch_size=4,
            log_interval=25, actor_hidden_dim=8, critic_hidden_dim=8, hyper_dim=8,
            embed_dim=4, exploration_fraction=6.0, num_eval_ep=2,
            total_timesteps=2 * 4 * 25, seed=0, verbose=False)


@pytest.mark.parametrize("cap,want_counts", [(0, [(4, 0), (8, 0)]), (3, [(3, 1), (7, 1)])],
                         ids=["uncapped", "capped"])
def test_train_blocks_match_jax_episode_clock(cap, want_counts):
    kw = dict(TINY, max_updates_per_iter=cap)
    jinit, jblock, jeval = jfacmac.make_train(jfacmac.FACMACConfig(**kw))
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = facmac.make_train(facmac.FACMACConfig(**kw,
                                                                             device="cpu"))
    runner = init(torch.Generator().manual_seed(0))
    counts = []
    for _ in range(2):
        jrunner, jmetrics = jblock(jrunner)
        runner, metrics = train_block(runner)
        host = to_host(metrics)
        assert sorted(host) == sorted(jmetrics)
        assert all(np.isfinite(v) for v in host.values())
        for k in ("train/num_updates", "train/update_debt", "rollout/num_episodes"):
            assert host[k] == float(jmetrics[k]), k
        np.testing.assert_allclose(host["rollout/epsilon"], float(jmetrics["rollout/epsilon"]),
                                   rtol=1e-6)
        assert (runner.step, runner.episodes, runner.num_updates, runner.update_debt) == (
            int(jrunner.step), int(jrunner.episodes), int(jrunner.num_updates),
            int(jrunner.update_debt))
        counts.append((host["train/num_updates"], host["train/update_debt"]))
    assert counts == want_counts
    assert host["rollout/epsilon"] < TINY["exploration_fraction"]   # ε moved with updates
    evals = to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))
    assert sorted(evals) == sorted(jax.eval_shape(jeval, jrunner.actor_params,
                                                  jax.random.PRNGKey(1)))
    assert evals["eval/ep_length"] == 25.0 and all(np.isfinite(v) for v in evals.values())


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    runner, _ = facmac.main(["--env_type", ENV[0], "--env_name", ENV[1], "--device", "cpu",
                             "--num_envs", "4", "--buffer_size", "8", "--batch_size", "4",
                             "--log_interval", "25", "--total_timesteps", "200",
                             "--eval_steps", "100", "--num_eval_ep", "2",
                             "--actor_hidden_dim", "8", "--critic_hidden_dim", "8",
                             "--hyper_dim", "8", "--embed_dim", "4"])
    out = capsys.readouterr().out
    assert "[FACMAC] step=100" in out and "[FACMAC] step=200" in out
    assert runner.num_updates == 8 and sorted(runner.critic_params) == ["mixer", "q"]
    assert any(p.name.startswith("FACMAC-mpe__simple_speaker_listener_v4")
               for p in (tmp_path / "runs").iterdir())


@pytest.fixture(scope="module")
def dp_options(tmp_path_factory):
    """``train`` over 2 gloo ranks with each driver option that needs them
    (``tests/_dp_ranks.py:driver_options``)."""
    workdir = str(tmp_path_factory.mktemp("dp_options"))
    return workdir, _dp_ranks.run_ranks(_dp_ranks.driver_options, 2, "facmac", TINY, workdir)


@pytest.mark.parametrize("option", ["checkpoint", "mesh", "profile", "multiprocess"])
def test_unported_driver_options_raise(option, dp_options, monkeypatch):
    """The driver options that raised with more than one rank now run over
    2 ranks: ``checkpoint_dir`` saves a file per rank and a resumed run
    ends at twice the budget, ``profile_dir`` leaves a trace per rank,
    ``num_processes=2`` trains with the counters equal on both ranks, and
    ``use_mesh`` over two (mocked) cards spawns ``train`` on 2 ranks.
    Every run ends with the params identical on both ranks."""
    workdir, ranks = dp_options
    _dp_ranks.check_driver_option(option, facmac, facmac.FACMACConfig(**TINY, device="cpu"), workdir,
                                  ranks, monkeypatch)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        facmac.main(["--env_type", "matrix"])
