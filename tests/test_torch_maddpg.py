"""Port parity: MADDPG of ``cleanmarl_tpu_torch`` (``algos/maddpg.py``)
against the JAX package, on the CPU.

- ``gumbel_softmax``: the hard sample is one-hot with a non-zero
  straight-through gradient, a masked action is never chosen
  (``tests/test_maddpg.py:11-33``), and the values equal the JAX
  function's at 1e-6 on the noise ``jax.random.gumbel`` draws from the
  same key;
- one update (``meta["update"]``) against the same update assembled here
  from the JAX package's functions as ``maddpg.py:239-293`` does, from
  copied params and Adam states, an injected batch and the Gumbel noise
  the JAX keys draw: losses, grad norms and new params at 1e-5, for the
  feed-forward actor with ``normalize_reward`` and with ``clip_gradients``,
  the GRU actor on the scan route and on the kernel route (whose CPU
  path runs the kernels' plain versions), and SMAClite 3m's widths with
  dead agents (the no-op their only action);
- two ``train_block``s on speaker-listener against the JAX
  ``make_train``: the JAX metric keys, finite values, and
  ``train/num_updates`` / ``train/update_debt`` equal (every MPE env
  truncates at step 25), uncapped, capped and recurrent; one ``eval_fn``;
- the GRU carry is zero after every episode end; the CLI; the driver
  options over 2 gloo ranks and ``use_mesh``'s spawn, mocked; ``device="cuda"``
  raising without a card.

The JAX learning tests (``tests/test_maddpg.py:36,62``, 40,000 env steps
with an update per completed episode) are not mirrored: eager updates
take minutes on one CPU worker. The card's learning receipts stand in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _dp_ranks
from cleanmarl_tpu.algos import maddpg as jmaddpg
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu_torch.algos import maddpg
from cleanmarl_tpu_torch.core import networks as nets
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


# ---------------------------------------------------------------------------
# gumbel_softmax
# ---------------------------------------------------------------------------

def test_gumbel_softmax_hard_is_onehot_with_straight_through_gradient():
    logits = torch.tensor([[2.0, 0.0, -1.0]], requires_grad=True)
    noise = maddpg.gumbel_noise(torch.Generator().manual_seed(0), logits.shape)
    y = maddpg.gumbel_softmax(logits, noise, hard=True)
    np.testing.assert_allclose(y.detach().sum(-1).numpy(), 1.0, rtol=1e-6)
    assert set(np.unique(y.detach().numpy())) <= {0.0, 1.0}
    (g,) = torch.autograd.grad(y[0, 0], logits)
    assert float(g.abs().sum()) > 0.0


def test_gumbel_softmax_never_picks_a_masked_action():
    logits = nets.masked_q(torch.zeros(1, 3), torch.tensor([[True, False, True]]))
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        y = maddpg.gumbel_softmax(logits, maddpg.gumbel_noise(gen, logits.shape), hard=True)
        assert float(y[0, 1]) == 0.0


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_gumbel_softmax_matches_jax_on_the_same_noise(hard):
    rng = np.random.RandomState(0)
    logits = (2.0 * rng.randn(6, 4, 3, 5)).astype(np.float32)
    logits[..., 1] = -1e9                                   # a masked action
    key = jax.random.PRNGKey(3)
    want = np.asarray(jmaddpg.gumbel_softmax(key, jnp.asarray(logits), 0.7, hard=hard))
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, logits.shape)))
    got = maddpg.gumbel_softmax(torch.as_tensor(logits), noise, 0.7, hard=hard)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    g = maddpg.gumbel_noise(torch.Generator().manual_seed(1), (20000,))
    assert abs(float(g.mean()) - 0.5772) < 0.03 and torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

B, H = 5, 16
UPDATE_CASES = {
    "ff_normalize": dict(),
    "ff_clip": dict(normalize_reward=False, clip_gradients=0.05),
    "rnn_scan": dict(recurrent=True),
    "rnn_kernel_route_clip": dict(recurrent=True, clip_gradients=0.05, gru_impl="kernel"),
    # SMAClite 3m: 150-step episodes, dead agents whose only action is the no-op
    "ff_smaclite_3m_dead_agents": dict(env=("smaclite", "3m"), dead=0.2),
}


def jax_update(cfg, env, state, batch, mask, keys):
    """``maddpg.py:239-293`` from the JAX package's own functions, on a
    batch that is already sampled, with the keys of its two Gumbel draws."""
    actor_p, critic_p, tgt_actor, tgt_critic, a_opt_s, c_opt_s = state
    k_tgt, k_fresh = keys
    a_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_actor, cfg.clip_gradients)
    c_opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate_critic, cfg.clip_gradients)
    n, A = env.n_agents, env.n_actions

    def critic_q(p, state, joint):
        flat = joint.reshape(joint.shape[:-2] + (n * A,))
        return jnets.mlp_apply(p, jnp.concatenate([state, flat], axis=-1))[..., 0]

    def logits_episodes(p, obs, avail):
        if not cfg.recurrent:
            return jnets.masked_q(jnets.mlp_apply(p, obs), avail)
        obs_tm = jnp.moveaxis(obs, 0, 1)
        h0 = jnp.zeros(obs_tm.shape[1:-1] + (cfg.actor_hidden_dim,))
        _, logits = jnets.rnn_seq_apply(p, h0, obs_tm)
        return jnets.masked_q(jnp.moveaxis(logits, 0, 1), avail)

    def next_logits(p):
        if not cfg.recurrent:
            return jnets.masked_q(jnets.mlp_apply(p, batch["next_obs"]), batch["next_avail"])
        obs_tm = jnp.moveaxis(batch["obs"], 0, 1)
        h0 = jnp.zeros(obs_tm.shape[1:-1] + (cfg.actor_hidden_dim,))
        logits = jnets.rnn_seq_eval_next(p, h0, obs_tm, jnp.moveaxis(batch["next_obs"], 0, 1))
        return jnets.masked_q(jnp.moveaxis(logits, 0, 1), batch["next_avail"])

    a_next = jmaddpg.gumbel_softmax(k_tgt, next_logits(tgt_actor), cfg.gumbel_tau, hard=True)
    q_next = critic_q(tgt_critic, batch["next_state"], a_next)
    reward = jstandardize(batch["reward"], mask) if cfg.normalize_reward else batch["reward"]
    target = reward + cfg.gamma * (1.0 - batch["ended"].astype(jnp.float32)) * q_next
    msum = jnp.maximum(jnp.sum(mask), 1.0)

    def critic_loss(p):
        q = critic_q(p, batch["state"], batch["action"])
        return jnp.sum(jnp.square(target - q) * mask) / msum

    c_loss, c_grads = jax.value_and_grad(critic_loss)(critic_p)
    c_up, c_opt_s = c_opt.update(c_grads, c_opt_s, critic_p)
    critic_p = optax.apply_updates(critic_p, c_up)
    eye = jnp.eye(n)[:, :, None]

    def actor_loss(p):
        fresh = jmaddpg.gumbel_softmax(k_fresh, logits_episodes(p, batch["obs"],
                                                                batch["avail"]),
                                       cfg.gumbel_tau, hard=False)
        q_all = jax.vmap(lambda i: critic_q(critic_p, batch["state"],
                                            i * fresh + (1.0 - i) * batch["action"]))(eye)
        return -jnp.sum(q_all * mask[None]) / msum

    a_loss, a_grads = jax.value_and_grad(actor_loss)(actor_p)
    a_up, a_opt_s = a_opt.update(a_grads, a_opt_s, actor_p)
    actor_p = optax.apply_updates(actor_p, a_up)
    return ((actor_p, critic_p, tgt_actor, tgt_critic, a_opt_s, c_opt_s),
            (a_loss, c_loss, jnets.global_norm(a_grads), jnets.global_norm(c_grads)))


def make_batch(rng, env, T, dead=0.0):
    """Random episodes; a ``dead`` share of agent-steps has only action 0."""
    n, A, O, S = env.n_agents, env.n_actions, env.obs_dim, env.state_dim

    def avail():
        a = rng.rand(B, T, n, A) < 0.7
        a[..., rng.randint(A)] = True
        if dead:
            a[rng.rand(B, T, n) < dead] = np.arange(A) == 0
        return a
    av = avail()
    action = np.eye(A, dtype=np.float32)[(rng.rand(B, T, n, A) * av).argmax(-1)]
    batch = {"obs": rng.randn(B, T, n, O).astype(np.float32),
             "state": rng.randn(B, T, S).astype(np.float32), "avail": av, "action": action,
             "reward": rng.randn(B, T).astype(np.float32) - 1.0,
             "ended": rng.rand(B, T) < 0.1,
             "next_obs": rng.randn(B, T, n, O).astype(np.float32),
             "next_state": rng.randn(B, T, S).astype(np.float32), "next_avail": avail()}
    mask = (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(np.float32)
    return batch, mask


def start(cfg, env, seed):
    """JAX actor and critic params, perturbed targets, fresh Adam states."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    n, A = env.n_agents, env.n_actions
    if cfg.recurrent:
        actor = jnets.rnn_init(k[0], env.obs_dim, H, A, final_gain=0.01)
    else:
        actor = jnets.mlp_init(k[0], env.obs_dim, H, A, 1, final_gain=0.01)
    critic = jnets.mlp_init(k[1], env.state_dim + n * A, H, 1, 1)

    def perturb(tree, key):
        leaves, tdef = jax.tree.flatten(tree)
        keys = jax.random.split(key, len(leaves))
        return jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(kk, p.shape)
                                         for p, kk in zip(leaves, keys)])
    a_opt = jmake_optimizer("adam", cfg.learning_rate_actor, cfg.clip_gradients)
    c_opt = jmake_optimizer("adam", cfg.learning_rate_critic, cfg.clip_gradients)
    return (actor, critic, perturb(actor, k[2]), perturb(critic, k[3]), a_opt.init(actor),
            c_opt.init(critic))


def port_runner(init, state):
    """The port's runner carrying the JAX update state."""
    actor, critic, tgt_actor, tgt_critic, a_opt, c_opt = (np_tree(x) for x in state)
    runner = init(torch.Generator().manual_seed(0))
    return runner.replace(
        actor_params=from_numpy_tree(actor, "cpu"), critic_params=from_numpy_tree(critic, "cpu"),
        target_actor=from_numpy_tree(tgt_actor, "cpu"),
        target_critic=from_numpy_tree(tgt_critic, "cpu"),
        actor_opt=opt_state_from_numpy(a_opt, "cpu"),
        critic_opt=opt_state_from_numpy(c_opt, "cpu"))


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case, monkeypatch):
    kw = dict(UPDATE_CASES[case])
    gru_impl = kw.pop("gru_impl", "auto")
    if gru_impl == "kernel":
        # the kernel route on CPU tensors: the kernels' plain versions
        monkeypatch.setattr(nets, "resolve_gru_impl", lambda *a, **k: "kernel")
    env_id, dead = kw.pop("env", ENV), kw.pop("dead", 0.0)
    kw.update(env_type=env_id[0], env_name=env_id[1], actor_hidden_dim=H, critic_hidden_dim=H,
              learning_rate_actor=3e-3, learning_rate_critic=3e-3, gumbel_tau=0.8)
    env = treg.make(*env_id, agent_ids=True, device="cpu")
    T = env.episode_limit
    jcfg = jmaddpg.MADDPGConfig(**kw)
    state = start(jcfg, env, seed=len(case))
    rng = np.random.RandomState(len(case))
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    jupdate = jax.jit(functools.partial(jax_update, jcfg, env))
    keys = jax.random.split(jax.random.PRNGKey(len(case) + 10), 4)
    b0, m0 = make_batch(rng, env, T, dead)
    state, _ = jupdate(state, jb(b0), jnp.asarray(m0), (keys[0], keys[1]))
    b1, m1 = make_batch(rng, env, T, dead)
    want_state, want = jupdate(state, jb(b1), jnp.asarray(m1), (keys[2], keys[3]))
    noise = tuple(torch.as_tensor(np.array(jax.random.gumbel(k, b1["action"].shape)))
                  for k in (keys[2], keys[3]))

    init, _, _, meta = maddpg.make_train(maddpg.MADDPGConfig(**kw, device="cpu"), env)
    assert meta["gru_impl"] == ({"auto": "scan"}.get(gru_impl, gru_impl)
                                if jcfg.recurrent else None)
    got = meta["update"](port_runner(init, state), to_torch(b1), torch.as_tensor(m1), noise)
    for g, w in zip(got[4:], want):
        np.testing.assert_allclose(float(g), float(w), **TOL)
    assert_tree_close(got[0], np_tree(want_state[0]), **TOL)
    assert_tree_close(got[1], np_tree(want_state[1]), **TOL)
    assert got[2]["count"] == got[3]["count"] == 2
    if jcfg.clip_gradients > 0:
        assert min(float(want[2]), float(want[3])) > jcfg.clip_gradients   # the clip acted


# ---------------------------------------------------------------------------
# the slice: train blocks, hidden resets, eval, CLI
# ---------------------------------------------------------------------------

TINY = dict(env_type=ENV[0], env_name=ENV[1], num_envs=4, buffer_size=10, batch_size=4,
            log_interval=25, actor_hidden_dim=8, critic_hidden_dim=8, num_eval_ep=2,
            total_timesteps=2 * 4 * 25, seed=0, verbose=False)
BLOCK_CASES = {
    # every speaker-listener env truncates at step 25: 4 episodes a block;
    # capped, the debt is paid from the next iteration on
    "uncapped": (dict(), [(4, 0), (8, 0)]),
    "capped": (dict(max_updates_per_iter=3), [(3, 1), (7, 1)]),
    "recurrent_capped": (dict(recurrent=True, max_updates_per_iter=2), [(2, 2), (6, 2)]),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_train_blocks_match_jax_episode_clock(case):
    kw, want_counts = BLOCK_CASES[case]
    kw = dict(TINY, **kw)
    jinit, jblock, jeval = jmaddpg.make_train(jmaddpg.MADDPGConfig(**kw))
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = maddpg.make_train(maddpg.MADDPGConfig(**kw,
                                                                             device="cpu"))
    assert meta["steps_per_block"] == 4 * 25
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
        assert (runner.step, runner.episodes, runner.num_updates, runner.update_debt) == (
            int(jrunner.step), int(jrunner.episodes), int(jrunner.num_updates),
            int(jrunner.update_debt))
        counts.append((host["train/num_updates"], host["train/update_debt"]))
    assert counts == want_counts
    assert float(runner.actor_h.abs().sum()) == 0.0       # every env ended at step 50
    evals = to_host(eval_fn(runner.actor_params, torch.Generator().manual_seed(1)))
    assert sorted(evals) == sorted(jax.eval_shape(jeval, jrunner.actor_params,
                                                  jax.random.PRNGKey(1)))
    assert evals["eval/ep_length"] == 25.0 and all(np.isfinite(v) for v in evals.values())


def test_recurrent_carry_resets_at_episode_end():
    init, _, _, meta = maddpg.make_train(maddpg.MADDPGConfig(**TINY, recurrent=True,
                                                             device="cpu"))
    runner = init(torch.Generator().manual_seed(0))
    for _ in range(3):
        runner = meta["train_iter"](runner)
    assert float(runner.actor_h.abs().sum()) > 0           # mid-episode
    for _ in range(22):
        runner = meta["train_iter"](runner)
    assert runner.step == 25 and float(runner.actor_h.abs().sum()) == 0.0


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    runner, _ = maddpg.main(["--env_type", ENV[0], "--env_name", ENV[1], "--device", "cpu",
                             "--num_envs", "4", "--buffer_size", "8", "--batch_size", "4",
                             "--log_interval", "25", "--total_timesteps", "200",
                             "--eval_steps", "100", "--num_eval_ep", "2",
                             "--actor_hidden_dim", "8", "--critic_hidden_dim", "8",
                             "--recurrent", "true"])
    out = capsys.readouterr().out
    assert "[MADDPG] step=100" in out and "[MADDPG] step=200" in out
    assert "[MADDPG] eval step=200 ep_reward=" in out
    assert runner.num_updates == 8 and "gru" in runner.actor_params
    assert any(p.name.startswith("MADDPG-mpe__simple_speaker_listener_v4")
               for p in (tmp_path / "runs").iterdir())


@pytest.fixture(scope="module")
def dp_options(tmp_path_factory):
    """``train`` over 2 gloo ranks with each driver option that needs them
    (``tests/_dp_ranks.py:driver_options``)."""
    workdir = str(tmp_path_factory.mktemp("dp_options"))
    return workdir, _dp_ranks.run_ranks(_dp_ranks.driver_options, 2, "maddpg", TINY, workdir)


@pytest.mark.parametrize("option", ["checkpoint", "mesh", "profile", "multiprocess"])
def test_unported_driver_options_raise(option, dp_options, monkeypatch):
    """The driver options that raised with more than one rank now run over
    2 ranks: ``checkpoint_dir`` saves a file per rank and a resumed run
    ends at twice the budget, ``profile_dir`` leaves a trace per rank,
    ``num_processes=2`` trains with the counters equal on both ranks, and
    ``use_mesh`` over two (mocked) cards spawns ``train`` on 2 ranks.
    Every run ends with the params identical on both ranks."""
    workdir, ranks = dp_options
    _dp_ranks.check_driver_option(option, maddpg, maddpg.MADDPGConfig(**TINY, device="cpu"), workdir,
                                  ranks, monkeypatch)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        maddpg.make_train(maddpg.MADDPGConfig(env_type="matrix"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        maddpg.main(["--env_type", "matrix"])
