"""Port parity: the QMIX slice of ``cleanmarl_tpu_torch`` against the JAX
package, on the CPU.

- the mixer on copied params at (B, T, n) at 1e-6; ``soft_update``; the
  masked and unmasked ``standardize``; ``linear_schedule``;
  ``masked_argmax`` (ties, masks) and the per-env ε coin;
- the episode ring and accumulator driven with the same records and
  ragged ``ended`` flags until the ring wraps: ``data[:capacity]``,
  ``length[:capacity]``, ``cursor`` and ``size`` exactly (row
  ``capacity`` is the scratch row, which nothing reads);
- ``bounded_due`` and ``target_due`` sequences, capped and uncapped;
- one update (``meta["update"]``) against the same loss assembled here
  from the JAX package's functions as ``qmix.py:188-244`` does, from
  copied params and Adam state and an injected batch: loss, grad norm
  and new params at 1e-5, for double_q, memefficient and clip on and off;
- two ``train_block``s on simple_spread: the JAX package's metric keys,
  finite values, and ``train/num_updates`` / ``train/update_debt`` equal
  to the JAX package's after each block (the episode clock fixes them:
  every MPE env truncates at step 25), uncapped and capped; one
  ``eval_fn``; the CLI; the ``core/driver.py`` options over 2 gloo ranks
  and ``use_mesh``'s spawn, mocked.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _dp_ranks
from cleanmarl_tpu.algos import qmix as jqmix
from cleanmarl_tpu.buffers.episode import EpisodeAccumulator as JAcc
from cleanmarl_tpu.buffers.episode import EpisodeBuffer as JRing
from cleanmarl_tpu.core import acting as jacting
from cleanmarl_tpu.core import cadence as jcadence
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu.core.schedules import linear_schedule as jlinear_schedule
from cleanmarl_tpu_torch.algos import qmix as tqmix
from cleanmarl_tpu_torch.buffers.episode import EpisodeAccumulator, EpisodeBuffer
from cleanmarl_tpu_torch.core import acting, cadence
from cleanmarl_tpu_torch.core import networks as nets
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_map,
)
from cleanmarl_tpu_torch.core.rewards import standardize
from cleanmarl_tpu_torch.core.schedules import linear_schedule
from cleanmarl_tpu_torch.envs import registry as treg

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def assert_tree_close(port_tree, np_tree_, **tol):
    """Leaf by leaf, matched by key (the JAX tree's dict order differs)."""
    tree_map(lambda a, b: np.testing.assert_allclose(a.detach().numpy(), b, **tol),
             port_tree, np_tree_)


# ---------------------------------------------------------------------------
# networks, rewards, schedule, acting
# ---------------------------------------------------------------------------

def test_mixer_matches_jax():
    n, S, embed, hyper = 3, 54, 32, 64
    jp = jax.jit(lambda k: jnets.mixer_init(k, n, S, embed, hyper))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    qs = rng.randn(4, 25, n).astype(np.float32)
    state = rng.randn(4, 25, S).astype(np.float32)
    want = np.asarray(jnets.mixer_apply(jp, jnp.asarray(qs), jnp.asarray(state)))
    got = nets.mixer_apply(from_numpy_tree(np_tree(jp), "cpu"), torch.as_tensor(qs),
                           torch.as_tensor(state))
    assert got.shape == (4, 25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the port's init has the JAX layout, one hidden layer per hypernet
    tp = nets.mixer_init(torch.Generator().manual_seed(0), n, S, embed, hyper)
    tree_map(lambda a, b: (a.shape == b.shape) or pytest.fail("shape"), tp, np_tree(jp))
    assert len(tp["hw1"]["layers"]) == 1


def test_soft_update_matches_jax():
    init = jax.jit(lambda k: jnets.mlp_init(k, 7, 8, 3))
    jt, jo = init(jax.random.PRNGKey(1)), init(jax.random.PRNGKey(2))
    for tau in (0.01, 0.3, 1.0):
        want = np_tree(jnets.soft_update(jt, jo, tau))
        got = nets.soft_update(from_numpy_tree(np_tree(jt), "cpu"),
                               from_numpy_tree(np_tree(jo), "cpu"), tau)
        assert_tree_close(got, want, rtol=1e-7, atol=1e-7)


def test_standardize_masked_and_unmasked_match_jax():
    rng = np.random.RandomState(2)
    r = (3.0 + 2.0 * rng.randn(6, 25)).astype(np.float32)
    mask = (np.arange(25)[None] < rng.randint(1, 26, (6, 1))).astype(np.float32)
    for m in (mask, None, np.zeros_like(mask)):
        want = np.asarray(jstandardize(jnp.asarray(r), None if m is None else jnp.asarray(m)))
        got = standardize(torch.as_tensor(r), None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_linear_schedule_matches_jax():
    for t in (0, 1, 33, 6400, 99_999, 100_000, 250_000):
        want = float(jlinear_schedule(1.0, 0.025, 0.1 * 1_000_000, jnp.asarray(t, jnp.int32)))
        assert linear_schedule(1.0, 0.025, 0.1 * 1_000_000, t) == pytest.approx(want, rel=1e-7)


def test_masked_argmax_and_eps_greedy():
    rng = np.random.RandomState(3)
    q = rng.randint(0, 3, (64, 3, 5)).astype(np.float32)      # many ties
    avail = rng.rand(64, 3, 5) < 0.6
    avail[..., 2] = True
    want = np.asarray(jacting.masked_argmax(jnp.asarray(q), jnp.asarray(avail)))
    got = acting.masked_argmax(torch.as_tensor(q), torch.as_tensor(avail))
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = got
    g = torch.Generator().manual_seed(0)
    qt, at = torch.as_tensor(q), torch.as_tensor(avail)
    assert torch.equal(acting.eps_greedy(g, qt, at, 0.0), greedy)
    qt, at, greedy = qt.repeat(64, 1, 1), at.repeat(64, 1, 1), greedy.repeat(64, 1)
    explored = acting.eps_greedy(g, qt, at, 1.0)
    assert torch.gather(at, -1, explored[..., None]).all()
    p_match = float((explored == greedy).all(-1).float().mean())
    assert p_match < 0.1
    # one coin per env: at ε = 0.5 about half the envs act greedily in full
    same = (acting.eps_greedy(g, qt, at, 0.5) == greedy).all(-1).float().mean()
    assert abs(float(same) - (0.5 + 0.5 * p_match)) < 0.05


# ---------------------------------------------------------------------------
# episode ring and accumulator, cadence
# ---------------------------------------------------------------------------

def test_episode_ring_and_accumulator_match_jax():
    num_envs, t_max, cap = 4, 5, 6
    jex = {"obs": jnp.zeros((2, 3)), "action": jnp.zeros((2,), jnp.int32),
           "done": jnp.zeros((), jnp.bool_)}
    tex = {"obs": torch.zeros(2, 3), "action": torch.zeros(2, dtype=torch.int64),
           "done": torch.zeros((), dtype=torch.bool)}
    jring, jacc = JRing.create(cap, t_max, jex), JAcc.create(num_envs, t_max, jex)
    ring, acc = EpisodeBuffer.create(cap, t_max, tex), EpisodeAccumulator.create(
        num_envs, t_max, tex)
    rng = np.random.RandomState(4)
    wrapped = False
    for step in range(40):
        rec = {"obs": rng.randn(num_envs, 2, 3).astype(np.float32),
               "action": rng.randint(0, 5, (num_envs, 2)),
               "done": rng.rand(num_envs) < 0.5}
        ended = rng.rand(num_envs) < 0.35
        ended[3] = ended[3] and step > 12        # env 3 runs past T_max first
        jacc, jring = jacc.add_step(jring, {k: jnp.asarray(v) for k, v in rec.items()},
                                    jnp.asarray(ended))
        n_new = acc.add_step(ring, {k: torch.as_tensor(v) for k, v in rec.items()},
                             torch.as_tensor(ended))
        assert n_new == int(ended.sum())
        for k in rec:
            np.testing.assert_array_equal(ring.data[k][:cap].numpy(),
                                          np.asarray(jring.data[k][:cap]), err_msg=k)
            np.testing.assert_array_equal(acc.store[k].numpy(), np.asarray(jacc.store[k]))
        np.testing.assert_array_equal(ring.length[:cap].numpy(),
                                      np.asarray(jring.length[:cap]))
        np.testing.assert_array_equal(acc.t.numpy(), np.asarray(jacc.t))
        assert (ring.cursor, ring.size) == (int(jring.cursor), int(jring.size))
        wrapped |= ring.size == cap and ring.cursor > 0
    assert wrapped and ring.length[:cap].max() == t_max
    batch, mask = ring.sample(torch.Generator().manual_seed(0), 256)
    lengths = mask.sum(1).long()
    assert set(lengths.tolist()) <= set(ring.length[:cap].tolist())
    assert mask.shape == (256, t_max) and batch["obs"].shape == (256, t_max, 2, 3)


@pytest.mark.parametrize("n_slots", [3, 8], ids=["capped", "uncapped"])
def test_cadence_sequences_match_jax(n_slots):
    rng = np.random.RandomState(n_slots)
    dues = rng.randint(0, 7, 40) * (rng.rand(40) < 0.4)
    for train_freq, target_freq in ((1, 1), (2, 3), (3, 2)):
        debt, jdebt, ups, jups = 0, jnp.zeros((), jnp.int32), 0, jnp.zeros((), jnp.int32)
        for due in dues:
            n_run, debt = cadence.bounded_due(debt, int(due), n_slots)
            jn_run, jdebt = jcadence.bounded_due(jdebt, jnp.asarray(due, jnp.int32), n_slots)
            assert (n_run, debt) == (int(jn_run), int(jdebt))
            assert cadence.target_due(ups, n_run, train_freq, target_freq) == int(
                jcadence.target_due(jups, jn_run, train_freq, target_freq))
            ups, jups = ups + n_run, jups + jn_run
    assert cadence.num_slots(0, 8) == jcadence.num_slots(0, 8) == 8
    assert cadence.num_slots(2, 8) == jcadence.num_slots(2, 8) == 2


# ---------------------------------------------------------------------------
# one update
# ---------------------------------------------------------------------------

B, T, H = 6, 25, 16
# each of double_q, memefficient and clip on in one case and off in another
UPDATE_CASES = {
    "double_q": {},
    "plain_max_memefficient_clip": dict(double_q=False, memefficient=True,
                                        clip_gradients=0.5),
    "double_q_memefficient_normalize": dict(memefficient=True, normalize_reward=True),
    "double_q_adamw": dict(optimizer="adamw"),
}


def jax_update(cfg, params, target_params, opt_state, batch, mask):
    """``qmix.py:188-244`` from the JAX package's own functions, on a batch
    that is already sampled."""
    opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    reward = batch["reward"]
    if cfg.normalize_reward:
        reward = jstandardize(reward, mask)
    if cfg.memefficient:
        next_obs = jnp.roll(batch["obs"], -1, axis=1)
        next_state = jnp.roll(batch["state"], -1, axis=1)
        next_avail = jnp.roll(batch["avail"], -1, axis=1)
        has_next = jnp.roll(mask, -1, axis=1).at[:, -1].set(0.0)
    else:
        next_obs, next_state = batch["next_obs"], batch["next_state"]
        next_avail = batch["next_avail"]
        has_next = jnp.ones_like(mask)
    q_next_t = jnets.masked_q(jnets.mlp_apply(target_params["q"], next_obs), next_avail)
    if cfg.double_q:
        q_next_o = jnets.masked_q(jnets.mlp_apply(params["q"], next_obs), next_avail)
        a_star = jnp.argmax(q_next_o, axis=-1)
        q_next_max = jnp.take_along_axis(q_next_t, a_star[..., None], axis=-1)[..., 0]
    else:
        q_next_max = q_next_t.max(axis=-1)
    qtot_next = jnets.mixer_apply(target_params["mixer"], q_next_max, next_state)
    target = (reward + cfg.gamma * (1.0 - batch["done"].astype(jnp.float32))
              * has_next * qtot_next)

    def loss_fn(p):
        q = jnets.mlp_apply(p["q"], batch["obs"])
        q_taken = jnp.take_along_axis(q, batch["action"][..., None], axis=-1)[..., 0]
        qtot = jnets.mixer_apply(p["mixer"], q_taken, batch["state"])
        return jnp.sum(jnp.square(target - qtot) * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    gnorm = jnets.global_norm(grads)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, gnorm


def make_batch(rng, env, memefficient):
    n, A, O, S = env.n_agents, env.n_actions, env.obs_dim, env.state_dim

    def avail():
        a = rng.rand(B, T, n, A) < 0.7
        a[..., rng.randint(A)] = True
        return a
    av = avail()
    batch = {"obs": rng.randn(B, T, n, O).astype(np.float32),
             "state": rng.randn(B, T, S).astype(np.float32),
             "action": (rng.rand(B, T, n, A) * av).argmax(-1).astype(np.int32),
             "reward": rng.randn(B, T).astype(np.float32) - 1.0,
             "done": rng.rand(B, T) < 0.1}
    if memefficient:
        batch["avail"] = av
    else:
        batch.update(next_obs=rng.randn(B, T, n, O).astype(np.float32),
                     next_state=rng.randn(B, T, S).astype(np.float32), next_avail=avail())
    mask = (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(np.float32)
    return batch, mask


def to_torch_batch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["action"] = out["action"].long()
    return out


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_jax(case):
    kw = dict(env_type="mpe", env_name="simple_spread_v3", hidden_dim=H, hyper_dim=H,
              embed_dim=8, learning_rate=3e-3, **UPDATE_CASES[case])
    env = treg.make("mpe", "simple_spread_v3", agent_ids=True, device="cpu")
    jcfg = jqmix.QMIXConfig(**kw)

    @jax.jit
    def start(key):
        k = jax.random.split(key, 3)
        params = {"q": jnets.mlp_init(k[0], env.obs_dim, H, env.n_actions),
                  "mixer": jnets.mixer_init(k[1], env.n_agents, env.state_dim, 8, H)}
        leaves, tdef = jax.tree.flatten(params)
        noise = jax.random.split(k[2], len(leaves))
        target = jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(nk, p.shape)
                                           for p, nk in zip(leaves, noise)])
        opt = jmake_optimizer(jcfg.optimizer, jcfg.learning_rate, jcfg.clip_gradients)
        return params, target, opt.init(params)

    params, target, opt_state = start(jax.random.PRNGKey(len(case)))
    jupdate = jax.jit(functools.partial(jax_update, jcfg))
    rng = np.random.RandomState(len(case))
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    b0, m0 = make_batch(rng, env, jcfg.memefficient)
    params, opt_state, _, _ = jupdate(params, target, opt_state, jb(b0), jnp.asarray(m0))
    b1, m1 = make_batch(rng, env, jcfg.memefficient)
    want_p, want_o, want_loss, want_gnorm = jupdate(params, target, opt_state, jb(b1),
                                                    jnp.asarray(m1))

    _, _, _, meta = tqmix.make_train(tqmix.QMIXConfig(**kw, device="cpu"), env)
    got_p, got_o, loss, gnorm = meta["update"](
        from_numpy_tree(np_tree(params), "cpu"), from_numpy_tree(np_tree(target), "cpu"),
        opt_state_from_numpy(np_tree(opt_state), "cpu", jcfg.optimizer), to_torch_batch(b1),
        torch.as_tensor(m1))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(float(gnorm), float(want_gnorm), **TOL)
    assert_tree_close(got_p, np_tree(want_p), **TOL)
    assert got_o["count"] == 2
    if jcfg.clip_gradients > 0:
        assert float(want_gnorm) > jcfg.clip_gradients       # the clip acted


# ---------------------------------------------------------------------------
# the slice: train blocks, eval, CLI
# ---------------------------------------------------------------------------

TINY = dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, buffer_size=10,
            batch_size=4, log_interval=25, hidden_dim=16, hyper_dim=16, embed_dim=8,
            num_eval_ep=2, total_timesteps=2 * 4 * 25, seed=0, verbose=False)


@pytest.mark.parametrize("cap", [0, 2], ids=["uncapped", "capped"])
def test_train_blocks_match_jax_episode_clock(cap):
    kw = dict(TINY, max_updates_per_iter=cap)
    jinit, jblock, jeval = jqmix.make_train(jqmix.QMIXConfig(**kw))
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = tqmix.make_train(tqmix.QMIXConfig(**kw, device="cpu"))
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
        assert (runner.ring.cursor, runner.ring.size) == (int(jrunner.ring.cursor),
                                                          int(jrunner.ring.size))
        counts.append((host["train/num_updates"], host["train/update_debt"]))
    assert counts == ([(4, 0), (8, 0)] if cap == 0 else [(2, 2), (6, 2)])
    evals = to_host(eval_fn(runner.params, torch.Generator().manual_seed(1)))
    jevals = jax.eval_shape(jeval, jrunner.params, jax.random.PRNGKey(1))
    assert sorted(evals) == sorted(jevals)
    assert evals["eval/ep_length"] == 25.0
    assert all(np.isfinite(v) for v in evals.values())


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tqmix.main(["--env_type", "mpe", "--env_name", "simple_spread_v3", "--device", "cpu",
                "--num_envs", "4", "--buffer_size", "8", "--batch_size", "4",
                "--log_interval", "25", "--total_timesteps", "200", "--eval_steps", "100",
                "--num_eval_ep", "2", "--hidden_dim", "8", "--hyper_dim", "8",
                "--embed_dim", "4", "--memefficient", "true"])
    out = capsys.readouterr().out
    assert "[QMIX] step=100" in out and "[QMIX] step=200" in out
    assert any(p.name.startswith("QMIX-mpe__simple_spread_v3")
               for p in (tmp_path / "runs").iterdir())


@pytest.fixture(scope="module")
def dp_options(tmp_path_factory):
    """``train`` over 2 gloo ranks with each driver option that needs them
    (``tests/_dp_ranks.py:driver_options``)."""
    workdir = str(tmp_path_factory.mktemp("dp_options"))
    return workdir, _dp_ranks.run_ranks(_dp_ranks.driver_options, 2, "qmix", TINY, workdir)


@pytest.mark.parametrize("option", ["checkpoint", "mesh", "profile", "multiprocess"])
def test_unported_driver_options_raise(option, dp_options, monkeypatch):
    """The driver options that raised with more than one rank now run over
    2 ranks: ``checkpoint_dir`` saves a file per rank and a resumed run
    ends at twice the budget, ``profile_dir`` leaves a trace per rank,
    ``num_processes=2`` trains with the counters equal on both ranks, and
    ``use_mesh`` over two (mocked) cards spawns ``train`` on 2 ranks.
    Every run ends with the params identical on both ranks."""
    workdir, ranks = dp_options
    _dp_ranks.check_driver_option(option, tqmix, tqmix.QMIXConfig(**TINY, device="cpu"), workdir,
                                  ranks, monkeypatch)