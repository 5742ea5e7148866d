"""Port parity: the VDN slice of ``cleanmarl_tpu_torch`` against the JAX
package, on the CPU.

- the transition ring driven with the same batches until it wraps: data,
  ``cursor`` and ``size`` exactly; uniform sampling over the valid rows;
- one update (``meta["update"]``) against the same loss assembled here
  from the JAX package's functions as ``vdn.py:157-179`` does, from copied
  params and Adam state and an injected batch: loss, grad norm and new
  params at 1e-5, with clip on and off and reward normalization;
- two ``train_block``s on simple_spread: the JAX package's metric keys,
  finite values, and ``train/num_updates`` equal to the JAX package's
  after each block (fixed by the iteration clock); one ``eval_fn``; the
  CLI.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cleanmarl_tpu.algos import vdn as jvdn
from cleanmarl_tpu.buffers.transition import TransitionBuffer as JBuffer
from cleanmarl_tpu.core import networks as jnets
from cleanmarl_tpu.core.optim import make_optimizer as jmake_optimizer
from cleanmarl_tpu.core.rewards import standardize as jstandardize
from cleanmarl_tpu.types import Transition as JTransition
from cleanmarl_tpu_torch.algos import vdn as tvdn
from cleanmarl_tpu_torch.buffers.transition import TransitionBuffer
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_map,
)
from cleanmarl_tpu_torch.envs import registry as treg
from cleanmarl_tpu_torch.types import Transition

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("obs", "state", "avail", "action", "reward", "done", "next_obs", "next_state",
          "next_avail")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def make_transitions(rng, B, n=3, O=21, S=54, A=5):
    avail = rng.rand(B, n, A) < 0.7
    avail[..., 0] = True
    return dict(obs=rng.randn(B, n, O).astype(np.float32),
                state=rng.randn(B, S).astype(np.float32), avail=avail,
                action=(rng.rand(B, n, A) * avail).argmax(-1).astype(np.int32),
                reward=rng.randn(B).astype(np.float32) - 1.0, done=rng.rand(B) < 0.1,
                next_obs=rng.randn(B, n, O).astype(np.float32),
                next_state=rng.randn(B, S).astype(np.float32),
                next_avail=rng.rand(B, n, A) < 0.7)


def to_port(rec):
    t = {k: torch.as_tensor(v) for k, v in rec.items()}
    t["action"] = t["action"].long()
    t["next_avail"][..., 1] = True
    return Transition(**t)


def to_jax(rec):
    t = {k: jnp.asarray(v) for k, v in rec.items()}
    t["next_avail"] = t["next_avail"].at[..., 1].set(True)
    return JTransition(**t)


def test_transition_ring_matches_jax():
    cap, B = 7, 3
    rng = np.random.RandomState(0)
    ex = make_transitions(rng, 1)
    jbuf = JBuffer.create(cap, to_jax({k: v[0] for k, v in ex.items()}))
    buf = TransitionBuffer.create(cap, to_port({k: v[0] for k, v in ex.items()}))
    for _ in range(6):
        rec = make_transitions(rng, B)
        jbuf = jbuf.add_batch(to_jax(rec))
        buf.add_batch(to_port(rec))
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(buf.data, k).numpy(),
                                          np.asarray(getattr(jbuf.data, k)), err_msg=k)
        assert (buf.cursor, buf.size) == (int(jbuf.cursor), int(jbuf.size))
    assert buf.size == cap and buf.cursor == 18 % cap
    batch = buf.sample(torch.Generator().manual_seed(0), 64)
    assert isinstance(batch, Transition) and batch.obs.shape == (64, 3, 21)
    rows = {tuple(r) for r in buf.data.reward[:, None].tolist()}
    assert {tuple(r) for r in batch.reward[:, None].tolist()} <= rows
    empty = TransitionBuffer.create(cap, to_port({k: v[0] for k, v in ex.items()}))
    assert empty.sample(torch.Generator().manual_seed(0), 4).obs.shape == (4, 3, 21)


def jax_update(cfg, params, target_params, opt_state, batch):
    """``vdn.py:157-179`` from the JAX package's own functions, on a batch
    that is already sampled."""
    opt = jmake_optimizer(cfg.optimizer, cfg.learning_rate, cfg.clip_gradients)
    if cfg.normalize_reward:
        batch = batch.replace(reward=jstandardize(batch.reward))
    q_next = jnets.masked_q(jnets.mlp_apply(target_params, batch.next_obs), batch.next_avail)
    team_next = q_next.max(axis=-1).sum(axis=-1)
    target = batch.reward + cfg.gamma * (1.0 - batch.done.astype(jnp.float32)) * team_next

    def loss_fn(p):
        q = jnets.mlp_apply(p, batch.obs)
        q_taken = jnp.take_along_axis(q, batch.action[..., None], axis=-1)[..., 0]
        return jnp.mean(jnp.square(target - q_taken.sum(axis=-1)))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    gnorm = jnets.global_norm(grads)
    updates, opt_state = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, gnorm


@pytest.mark.parametrize("case", ["clip", "noclip_normalize"])
def test_update_matches_jax(case):
    kw = dict(env_type="mpe", env_name="simple_spread_v3", hidden_dim=16,
              learning_rate=3e-3, batch_size=4, num_envs=8)
    kw.update(dict(clip_gradients=2.0) if case == "clip" else
              dict(clip_gradients=-1.0, normalize_reward=True))
    env = treg.make("mpe", "simple_spread_v3", agent_ids=True, device="cpu")
    jcfg = jvdn.VDNConfig(**kw)

    @jax.jit
    def start(key):
        k1, k2 = jax.random.split(key)
        params = jnets.mlp_init(k1, env.obs_dim, 16, env.n_actions)
        leaves, tdef = jax.tree.flatten(params)
        noise = jax.random.split(k2, len(leaves))
        target = jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(nk, p.shape)
                                           for p, nk in zip(leaves, noise)])
        opt = jmake_optimizer("adam", jcfg.learning_rate, jcfg.clip_gradients)
        return params, target, opt.init(params)

    params, target, opt_state = start(jax.random.PRNGKey(len(case)))
    jupdate = jax.jit(functools.partial(jax_update, jcfg))
    rng = np.random.RandomState(len(case))
    params, opt_state, _, _ = jupdate(params, target, opt_state,
                                      to_jax(make_transitions(rng, 32)))
    rec = make_transitions(rng, 32)
    want_p, _, want_loss, want_gnorm = jupdate(params, target, opt_state, to_jax(rec))

    _, _, _, meta = tvdn.make_train(tvdn.VDNConfig(**kw, device="cpu"), env)
    got_p, got_o, loss, gnorm = meta["update"](
        from_numpy_tree(np_tree(params), "cpu"), from_numpy_tree(np_tree(target), "cpu"),
        opt_state_from_numpy(np_tree(opt_state), "cpu"), to_port(rec))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(float(gnorm), float(want_gnorm), **TOL)
    tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), b, **TOL), got_p,
             np_tree(want_p))
    assert got_o["count"] == 2
    if case == "clip":
        assert float(want_gnorm) > jcfg.clip_gradients      # the clip acted


TINY = dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4, buffer_size=200,
            batch_size=4, learning_starts=40, train_freq=2, target_network_update_freq=3,
            log_interval=30, hidden_dim=16, num_eval_ep=2, total_timesteps=2 * 4 * 30,
            seed=0, verbose=False)


def test_train_blocks_match_jax_iteration_clock():
    jinit, jblock, jeval = jvdn.make_train(jvdn.VDNConfig(**TINY))
    jrunner = jinit(jax.random.PRNGKey(0))
    init, train_block, eval_fn, meta = tvdn.make_train(tvdn.VDNConfig(**TINY, device="cpu"))
    assert meta["steps_per_block"] == 4 * 30
    runner = init(torch.Generator().manual_seed(0))
    counts = []
    for _ in range(2):
        jrunner, jmetrics = jblock(jrunner)
        runner, metrics = train_block(runner)
        host = to_host(metrics)
        assert sorted(host) == sorted(jmetrics)
        assert all(np.isfinite(v) for v in host.values())
        for k in ("train/num_updates", "rollout/num_episodes"):
            assert host[k] == float(jmetrics[k]), k
        assert (runner.step, runner.buffer.cursor, runner.buffer.size) == (
            int(jrunner.step), int(jrunner.buffer.cursor), int(jrunner.buffer.size))
        counts.append(host["train/num_updates"])
    # updates at the even iterations from the first with more than 40 transitions
    assert counts == [10, 25]
    evals = to_host(eval_fn(runner.params, torch.Generator().manual_seed(1)))
    jevals = jax.eval_shape(jeval, jrunner.params, jax.random.PRNGKey(1))
    assert sorted(evals) == sorted(jevals)
    assert evals["eval/ep_length"] == 25.0
    assert all(np.isfinite(v) for v in evals.values())


def test_cli_runs_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tvdn.main(["--env_type", "mpe", "--env_name", "simple_spread_v3", "--device", "cpu",
               "--num_envs", "4", "--buffer_size", "100", "--batch_size", "2",
               "--learning_starts", "20", "--log_interval", "25",
               "--total_timesteps", "200", "--eval_steps", "100", "--num_eval_ep", "2",
               "--hidden_dim", "8"])
    out = capsys.readouterr().out
    assert "[VDN] step=100" in out and "[VDN] step=200" in out
    assert any(p.name.startswith("VDN-mpe__simple_spread_v3")
               for p in (tmp_path / "runs").iterdir())
