"""Port parity: SISL pursuit of ``cleanmarl_tpu_torch`` (``envs/pursuit.py``)
against upstream PettingZoo and the JAX package (``tests/test_envs_pursuit.py``).

- against the installed ``pettingzoo.sisl.pursuit_v4``, driven from the
  same injected positions with the same actions and frozen evaders:
  obs and rewards equal (atol 1e-6 on float32 rewards that upstream sums
  in float64) at tags, blocked moves, surround and border captures,
  sequential sub-moves and a 12-cycle random rollout;
- against the JAX env on injected batched states (random ones and the
  capture scenarios, with and without ``surround``), the evaders' random
  walk fed the draws ``jax.random.randint(key, (E,), 0, 5)`` of the JAX
  step's keys through ``Pursuit._evader_actions`` (the one method
  replaced): obs, state, reward, flags and the new state at 1e-6 over
  several steps;
- the committed ``pursuit_small.npz`` transcript replayed the same way, at
  1e-6, each episode from the JAX reset state;
- ``need_to_surround`` equals the JAX table; spawn rules; the exhaustion
  guard.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.envs import pursuit as jpursuit
from cleanmarl_tpu_torch.envs import pursuit
from cleanmarl_tpu_torch.envs.base import VecEnv, state_from_numpy
from cleanmarl_tpu_torch.envs.pursuit import Pursuit, PursuitState

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSCRIPT = os.path.join(REPO, "validation", "transcripts", "pursuit_small.npz")
ATOL = 1e-6


def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


def feed_jax_draws(env, keys):
    """Make ``env._evader_actions`` return the JAX step's draws, one row per
    env, from ``keys`` (one JAX key per env)."""
    draws = torch.as_tensor(np.stack([np.asarray(jax.random.randint(
        k, (env.n_evaders,), 0, env.n_actions)) for k in keys])).long()
    env._evader_actions = lambda generator, shape: draws


# ---------------------------------------------------------------------------
# against upstream PettingZoo
# ---------------------------------------------------------------------------

def make_upstream(n_pursuers, n_evaders):
    from pettingzoo.sisl import pursuit_v4

    env = pursuit_v4.parallel_env(n_pursuers=n_pursuers, n_evaders=n_evaders,
                                  freeze_evaders=True)
    env.reset(seed=0)
    return env


def inject(env, ppos, epos):
    """Overwrite upstream agent positions after a reset."""
    base = env.unwrapped.env
    for i, (x, y) in enumerate(ppos):
        base.pursuer_layer.set_position(i, int(x), int(y))
    for i, (x, y) in enumerate(epos):
        base.evader_layer.set_position(i, int(x), int(y))
    base.model_state[1] = base.pursuer_layer.get_state_matrix()
    base.model_state[2] = base.evader_layer.get_state_matrix()
    return base


def port_state(ppos, epos):
    return PursuitState(ppos=torch.as_tensor([ppos]).long(), epos=torch.as_tensor([epos]).long(),
                        ealive=torch.ones((1, len(epos)), dtype=torch.bool),
                        t=torch.zeros((1,), dtype=torch.int64))


# (pursuer positions, evader positions, actions) of tests/test_envs_pursuit.py
UPSTREAM = {
    "tags_open_field": ([(1, 1), (2, 13), (14, 2), (13, 14)], [(1, 2), (2, 12), (14, 3)],
                        [4, 4, 4, 4]),
    "blocked_by_building_and_bounds": ([(4, 8), (0, 0)], [(15, 15)], [1, 0]),
    "surround_capture": ([(7, 1), (9, 1), (8, 0), (8, 2)], [(8, 1), (15, 15)], [4, 4, 4, 4]),
    "border_capture": ([(0, 7), (0, 9), (1, 8), (15, 15)], [(0, 8), (15, 0)], [4, 4, 4, 4]),
    "sequential_submoves": ([(3, 1), (13, 1)], [(1, 1), (13, 2)], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(UPSTREAM))
def test_step_matches_upstream(case):
    pytest.importorskip("pettingzoo")
    ppos, epos, actions = UPSTREAM[case]
    up = make_upstream(len(ppos), len(epos))
    base = inject(up, ppos, epos)
    obs_u, rew_u, _, _, _ = up.step({a: int(actions[i]) for i, a in enumerate(up.agents)})
    env = Pursuit(n_pursuers=len(ppos), n_evaders=len(epos), freeze_evaders=True, device="cpu")
    s2, ts = env.step(port_state(ppos, epos), torch.as_tensor([actions]))
    np.testing.assert_allclose(float(ts.reward[0]), float(rew_u[up.agents[0]]), atol=ATOL)
    for i, a in enumerate(obs_u):
        np.testing.assert_allclose(ts.obs[0, i].numpy(), obs_u[a].reshape(-1), atol=ATOL,
                                   err_msg=f"obs of agent {i}")
    for i in range(len(ppos)):
        np.testing.assert_array_equal(s2.ppos[0, i].numpy(),
                                      np.asarray(base.pursuer_layer.get_position(i)))
    assert int(s2.ealive.sum()) == base.evader_layer.n_agents()
    if case in ("surround_capture", "border_capture"):
        assert not bool(s2.ealive[0, 0]) and bool(s2.ealive[0, 1])
        assert float(ts.reward[0]) > (4.0 if case == "surround_capture" else 0.0)


def test_multi_cycle_random_rollout_matches_upstream():
    pytest.importorskip("pettingzoo")
    rng = np.random.RandomState(3)
    ppos = [(1, 1), (3, 1), (1, 14), (14, 1), (14, 14), (3, 14)]
    epos = [(2, 2), (2, 13), (13, 2), (13, 13), (0, 7)]
    up = make_upstream(len(ppos), len(epos))
    inject(up, ppos, epos)
    env = Pursuit(n_pursuers=len(ppos), n_evaders=len(epos), freeze_evaders=True, device="cpu")
    s = port_state(ppos, epos)
    for cycle in range(12):
        actions = rng.randint(0, 5, len(ppos))
        obs_u, rew_u, _, _, _ = up.step({a: int(actions[i]) for i, a in enumerate(up.agents)})
        s, ts = env.step(s, torch.as_tensor(actions)[None])
        if not up.agents:
            assert bool(ts.done[0])
            break
        np.testing.assert_allclose(float(ts.reward[0]), float(rew_u[list(rew_u)[0]]),
                                   atol=ATOL, err_msg=f"cycle {cycle}")
        for i, a in enumerate(list(obs_u)):
            np.testing.assert_allclose(ts.obs[0, i].numpy(), obs_u[a].reshape(-1), atol=ATOL,
                                       err_msg=f"obs of agent {i}, cycle {cycle}")
        assert int(s.ealive.sum()) == up.unwrapped.env.evader_layer.n_agents()


# ---------------------------------------------------------------------------
# against the JAX env
# ---------------------------------------------------------------------------

def _batched_port_state(states):
    return state_from_numpy(PursuitState, {k: np.stack([np.asarray(getattr(s, k))
                                                        for s in states])
                                           for k in _np_state(states[0])}, "cpu")


def _scenario_states(jenv, n_random):
    """JAX states: the capture scenarios, the other pursuers and evaders on
    open cells away from them, and ``n_random`` resets."""
    P, E = jenv.n_pursuers, jenv.n_evaders
    bmap = jpursuit.rectangle_map(16, 16)
    states = []
    for ppos, epos in (([(7, 1), (9, 1), (8, 0), (8, 2)], [(8, 1), (15, 15)]),
                       ([(0, 7), (0, 9), (1, 8), (15, 15)], [(0, 8), (15, 0)]),
                       ([(8, 1), (8, 1), (3, 3), (12, 12)], [(8, 1), (1, 14)])):
        far = [(x, y) for x in range(16) for y in range(16) if bmap[x, y] == 0
               and min(abs(x - a) + abs(y - b) for a, b in ppos + epos) > 2]
        pp = np.array(ppos + far[::-1][:P - len(ppos)], np.int32)
        ep = np.array(epos + far[:E - len(epos)], np.int32)
        s, _ = jenv.reset(jax.random.PRNGKey(0))
        states.append(s.replace(ppos=jnp.asarray(pp), epos=jnp.asarray(ep)))
    for i in range(n_random):
        states.append(jax.jit(jenv.reset)(jax.random.PRNGKey(100 + i))[0])
    return states


@pytest.mark.parametrize("kw", [dict(), dict(surround=False, n_catch=2),
                                dict(n_pursuers=4, n_evaders=6, time_limit=3)],
                         ids=["surround", "n_catch", "small_truncates"])
def test_batched_steps_match_jax(kw):
    jenv, tenv = jpursuit.Pursuit(**kw), Pursuit(**kw, device="cpu")
    jstep = jax.jit(jenv.step)
    states = _scenario_states(jenv, n_random=3)
    tstate = _batched_port_state(states)
    rng = np.random.RandomState(1)
    caught = 0
    for step in range(4):
        actions = rng.randint(0, 5, (len(states), jenv.n_pursuers))
        if step == 0:
            actions[:3] = 4                     # the scenarios stay put
        keys = jax.random.split(jax.random.PRNGKey(step), len(states))
        feed_jax_draws(tenv, keys)
        tstate, ts = tenv.step(tstate, torch.as_tensor(actions))
        out = [jstep(s, jnp.asarray(actions[i], jnp.int32), keys[i])
               for i, s in enumerate(states)]
        for i, (js, jts) in enumerate(out):
            where = f"env {i} step {step}"
            for k in ("obs", "state", "reward", "done", "truncated"):
                np.testing.assert_allclose(getattr(ts, k)[i].numpy(),
                                           np.asarray(getattr(jts, k)), atol=ATOL,
                                           err_msg=f"{where} {k}")
            for k in ("ppos", "epos", "ealive", "t"):
                np.testing.assert_array_equal(getattr(tstate, k)[i].numpy(),
                                              np.asarray(getattr(js, k)), err_msg=where)
        caught += int((~tstate.ealive[:3, 0]).sum())
        states = [js for js, _ in out]
    assert caught > 0                            # a capture branch ran
    if "time_limit" in kw:
        assert bool(ts.truncated.all())


def test_vecenv_auto_reset_keeps_the_final_view():
    tenv = Pursuit(n_pursuers=4, n_evaders=6, time_limit=2, device="cpu")
    vec = VecEnv(tenv, 5)
    gen = torch.Generator().manual_seed(0)
    s, ts = vec.reset(gen)
    acts = torch.full((5, 4), 4)
    s, ts, final = vec.step(s, acts, gen)
    assert not ts.truncated.any() and (s.t == 1).all()
    s, ts, final = vec.step(s, acts, gen)
    assert final.truncated.all() and (s.t == 0).all()
    assert not torch.equal(ts.obs, final.obs)


def test_transcript_replays():
    z = np.load(TRANSCRIPT)
    kwargs = json.loads(str(z["meta_env_kwargs"]))
    jenv, tenv = jpursuit.Pursuit(**kwargs), Pursuit(**kwargs, device="cpu")
    assert (tenv.n_agents, tenv.obs_dim, tenv.state_dim, tenv.n_actions,
            tenv.episode_limit) == (int(z["meta_n_agents"]), int(z["meta_obs_dim"]),
                                    int(z["meta_state_dim"]), int(z["meta_n_actions"]),
                                    int(z["meta_episode_limit"]))
    seed, ep_prev, state = int(z["meta_seed"]), -1, None
    for i in range(len(z["t"])):
        ep, t = int(z["ep"][i]), int(z["t"][i])
        if ep != ep_prev:
            js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(seed * 1000 + ep))
            state = state_from_numpy(PursuitState, _np_state(js), "cpu", batched=False)
            ep_prev = ep
        feed_jax_draws(tenv, [jax.random.PRNGKey(seed * 100000 + ep * 1000 + t)])
        state, ts = tenv.step(state, torch.as_tensor(z["action"][i])[None])
        where = f"ep={ep} t={t}"
        np.testing.assert_allclose(ts.obs[0].numpy(), z["obs"][i], atol=ATOL, err_msg=where)
        np.testing.assert_allclose(ts.state[0].numpy(), z["state"][i], atol=ATOL,
                                   err_msg=where)
        np.testing.assert_array_equal(ts.avail[0].numpy(), z["avail"][i], err_msg=where)
        np.testing.assert_allclose(float(ts.reward[0]), float(z["reward"][i]), atol=ATOL,
                                   err_msg=where)
        assert bool(ts.done[0]) == bool(z["done"][i]), where
        assert bool(ts.truncated[0]) == bool(z["truncated"][i]), where


# ---------------------------------------------------------------------------
# tables, spawn, guard
# ---------------------------------------------------------------------------

def test_static_tables_match_jax():
    jenv, tenv = jpursuit.Pursuit(), Pursuit(device="cpu")
    np.testing.assert_array_equal(tenv._need.numpy(),
                                  np.asarray(jenv.need_to_surround).reshape(-1))
    np.testing.assert_array_equal(pursuit.rectangle_map(16, 16),
                                  jpursuit.rectangle_map(16, 16))
    assert (tenv.obs_dim, tenv.state_dim, tenv.n_actions) == (jenv.obs_dim, jenv.state_dim,
                                                             jenv.n_actions)


def test_spawn_rules():
    env = Pursuit(device="cpu")
    state, ts = env.reset(64, torch.Generator().manual_seed(0))
    bmap = pursuit.rectangle_map(16, 16)
    for group in (state.ppos.numpy(), state.epos.numpy()):
        assert (bmap[group[..., 0], group[..., 1]] == 0.0).all()       # never in the building
        # same-group agents are never on or next to each other
        d = np.abs(group[:, :, None] - group[:, None]).sum(-1)
        off_diag = ~np.eye(group.shape[1], dtype=bool)
        assert (d[:, off_diag] > 1).all()
    assert state.ealive.all() and (state.t == 0).all() and ts.obs.shape == (64, 8, 147)
    # the draws cover the open cells, not a fixed layout
    assert len({tuple(p) for p in state.ppos[:, 0].tolist()}) > 20


def test_vdn_update_at_the_vdn_pursuit_widths_matches_jax():
    """One VDN update at ``vdn_pursuit``'s widths (8 pursuers, obs 147 + 8
    agent ids, hidden 64, 4 x 32 transitions drawn from a ring; the ring
    itself cut to 512 rows) after a first one, against the JAX package's
    own ``update`` reached through ``train_block``'s closures: loss, grad
    norm and new params at 1e-5."""
    from cleanmarl_tpu.algos import vdn as jvdn
    from cleanmarl_tpu.buffers.transition import TransitionBuffer as JBuffer
    from cleanmarl_tpu.types import Transition as JTransition
    from cleanmarl_tpu_torch.algos import vdn
    from cleanmarl_tpu_torch.core.params import from_numpy_tree, opt_state_from_numpy, tree_map
    from cleanmarl_tpu_torch.envs import registry
    from cleanmarl_tpu_torch.types import Transition

    kw = dict(env_type="pursuit", num_envs=32, total_timesteps=2_000_000, buffer_size=512,
              batch_size=4, learning_starts=10_000, train_freq=1, exploration_fraction=0.1,
              hidden_dim=64, log_interval=200, seed=0)
    jinit, jblock, _ = jvdn.make_train(jvdn.VDNConfig(**kw))
    fn = jblock.__wrapped__
    train_iter = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[
        "train_iter"]
    j_update = dict(zip(train_iter.__code__.co_freevars,
                        (c.cell_contents for c in train_iter.__closure__)))["update"]
    runner_j = jinit(jax.random.PRNGKey(0))
    env = registry.make("pursuit", "", agent_ids=True, device="cpu")
    n, O, S = env.n_agents, env.obs_dim, env.state_dim
    rng = np.random.RandomState(0)
    rows = 300
    rec = dict(obs=rng.rand(rows, n, O).astype(np.float32),
               state=rng.rand(rows, S).astype(np.float32), avail=np.ones((rows, n, 5), bool),
               action=rng.randint(0, 5, (rows, n)).astype(np.int32),
               reward=(rng.randn(rows) - 0.1).astype(np.float32), done=rng.rand(rows) < 0.01,
               next_obs=rng.rand(rows, n, O).astype(np.float32),
               next_state=rng.rand(rows, S).astype(np.float32),
               next_avail=np.ones((rows, n, 5), bool))
    jbuf = JBuffer.create(512, JTransition(**{k: jnp.asarray(v[0]) for k, v in rec.items()}))
    jbuf = jbuf.add_batch(JTransition(**{k: jnp.asarray(v) for k, v in rec.items()}))
    leaves, tdef = jax.tree.flatten(runner_j.params)
    target = jax.tree.unflatten(tdef, [p + 0.05 * jax.random.normal(jax.random.PRNGKey(i), p.shape)
                                       for i, p in enumerate(leaves)])
    params, opt_state, _, _ = j_update(runner_j.params, target, runner_j.opt_state, jbuf,
                                       jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    batch = jbuf.sample(key, 4 * 32)               # the rows the JAX update draws
    want_p, _, want_loss, want_gnorm = j_update(params, target, opt_state, jbuf, key)

    _, _, _, meta = vdn.make_train(vdn.VDNConfig(**kw, device="cpu"), env)
    tb = {k: torch.as_tensor(np.array(getattr(batch, k))) for k in rec}
    tb["action"] = tb["action"].long()
    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    got_p, got_o, loss, gnorm = meta["update"](
        from_numpy_tree(np_tree(params), "cpu"), from_numpy_tree(np_tree(target), "cpu"),
        opt_state_from_numpy(np_tree(opt_state), "cpu"), Transition(**tb))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(gnorm), float(want_gnorm), rtol=1e-5, atol=1e-5)
    tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5),
             got_p, np_tree(want_p))
    assert got_o["count"] == 2


def test_spawn_exhaustion_guard():
    with pytest.raises(ValueError, match="open cells"):
        Pursuit(n_evaders=50, device="cpu")
