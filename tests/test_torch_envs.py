"""Port parity: the batched envs of ``cleanmarl_tpu_torch.envs`` against
the JAX package's envs.

- SMAClite transcripts replay at atol=1e-6 (the JAX package's own
  transcript tolerance), each episode started from the JAX reset state,
  converted (reset jitter comes from another generator, stepping is
  deterministic);
- one batched ``VecEnv.step`` equals the JAX ``env.step`` run per env on
  the same states, with auto-reset and the pre-reset ``final``;
- the matrix game, ``AgentIDWrapper`` and the registry.
"""
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from cleanmarl_tpu.envs import registry as jreg
from cleanmarl_tpu_torch.envs import registry as treg
from cleanmarl_tpu_torch.envs.base import VecEnv, state_from_numpy
from cleanmarl_tpu_torch.envs.matrix_game import MatrixGameState
from cleanmarl_tpu_torch.envs.smaclite import SmacState

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = sorted(glob.glob(os.path.join(REPO, "validation", "transcripts",
                                      "smaclite_*.npz")))
ATOL = 1e-6


def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


@pytest.mark.parametrize("path", PATHS, ids=[os.path.basename(p) for p in PATHS])
def test_smaclite_transcript_replays(path):
    z = np.load(path)
    kwargs = json.loads(str(z["meta_env_kwargs"])) if "meta_env_kwargs" in z.files else {}
    name = str(z["meta_env_name"])
    jenv = jreg.make("smaclite", name, agent_ids=False, **kwargs)
    tenv = treg.make("smaclite", name, agent_ids=False, device="cpu", **kwargs)
    assert (tenv.n_agents, tenv.obs_dim, tenv.state_dim, tenv.n_actions) == (
        int(z["meta_n_agents"]), int(z["meta_obs_dim"]), int(z["meta_state_dim"]),
        int(z["meta_n_actions"]))
    seed = int(z["meta_seed"])
    ep_prev, state = -1, None
    for i in range(len(z["t"])):
        ep, t = int(z["ep"][i]), int(z["t"][i])
        if ep != ep_prev:
            js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(seed * 1000 + ep))
            state = state_from_numpy(SmacState, _np_state(js), "cpu", batched=False)
            ep_prev = ep
        state, ts = tenv.step(state, torch.as_tensor(z["action"][i])[None])
        where = f"{os.path.basename(path)} ep={ep} t={t}"
        np.testing.assert_allclose(ts.obs[0].numpy(), z["obs"][i], atol=ATOL,
                                   err_msg=where + " obs")
        np.testing.assert_allclose(ts.state[0].numpy(), z["state"][i], atol=ATOL,
                                   err_msg=where + " state")
        np.testing.assert_array_equal(ts.avail[0].numpy(), z["avail"][i],
                                      err_msg=where + " avail")
        np.testing.assert_allclose(float(ts.reward[0]), float(z["reward"][i]),
                                   atol=ATOL, err_msg=where + " reward")
        assert bool(ts.done[0]) == bool(z["done"][i]), where
        assert bool(ts.truncated[0]) == bool(z["truncated"][i]), where


def _random_actions(rng, avail):
    """One uniformly random available action per (env, agent)."""
    u = rng.rand(*avail.shape) * avail
    return u.argmax(-1)


@pytest.mark.parametrize("name", ["3m", "2s3z", "MMM"])
def test_batched_vecenv_step_matches_jax_per_env(name):
    N = 6
    jenv = jreg.make("smaclite", name, agent_ids=True)
    tenv = treg.make("smaclite", name, agent_ids=True, device="cpu")
    rng = np.random.RandomState(0)
    jstep = jax.jit(jenv.step)
    # per-env JAX states at different points of an episode
    states = []
    for i in range(N):
        s, ts = jax.jit(jenv.reset)(jax.random.PRNGKey(i))
        for _ in range(3 * i):
            s, ts = jstep(s, _random_actions(rng, np.asarray(ts.avail)),
                          jax.random.PRNGKey(0))
        states.append((s, ts))
    # envs 0 and 3 are one step from the time limit → they truncate
    states = [(s.replace(t=s.t + (jenv.episode_limit - 1 - int(s.t)) * (i % 3 == 0)), ts)
              for i, (s, ts) in enumerate(states)]
    actions = np.stack([_random_actions(rng, np.asarray(ts.avail)) for _, ts in states])
    want = [jstep(s, actions[i], jax.random.PRNGKey(1)) for i, (s, _) in enumerate(states)]

    batched = {k: np.stack([np.asarray(getattr(s, k)) for s, _ in states])
               for k in _np_state(states[0][0])}
    tstate = state_from_numpy(SmacState, batched, "cpu")
    vec = VecEnv(tenv, N)
    new_state, out, final = vec.step(tstate, torch.as_tensor(actions),
                                     torch.Generator().manual_seed(5))
    _, reset_ts = tenv.reset(N, torch.Generator().manual_seed(5))

    for i, (_, jts) in enumerate(want):
        for k in ("obs", "state", "reward"):
            np.testing.assert_allclose(getattr(final, k)[i].numpy(),
                                       np.asarray(getattr(jts, k)), atol=ATOL,
                                       err_msg=f"env {i} final {k}")
        np.testing.assert_array_equal(final.avail[i].numpy(), np.asarray(jts.avail))
        assert bool(final.done[i]) == bool(jts.done)
        assert bool(final.truncated[i]) == bool(jts.truncated)
        assert float(final.info["battle_won"][i]) == float(jts.info["battle_won"])
    ended = (final.done | final.truncated).numpy()
    assert ended[0] and ended[3] and not ended.all()
    for k in ("reward", "done", "truncated"):
        torch.testing.assert_close(getattr(out, k), getattr(final, k))
    for k in ("obs", "state", "avail"):
        src = np.where(ended.reshape((-1,) + (1,) * (getattr(out, k).dim() - 1)),
                       getattr(reset_ts, k).numpy(), getattr(final, k).numpy())
        np.testing.assert_array_equal(getattr(out, k).numpy(), src, err_msg=k)
    assert (new_state.t.numpy() == np.where(ended, 0, final_t(states) + 1)).all()


def final_t(states):
    return np.array([int(s.t) for s, _ in states])


@pytest.mark.parametrize("kw", [{}, {"done_on_jackpot": True},
                                {"mask_trick": False, "n_agents": 3, "n_actions": 4}],
                         ids=["default", "jackpot", "no_mask"])
def test_matrix_game_matches_jax(kw):
    N = 5
    jenv = jreg.make("matrix", "", **kw)
    tenv = treg.make("matrix", "", device="cpu", **kw)
    rng = np.random.RandomState(1)
    s_t, ts_t = tenv.reset(N)
    js = [jenv.reset(jax.random.PRNGKey(i))[0] for i in range(N)]
    for step in range(jenv.episode_limit + 2):
        avail = ts_t.avail.numpy()
        act = _random_actions(rng, avail)
        if step % 3 == 0:   # everyone on target: jackpot
            act[:] = (s_t.t.numpy() % tenv.n_actions)[:, None]
        s_t, ts_t = tenv.step(s_t, torch.as_tensor(act))
        for i in range(N):
            js[i], jts = jenv.step(js[i], act[i], jax.random.PRNGKey(0))
            for k in ("obs", "state", "avail", "reward", "done", "truncated"):
                np.testing.assert_allclose(np.asarray(getattr(ts_t, k)[i]),
                                           np.asarray(getattr(jts, k)), atol=ATOL,
                                           err_msg=f"{k} step {step}")
            assert float(ts_t.info["battle_won"][i]) == float(jts.info["battle_won"])
        # restart ended envs in both
        ended = (ts_t.done | ts_t.truncated).numpy()
        s_t = MatrixGameState(t=torch.where(torch.as_tensor(ended), 0, s_t.t))
        js = [jenv.reset(jax.random.PRNGKey(0))[0] if ended[i] else js[i]
              for i in range(N)]
        ts_t = ts_t.replace(avail=tenv._avail(s_t.t))


def test_agent_id_wrapper_matches_jax():
    jenv = jreg.make("smaclite", "3m", agent_ids=True)
    tenv = treg.make("smaclite", "3m", agent_ids=True, device="cpu")
    assert tenv.obs_dim == jenv.obs_dim == jenv.env.obs_dim + 3
    js, jts = jenv.reset(jax.random.PRNGKey(0))
    s = state_from_numpy(SmacState, _np_state(js), "cpu", batched=False)
    ts = tenv.env._timestep(s, torch.zeros(1), torch.zeros(1, dtype=torch.bool),
                            torch.zeros(1, dtype=torch.bool), torch.zeros(1))
    obs = tenv._augment(ts).obs[0].numpy()
    np.testing.assert_allclose(obs, np.asarray(jts.obs), atol=ATOL)
    np.testing.assert_array_equal(obs[:, -3:], np.eye(3))


def test_registry_and_unported_options_raise():
    for env_type in ("mpe", "lbf", "pursuit", "pz"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            treg.make(env_type, "x")
    with pytest.raises(ValueError):
        treg.make("nope", "x")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treg.make("smaclite", "3m", unit_collisions=True)


def test_sampling_respects_avail():
    tenv = treg.make("smaclite", "3m", device="cpu")
    _, ts = tenv.reset(64, torch.Generator().manual_seed(0))
    a = tenv.sample(torch.Generator().manual_seed(1), ts.avail)
    assert torch.gather(ts.avail, -1, a[..., None]).all()
