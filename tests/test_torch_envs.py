"""Port parity: the batched envs of ``cleanmarl_tpu_torch.envs`` against
the JAX package's envs.

- SMAClite transcripts replay at atol=1e-6 (the JAX package's own
  transcript tolerance), each episode started from the JAX reset state,
  converted (reset jitter comes from another generator, stepping is
  deterministic);
- one batched ``VecEnv.step`` equals the JAX ``env.step`` run per env on
  the same states, with auto-reset and the pre-reset ``final``;
- the first step of a ``make_vec`` batch equals the JAX ``make_vec``'s;
- the matrix game, ``AgentIDWrapper`` and the registry.
"""
import glob
import importlib.util
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


@pytest.mark.parametrize("name", ["3m", "2s3z", "MMM", "3s5z", "MMM2", "5m_vs_6m", "8m_vs_9m",
                                  "27m_vs_30m"])
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


def test_make_vec_first_step_matches_jax():
    """``registry.make_vec`` against the JAX ``make_vec`` on 3m: the same
    widths, and from the JAX reset state one batched step equals the JAX
    batch's (no env ends on a first step)."""
    N = 4
    jvec = jreg.make_vec("smaclite", "3m", N, agent_ids=True)
    tvec = treg.make_vec("smaclite", "3m", N, agent_ids=True, device="cpu")
    assert isinstance(tvec, VecEnv) and tvec.auto_reset and tvec.device == torch.device("cpu")
    widths = ("num_envs", "n_agents", "obs_dim", "state_dim", "n_actions", "episode_limit")
    assert [getattr(tvec, k) for k in widths] == [getattr(jvec, k) for k in widths]
    js, jts = jax.jit(jvec.reset)(jax.random.PRNGKey(0))
    actions = _random_actions(np.random.RandomState(0), np.asarray(jts.avail))
    _, jout, _ = jax.jit(jvec.step)(js, actions, jax.random.PRNGKey(1))
    tstate = state_from_numpy(SmacState, _np_state(js), "cpu")
    _, out, _ = tvec.step(tstate, torch.as_tensor(actions), torch.Generator().manual_seed(1))
    for k in ("obs", "state", "reward"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                   atol=ATOL, err_msg=k)
    for k in ("avail", "done", "truncated"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(jout, k)),
                                      err_msg=k)


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


BUILDS = {
    "matrix": ("matrix", "", {}, "MatrixGame"),
    "mpe": ("mpe", "simple_spread_v3", {}, "SimpleSpread"),
    "pz_mpe": ("pz", "simple_spread_v3", {}, "SimpleSpread"),
    "pz_sisl_host": ("pz", "pursuit_v4", dict(env_family="sisl"), "HostEnvFamily"),
    "smaclite_collisions": ("smaclite", "3m", dict(unit_collisions=True), "MicroCombat"),
    "pursuit": ("pursuit", "pursuit_v4", {}, "Pursuit"),
    "lbf_coop": ("lbf", "Foraging-10x10-3p-4f-coop-v3", {}, "LBF"),
}
UNKNOWN = (  # env_type, name, the error
    ("mpe", "x", "unknown MPE scenario"), ("pz", "x", "unknown MPE scenario"),
    ("nope", "x", "unknown env_type"), ("lbf", "Foraging-weird", "unknown LBF map"),
    ("smaclite", "x", "unknown smaclite map"))


def test_registry_and_unported_options_raise():
    """Every family now builds through the registry (nothing raises
    NotImplementedError) on the device asked for; unknown names raise
    ValueError."""
    for case, (env_type, name, kw, cls) in BUILDS.items():
        if case == "pz_sisl_host" and importlib.util.find_spec("pettingzoo") is None:
            continue
        env = treg.make(env_type, name, device="cpu", **kw)
        assert type(env).__name__ == cls and env.device == torch.device("cpu"), case
    assert treg.make("smaclite", "3m", device="cpu", unit_collisions=True).unit_collisions
    lbf = treg.make("lbf", "Foraging-10x10-3p-4f-coop-v3", device="cpu")
    assert lbf.coop and (lbf.grid_size, lbf.n_agents, lbf.n_foods) == (10, 3, 4)
    for env_type, name, match in UNKNOWN:
        with pytest.raises(ValueError, match=match):
            treg.make(env_type, name, device="cpu")


@pytest.mark.parametrize("factory", ["registry", "make_vec", "smaclite", "mpe", "matrix",
                                     "lbf", "pursuit"])
def test_env_factories_default_to_the_card(factory):
    """Without a device argument every env factory and family constructor
    asks for the card, which raises on a machine without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cleanmarl_tpu_torch.envs import lbf, mpe, pursuit, smaclite
    from cleanmarl_tpu_torch.envs.matrix_game import MatrixGame

    build = {"registry": lambda: treg.make("smaclite", "3m"),
             "make_vec": lambda: treg.make_vec("smaclite", "3m", 4),
             "smaclite": lambda: smaclite.MicroCombat(3, 3),
             "mpe": lambda: mpe.make("simple_spread_v3"),
             "matrix": lambda: MatrixGame(),
             "lbf": lambda: lbf.make("Foraging-8x8-2p-3f-v3"),
             "pursuit": lambda: pursuit.Pursuit()}[factory]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_sampling_respects_avail():
    tenv = treg.make("smaclite", "3m", device="cpu")
    _, ts = tenv.reset(64, torch.Generator().manual_seed(0))
    a = tenv.sample(torch.Generator().manual_seed(1), ts.avail)
    assert torch.gather(ts.avail, -1, a[..., None]).all()


# ---------------------------------------------------------------------------
# SMAClite unit_collisions (tests/test_envs_smaclite.py:530-575), held
# against the JAX env at ATOL
# ---------------------------------------------------------------------------

COLLISION_CASES = {
    # two live allies 0.2 apart are pushed apart (the JAX test's scenario)
    "overlap_pushout": dict(ally_pos=[[16.0, 16.0], [16.2, 16.0]],
                            enemy_pos=[[30.0, 2.0], [30.0, 4.0]], actions=[1, 1]),
    # an overlapping corpse neither pushes nor gets pushed
    "dead_unit": dict(ally_pos=[[16.0, 16.0], [16.1, 16.0]],
                      enemy_pos=[[30.0, 2.0], [30.0, 4.0]], actions=[1, 0], dead_ally=1),
    # a clump of allies and enemies at the map's edge, clipped to it
    "clump_at_edge": dict(ally_pos=[[0.6, 0.6], [0.9, 0.7], [0.5, 1.0]],
                          enemy_pos=[[1.2, 0.5], [0.7, 1.3]], actions=[1, 1, 1]),
}


@pytest.mark.parametrize("case", sorted(COLLISION_CASES))
def test_unit_collisions_match_jax(case):
    from cleanmarl_tpu.envs.smaclite import MicroCombat as JMC
    from cleanmarl_tpu_torch.envs.smaclite import UNIT_RADIUS, MicroCombat

    c = COLLISION_CASES[case]
    A, E = len(c["ally_pos"]), len(c["enemy_pos"])
    jenv = JMC(A, E, time_limit=50, unit_collisions=True)
    tenv = MicroCombat(A, E, time_limit=50, unit_collisions=True, device="cpu")
    js, _ = jenv.reset(jax.random.PRNGKey(0))
    js = js.replace(ally_pos=jax.numpy.asarray(c["ally_pos"]),
                    enemy_pos=jax.numpy.asarray(c["enemy_pos"]))
    if "dead_ally" in c:
        js = js.replace(ally_hp=js.ally_hp.at[c["dead_ally"]].set(0.0))
    actions = np.asarray(c["actions"], np.int32)
    js2, jts = jenv.step(js, actions, jax.random.PRNGKey(1))
    s2, ts = tenv.step(state_from_numpy(SmacState, _np_state(js), "cpu", batched=False),
                       torch.as_tensor(actions)[None])
    for k in ("ally_pos", "enemy_pos"):
        np.testing.assert_allclose(getattr(s2, k)[0].numpy(), np.asarray(getattr(js2, k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ts.obs[0].numpy(), np.asarray(jts.obs), atol=ATOL)
    np.testing.assert_allclose(ts.state[0].numpy(), np.asarray(jts.state), atol=ATOL)
    if case == "overlap_pushout":
        gap = float(torch.linalg.norm(s2.ally_pos[0, 0] - s2.ally_pos[0, 1]))
        assert 0.2 < gap <= 2.0 * UNIT_RADIUS + 1e-5
    if case == "dead_unit":
        np.testing.assert_allclose(s2.ally_pos[0].numpy(), c["ally_pos"])


def test_unit_collisions_batched_rollout_matches_jax():
    """Six 3m envs with collisions on, stepped 20 times with random
    available actions from spawns squeezed together: one batched torch
    step per step against the JAX step per env, obs, state, reward and
    positions at ATOL."""
    N = 6
    jenv = jreg.make("smaclite", "3m", unit_collisions=True)
    tenv = treg.make("smaclite", "3m", unit_collisions=True, device="cpu")
    jstep = jax.jit(jenv.step)
    rng = np.random.RandomState(3)
    states = []
    for i in range(N):
        s, ts = jax.jit(jenv.reset)(jax.random.PRNGKey(i))
        # squeeze the teams together so units overlap from the first step
        s = s.replace(ally_pos=16.0 + 0.3 * (s.ally_pos - s.ally_pos.mean(0)),
                      enemy_pos=16.5 + 0.3 * (s.enemy_pos - s.enemy_pos.mean(0)))
        states.append((s, jenv._avail(s)))
    tstate = state_from_numpy(SmacState, {k: np.stack([np.asarray(getattr(s, k))
                                                       for s, _ in states])
                                          for k in _np_state(states[0][0])}, "cpu")
    for step in range(20):
        actions = np.stack([_random_actions(rng, np.asarray(av)) for _, av in states])
        tstate, ts = tenv.step(tstate, torch.as_tensor(actions))
        out = [jstep(s, actions[i], jax.random.PRNGKey(0)) for i, (s, _) in enumerate(states)]
        for i, (js, jts) in enumerate(out):
            where = f"env {i} step {step}"
            for k in ("ally_pos", "enemy_pos"):
                np.testing.assert_allclose(getattr(tstate, k)[i].numpy(),
                                           np.asarray(getattr(js, k)), atol=ATOL,
                                           err_msg=where + " " + k)
            np.testing.assert_allclose(ts.obs[i].numpy(), np.asarray(jts.obs), atol=ATOL,
                                       err_msg=where)
            np.testing.assert_allclose(float(ts.reward[i]), float(jts.reward), atol=ATOL)
        states = [(js, jts.avail) for js, jts in out]
