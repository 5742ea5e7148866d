"""Port parity: Level-Based Foraging of ``cleanmarl_tpu_torch`` (``envs/lbf.py``)
against the JAX package's env (``tests/test_envs_lbf.py``).

- the committed ``lbf_8x8_2p_3f.npz`` transcript replays at atol=1e-6
  (the JAX package's transcript tolerance), each episode started from the
  JAX reset state (reset draws come from another generator; stepping is
  deterministic);
- one batched ``VecEnv.step`` equals the JAX ``env.step`` run per env on
  the same states, with the auto-reset, the pre-reset ``final`` and the
  per-agent rewards;
- the JAX behaviour tests' scenarios (movement bounds and food blocks, move
  conflicts, solo and joint loads, eaten-food obs, mean aggregation, coop
  maps) run through both envs from the same injected state: obs, state,
  reward, per-agent rewards and the new state at 1e-6, plus the JAX
  tests' own assertions;
- map-name parsing and the reset's layout rules.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.envs import lbf as jlbf
from cleanmarl_tpu_torch.envs import lbf
from cleanmarl_tpu_torch.envs.base import VecEnv, state_from_numpy
from cleanmarl_tpu_torch.envs.lbf import EAST, LOAD, NORTH, WEST, LBFState

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSCRIPT = os.path.join(REPO, "validation", "transcripts", "lbf_8x8_2p_3f.npz")
ATOL = 1e-6


def _np_state(s):
    return {k: np.asarray(v) for k, v in s.items()}


def test_transcript_replays():
    z = np.load(TRANSCRIPT)
    name = str(z["meta_env_name"])
    jenv, tenv = jlbf.make(name), lbf.make(name, device="cpu")
    assert (tenv.n_agents, tenv.obs_dim, tenv.state_dim, tenv.n_actions) == (
        int(z["meta_n_agents"]), int(z["meta_obs_dim"]), int(z["meta_state_dim"]),
        int(z["meta_n_actions"]))
    seed, ep_prev, state = int(z["meta_seed"]), -1, None
    reset = jax.jit(jenv.reset)
    for i in range(len(z["t"])):
        ep, t = int(z["ep"][i]), int(z["t"][i])
        if ep != ep_prev:
            js, _ = reset(jax.random.PRNGKey(seed * 1000 + ep))
            state = state_from_numpy(LBFState, _np_state(js), "cpu", batched=False)
            ep_prev = ep
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
    assert z["done"].any() and z["reward"].sum() > 0      # loads and a terminal ran


@pytest.mark.parametrize("name,aggr", [("Foraging-8x8-2p-3f-v3", "sum"),
                                       ("Foraging-6x6-3p-2f-coop-v3", "mean")])
def test_batched_vecenv_step_matches_jax_per_env(name, aggr):
    N = 8
    jenv = jlbf.make(name, reward_aggr=aggr)
    tenv = lbf.make(name, reward_aggr=aggr, device="cpu")
    rng = np.random.RandomState(0)
    jstep = jax.jit(jenv.step)
    states = []
    for i in range(N):
        s, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(i))
        for _ in range(4 * i):
            s, _ = jstep(s, jnp.asarray(rng.randint(0, 6, jenv.n_agents)),
                         jax.random.PRNGKey(0))
        states.append(s)
    # envs 0 and 4 are one step from the time limit
    states = [s.replace(t=jnp.asarray(jenv.episode_limit - 1 if i % 4 == 0 else int(s.t)))
              for i, s in enumerate(states)]
    # loaders next to their food: LOAD is likely to collect somewhere
    actions = np.where(rng.rand(N, jenv.n_agents) < 0.5, LOAD,
                       rng.randint(0, 6, (N, jenv.n_agents)))
    want = [jstep(s, jnp.asarray(actions[i]), jax.random.PRNGKey(1))[1]
            for i, s in enumerate(states)]
    tstate = state_from_numpy(LBFState, {k: np.stack([np.asarray(getattr(s, k))
                                                      for s in states])
                                         for k in _np_state(states[0])}, "cpu")
    vec = VecEnv(tenv, N)
    _, out, final = vec.step(tstate, torch.as_tensor(actions),
                             torch.Generator().manual_seed(5))
    _, reset_ts = tenv.reset(N, torch.Generator().manual_seed(5))
    for i, jts in enumerate(want):
        for k in ("obs", "state", "reward"):
            np.testing.assert_allclose(getattr(final, k)[i].numpy(), np.asarray(getattr(jts, k)),
                                       atol=ATOL, err_msg=f"env {i} {k}")
        np.testing.assert_allclose(final.info["agent_rewards"][i].numpy(),
                                   np.asarray(jts.info["agent_rewards"]), atol=ATOL)
        assert bool(final.done[i]) == bool(jts.done)
        assert bool(final.truncated[i]) == bool(jts.truncated)
    ended = (final.done | final.truncated).numpy()
    assert ended[0] and ended[4]
    for k in ("obs", "state"):
        src = np.where(ended.reshape((-1,) + (1,) * (getattr(out, k).dim() - 1)),
                       getattr(reset_ts, k).numpy(), getattr(final, k).numpy())
        np.testing.assert_array_equal(getattr(out, k).numpy(), src, err_msg=k)


# scenarios of tests/test_envs_lbf.py: players, foods, player levels, food
# levels, actions, env kwargs
SCENARIOS = {
    "bounds_and_east": ([[0, 0], [3, 3]], [[0, 1]], [1, 1], [2], [NORTH, EAST],
                        dict(grid_size=5, n_foods=1)),
    "east_into_food": ([[0, 0], [3, 3]], [[0, 1]], [1, 1], [2], [EAST, 0],
                       dict(grid_size=5, n_foods=1)),
    "move_conflict": ([[2, 1], [2, 3]], [[4, 4]], [1, 1], [1], [EAST, WEST],
                      dict(grid_size=5, n_foods=1)),
    "solo_load": ([[1, 1], [4, 4]], [[1, 2], [0, 4]], [2, 1], [2, 2], [LOAD, 0],
                  dict(grid_size=5, n_foods=2)),
    "under_leveled_load": ([[1, 1], [1, 3]], [[1, 2]], [1, 2], [3], [LOAD, 0],
                           dict(grid_size=5, n_foods=1)),
    "joint_load": ([[1, 1], [1, 3]], [[1, 2]], [1, 2], [3], [LOAD, LOAD],
                   dict(grid_size=5, n_foods=1)),
    "eaten_food_obs": ([[1, 1], [1, 3]], [[1, 2]], [2, 2], [2], [LOAD, 0],
                       dict(grid_size=5, n_foods=1)),
    "mean_aggregation": ([[1, 1], [4, 4]], [[1, 2]], [2, 1], [2], [LOAD, 0],
                         dict(grid_size=5, n_foods=1, reward_aggr="mean")),
    "into_stationary_player": ([[2, 2], [2, 3], [0, 0]], [[4, 4]], [1, 1, 1], [3],
                               [EAST, 0, LOAD], dict(grid_size=5, n_agents=3, n_foods=1)),
}


def _inject_jax(env, players, foods, levels, food_levels):
    s, _ = env.reset(jax.random.PRNGKey(0))
    return s.replace(player_pos=jnp.array(players, jnp.int32),
                     player_level=jnp.array(levels, jnp.int32),
                     food_pos=jnp.array(foods, jnp.int32),
                     food_level=jnp.array(food_levels, jnp.int32),
                     total_food=jnp.asarray(float(sum(food_levels))))


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_rules_match_jax(case):
    players, foods, levels, food_levels, actions, kw = SCENARIOS[case]
    kw = dict(dict(n_agents=2), **kw)
    jenv, tenv = jlbf.LBF(**kw), lbf.LBF(**kw, device="cpu")
    js = _inject_jax(jenv, players, foods, levels, food_levels)
    js2, jts = jenv.step(js, jnp.asarray(actions), jax.random.PRNGKey(1))
    s2, ts = tenv.step(state_from_numpy(LBFState, _np_state(js), "cpu", batched=False),
                       torch.as_tensor(actions)[None])
    for k in ("obs", "state", "reward", "done", "truncated"):
        np.testing.assert_allclose(getattr(ts, k)[0].numpy(), np.asarray(getattr(jts, k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(ts.info["agent_rewards"][0].numpy(),
                               np.asarray(jts.info["agent_rewards"]), atol=ATOL)
    for k in ("player_pos", "food_level"):
        np.testing.assert_array_equal(getattr(s2, k)[0].numpy(), np.asarray(getattr(js2, k)))
    # the JAX tests' own assertions
    pos, food, reward = s2.player_pos[0].tolist(), s2.food_level[0].tolist(), float(ts.reward[0])
    if case == "bounds_and_east":
        assert pos == [[0, 0], [3, 4]]
    elif case == "east_into_food":
        assert pos[0] == [0, 0]
    elif case == "move_conflict":
        assert pos == [[2, 1], [2, 3]]
    elif case == "solo_load":
        assert food[0] == 0 and not bool(ts.done[0])
        np.testing.assert_allclose(reward, 0.5, rtol=1e-6)
    elif case == "under_leveled_load":
        assert food[0] == 3 and reward == 0.0
    elif case == "joint_load":
        assert food[0] == 0 and bool(ts.done[0])
        np.testing.assert_allclose(reward, 1.0, rtol=1e-6)
    elif case == "eaten_food_obs":
        np.testing.assert_allclose(ts.obs[0, 0, :3].numpy(), [-1.0, -1.0, 0.0])
    elif case == "mean_aggregation":
        np.testing.assert_allclose(reward, 0.5, rtol=1e-6)
        np.testing.assert_allclose(ts.info["agent_rewards"][0].numpy(), [1.0, 0.0], rtol=1e-6)
    elif case == "into_stationary_player":
        assert pos[0] == [2, 2]


def test_obs_orders_self_first():
    """Each agent's player triples are its own, then the others in index
    order (the JAX jnp.delete order), at 4 players."""
    tenv = lbf.LBF(grid_size=8, n_agents=4, n_foods=2, device="cpu")
    s, ts = tenv.reset(3, torch.Generator().manual_seed(0))
    feats = torch.cat([s.player_pos, s.player_level[..., None]], -1).float()
    for i in range(4):
        order = [i] + [j for j in range(4) if j != i]
        np.testing.assert_array_equal(ts.obs[:, i, 6:].numpy(),
                                      feats[:, order].reshape(3, -1).numpy())


def test_map_parsing_and_reset_layout():
    env = lbf.make("Foraging-8x8-2p-3f-v3", device="cpu")
    assert (env.grid_size, env.n_agents, env.n_foods, env.coop) == (8, 2, 3, False)
    assert env.obs_dim == 3 * 3 + 3 * 2 and env.state_dim == 2 * env.obs_dim
    assert lbf.make("Foraging-10x10-3p-4f-coop-v3", device="cpu").coop
    for bad in ("Foraging-weird", "Foraging-8x9-2p-3f-v3"):
        with pytest.raises(ValueError):
            lbf.make(bad, device="cpu")
    coop = lbf.make("Foraging-6x6-3p-2f-coop", device="cpu")
    for e in (env, coop):
        s, ts = e.reset(256, torch.Generator().manual_seed(1))
        cells = torch.cat([s.player_pos, s.food_pos], 1)
        flat = cells[..., 0] * e.grid_size + cells[..., 1]
        assert all(len(set(row)) == len(row) for row in flat.tolist())   # distinct cells
        assert ((s.player_level >= 1) & (s.player_level <= 3)).all()
        assert (s.total_food == s.food_level.sum(-1).float()).all()
        assert ts.info["agent_rewards"].shape == (256, e.n_agents) and ts.avail.all()
    s, _ = coop.reset(64, torch.Generator().manual_seed(2))
    assert (s.food_level == s.player_level.sum(-1, keepdim=True)).all()
