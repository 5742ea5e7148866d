"""Port parity: the host-env route of ``cleanmarl_tpu_torch``
(``envs/external.py``, ``envs/pettingzoo_host.py``) against the JAX
package's (``tests/test_external_env.py``, ``tests/test_external_info.py``).

- a scripted host env (no external package): ``battle_won`` and
  ``agent_rewards`` reach the live and the pre-reset ``final`` views; a
  4-tuple env keeps zero defaults; a missing ``agent_rewards`` breaks the
  contract with the JAX package's message; ``HostVecEnv`` gives the same
  arrays as the JAX one step for step (both seed their envs from
  ``np.random.RandomState(seed)``); a step's views come up in one buffer;
- the QMIX episode ring trains on a host env; COMA's ``per_agent_rewards``
  reads a host family's declaration;
- the PettingZoo adapter on ``sisl.pursuit_v4``: its contract, the same
  arrays as the JAX package's adapter from the same seed, the registry's
  ``pz`` route, VDN training on it, and its obs equal to the batched
  device pursuit's on the same injected positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.envs.external import HostEnvFamily as JHostEnvFamily
from cleanmarl_tpu_torch.core.driver import to_host
from cleanmarl_tpu_torch.envs import registry as treg
from cleanmarl_tpu_torch.envs.external import HostEnvFamily, HostVecEnv, as_vec

torch.set_num_threads(1)


class ScriptedHostEnv:
    """Episodes of 4 steps; reward = sum of the actions; per-agent rewards
    = own action; battle_won on the last step iff every agent played 1;
    the obs and state carry the step count."""

    n_agents = 2
    obs_dim = 3
    state_dim = 5
    n_actions = 3
    episode_limit = 4
    provides_agent_rewards = True

    def __init__(self):
        self.t = 0

    def close(self):
        pass

    def reset(self, seed=None):
        self.t = 0
        return self._obs()

    def _obs(self):
        return np.full((self.n_agents, self.obs_dim), float(self.t), np.float32)

    def get_state(self):
        return np.full((self.state_dim,), float(self.t), np.float32)

    def get_avail_actions(self):
        return np.ones((self.n_agents, self.n_actions), bool)

    def step(self, actions):
        actions = np.asarray(actions)
        self.t += 1
        done = self.t >= self.episode_limit
        info = {"battle_won": float(done and np.all(actions == 1)),
                "agent_rewards": actions.astype(np.float32)}
        return self._obs(), float(actions.sum()), done, False, info


class Plain(ScriptedHostEnv):
    provides_agent_rewards = False

    def step(self, actions):
        return super().step(actions)[:4]             # the 4-tuple protocol


class Liar(ScriptedHostEnv):
    def step(self, actions):
        obs, r, d, tr, info = super().step(actions)
        return obs, r, d, tr, {"battle_won": info["battle_won"]}


def family(cls=ScriptedHostEnv):
    return HostEnvFamily(cls, seed=0, device="cpu")


def test_info_plumbs_through_step():
    fam = family()
    assert fam.provides_agent_rewards and fam.device == torch.device("cpu")
    vec = fam.make_vec(2)
    state, ts0 = vec.reset()
    assert float(ts0.info["battle_won"].sum()) == 0.0 and state == 0
    rows = []
    for _ in range(4):
        state, ts, final = vec.step(state, torch.ones((2, 2), dtype=torch.int64))
        rows.append((ts, final))
    assert state == 4
    bw_final = torch.stack([f.info["battle_won"] for _, f in rows])
    np.testing.assert_allclose(bw_final[-1].numpy(), 1.0)      # the win, pre-reset
    np.testing.assert_allclose(bw_final[:-1].numpy(), 0.0)
    for ts, final in rows:
        np.testing.assert_allclose(ts.info["agent_rewards"].numpy(), 1.0)
        np.testing.assert_allclose(ts.reward.numpy(), 2.0)
        assert ts.obs.dtype == torch.float32 and ts.avail.dtype == torch.bool
    ts, final = rows[-1]
    assert final.done.all() and (final.obs == 4.0).all() and (ts.obs == 0.0).all()
    vec.close()


@pytest.mark.parametrize("auto_reset", [True, False])
def test_host_step_moves_its_views_up_in_one_buffer(auto_reset):
    """One host-to-device copy a step: the float fields of the live and the
    final view are cut from one buffer, the flags cast back to bool."""
    vec = family().make_vec(2, auto_reset=auto_reset)
    state, _ = vec.reset()
    for _ in range(4):
        state, ts, final = vec.step(state, torch.ones((2, 2), dtype=torch.int64))
    floats = [x for v in (ts, final) for x in (v.obs, v.state, v.reward, *v.info.values())]
    assert len({x.untyped_storage().data_ptr() for x in floats}) == 1
    for v in (ts, final):
        assert all(x.dtype == torch.float32 for x in (v.obs, v.state, v.reward,
                                                      *v.info.values()))
        assert all(x.dtype == torch.bool for x in (v.avail, v.done, v.truncated))
    assert final.done.all() and (final.obs == 4.0).all()
    assert (ts.obs == (0.0 if auto_reset else 4.0)).all()


def test_host_env_without_info_defaults_to_zero():
    fam = family(Plain)
    assert not fam.provides_agent_rewards
    vec = fam.make_vec(2)
    state, ts0 = vec.reset()
    assert "agent_rewards" not in ts0.info
    _, ts, _ = vec.step(state, torch.ones((2, 2), dtype=torch.int64))
    np.testing.assert_allclose(ts.info["battle_won"].numpy(), 0.0)


def test_missing_agent_rewards_contract_error():
    vec = family(Liar).make_vec(1)
    state, _ = vec.reset()
    with pytest.raises(ValueError, match="provides_agent_rewards") as got:
        vec.step(state, torch.zeros((1, 2), dtype=torch.int64))
    jvec = JHostEnvFamily(Liar, seed=0).make_vec(1)
    token, _ = jvec.reset(jax.random.PRNGKey(0))
    with pytest.raises(Exception, match="provides_agent_rewards") as want:
        jax.block_until_ready(jvec.step(token, jnp.zeros((1, 2), jnp.int32), None))
    assert str(got.value) in str(want.value)


@pytest.mark.parametrize("auto_reset", [True, False])
def test_host_vec_env_matches_jax(auto_reset):
    """The same host env under both bridges: equal TimeSteps, live and
    final, over two episodes (auto-reset on) or past the first end."""
    rng = np.random.RandomState(0)
    vec = family().make_vec(3, auto_reset=auto_reset)
    jvec = JHostEnvFamily(ScriptedHostEnv, seed=0).make_vec(3, auto_reset=auto_reset)
    state, ts = vec.reset(torch.Generator().manual_seed(0))
    token, jts = jvec.reset(jax.random.PRNGKey(0))
    for step in range(9):
        actions = rng.randint(0, 3, (3, 2))
        state, ts, final = vec.step(state, torch.as_tensor(actions))
        token, jts, jfinal = jvec.step(token, jnp.asarray(actions, jnp.int32), None)
        assert state == int(token) == step + 1
        for got, want in ((ts, jts), (final, jfinal)):
            for k in ("obs", "state", "avail", "reward", "done", "truncated"):
                np.testing.assert_array_equal(getattr(got, k).numpy(),
                                              np.asarray(getattr(want, k)), err_msg=k)
            assert sorted(got.info) == sorted(want.info)
            for k in got.info:
                np.testing.assert_array_equal(got.info[k].numpy(), np.asarray(want.info[k]))


def test_as_vec_routes_host_families_and_batched_envs():
    assert isinstance(as_vec(family(), 2), HostVecEnv)
    env = treg.make("matrix", "", device="cpu")
    vec = as_vec(env, 3, auto_reset=False)
    assert type(vec).__name__ == "VecEnv" and not vec.auto_reset and vec.num_envs == 3


def test_qmix_episode_ring_trains_on_host_env():
    """The episode ring (accumulator and the pre-reset ``final`` view)
    commits whole host episodes, and the stats carry the host's
    battle_won."""
    from cleanmarl_tpu_torch.algos.qmix import QMIXConfig, make_train

    cfg = QMIXConfig(env_type="matrix", num_envs=4, buffer_size=64, total_timesteps=800,
                     train_freq=1, batch_size=4, hidden_dim=16, hyper_dim=8, embed_dim=4,
                     log_interval=25, num_eval_ep=2, seed=0, start_e=1.0, end_e=1.0,
                     device="cpu")
    init, train_block, eval_fn, _ = make_train(cfg, family())
    runner = init(torch.Generator().manual_seed(0))
    runner, metrics = train_block(runner)
    m = to_host(metrics)
    assert np.isfinite(m["train/loss"]) and runner.num_updates > 0
    # 25 iterations x 4 envs / 4 steps an episode: 25 committed episodes
    assert m["rollout/num_episodes"] >= 20
    assert 0.0 <= m["rollout/battle_won"] <= 1.0
    ev = to_host(eval_fn(runner.params, torch.Generator().manual_seed(1)))
    assert ev["eval/ep_length"] == 4.0


def test_coma_per_agent_rewards_reads_the_host_declaration():
    from cleanmarl_tpu_torch.algos import coma

    cfg = coma.COMAConfig(env_type="matrix", num_envs=2, rollout_len=4, log_interval=1,
                          actor_hidden_dim=8, critic_hidden_dim=8, per_agent_rewards=True,
                          total_timesteps=8, num_eval_ep=2, device="cpu")
    init, train_block, _, _ = coma.make_train(cfg, family())
    runner, metrics = train_block(init(torch.Generator().manual_seed(0)))
    assert np.isfinite(float(metrics["train/critic_loss"]))
    with pytest.raises(ValueError, match=r"info\['agent_rewards'\]"):
        coma.make_train(cfg, family(Plain))


# ---------------------------------------------------------------------------
# the PettingZoo adapter on sisl pursuit
# ---------------------------------------------------------------------------

def test_host_wrapper_contract():
    pytest.importorskip("pettingzoo")
    from cleanmarl_tpu_torch.envs.pettingzoo_host import PettingZooHostEnv

    env = PettingZooHostEnv("sisl", "pursuit_v4", agent_ids=True)
    assert (env.n_agents, env.n_actions) == (8, 5)
    assert env.obs_dim == 7 * 7 * 3 + 8 and env.state_dim == 7 * 7 * 3 * 8
    assert env.episode_limit == 500
    obs = env.reset(seed=0)
    assert obs.shape == (8, env.obs_dim)
    np.testing.assert_allclose(obs[:, -8:], np.eye(8))
    np.testing.assert_array_equal(env.get_state(), obs[:, :-8].reshape(-1))
    assert env.get_avail_actions().all()
    obs2, reward, done, truncated = env.step(np.zeros(8, np.int64))
    assert isinstance(reward, float) and not done and not truncated
    env.close()


def test_host_wrapper_matches_jax_adapter():
    pytest.importorskip("pettingzoo")
    from cleanmarl_tpu.envs.pettingzoo_host import PettingZooHostEnv as JPZ
    from cleanmarl_tpu_torch.envs.pettingzoo_host import PettingZooHostEnv

    rng = np.random.RandomState(0)
    ours, ref = (cls("sisl", "pursuit_v4", agent_ids=False, n_evaders=4, max_cycles=6)
                 for cls in (PettingZooHostEnv, JPZ))
    np.testing.assert_array_equal(ours.reset(seed=3), ref.reset(seed=3))
    for _ in range(8):          # past the 6-cycle truncation
        actions = rng.randint(0, 5, 8)
        got, want = ours.step(actions), ref.step(actions)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(ours.get_state(), ref.get_state())
    ours.close(), ref.close()


def test_registry_pz_route_steps_on_the_host():
    pytest.importorskip("pettingzoo")
    fam = treg.make("pz", "pursuit_v4", env_family="sisl", device="cpu")
    assert isinstance(fam, HostEnvFamily)
    vec = fam.make_vec(2)
    state, ts = vec.reset()
    assert ts.obs.shape == (2, 8, 147) and ts.state.shape == (2, 8 * 147)
    for _ in range(3):
        state, ts, final = vec.step(state, torch.zeros((2, 8), dtype=torch.int64))
    assert state == 3 and ts.reward.shape == (2,) and torch.isfinite(ts.reward).all()
    vec.close()


def test_vdn_trains_on_real_pettingzoo():
    pytest.importorskip("pettingzoo")
    from cleanmarl_tpu_torch.algos.vdn import VDNConfig, make_train

    cfg = VDNConfig(env_type="pz", env_family="sisl", env_name="pursuit_v4", agent_ids=False,
                    num_envs=2, buffer_size=512, total_timesteps=400, learning_starts=50,
                    train_freq=1, batch_size=4, log_interval=30, num_eval_ep=2, seed=0,
                    device="cpu")
    init, train_block, _, _ = make_train(cfg)
    runner, metrics = train_block(init(torch.Generator().manual_seed(0)))
    assert np.isfinite(float(metrics["train/loss"])) and runner.step == 30


def test_device_pursuit_obs_equals_host_pursuit_obs():
    """The batched device pursuit and the upstream env behind the host
    adapter, from the same injected positions with frozen evaders and
    the same actions: the same obs, state and reward for 5 steps."""
    pytest.importorskip("pettingzoo")
    from cleanmarl_tpu_torch.envs.pettingzoo_host import PettingZooHostEnv
    from cleanmarl_tpu_torch.envs.pursuit import Pursuit, PursuitState

    ppos = [(1, 1), (3, 1), (1, 14), (14, 1), (14, 14), (3, 14), (7, 2), (9, 13)]
    epos = [(2, 2), (2, 13), (13, 2), (13, 13), (0, 7), (8, 1)]
    host = PettingZooHostEnv("sisl", "pursuit_v4", n_evaders=len(epos), freeze_evaders=True)
    host.reset(seed=0)
    base = host.env.unwrapped.env
    for i, (x, y) in enumerate(ppos):
        base.pursuer_layer.set_position(i, x, y)
    for i, (x, y) in enumerate(epos):
        base.evader_layer.set_position(i, x, y)
    base.model_state[1] = base.pursuer_layer.get_state_matrix()
    base.model_state[2] = base.evader_layer.get_state_matrix()
    dev = Pursuit(n_evaders=len(epos), freeze_evaders=True, device="cpu")
    s = PursuitState(ppos=torch.as_tensor([ppos]), epos=torch.as_tensor([epos]),
                     ealive=torch.ones((1, len(epos)), dtype=torch.bool),
                     t=torch.zeros((1,), dtype=torch.int64))
    rng = np.random.RandomState(4)
    for step in range(5):
        actions = rng.randint(0, 5, 8)
        obs, reward, done, _ = host.step(actions)
        s, ts = dev.step(s, torch.as_tensor(actions)[None])
        np.testing.assert_allclose(ts.obs[0].numpy(), obs, atol=1e-6, err_msg=f"step {step}")
        np.testing.assert_allclose(ts.state[0].numpy(), host.get_state(), atol=1e-6)
        np.testing.assert_allclose(float(ts.reward[0]), reward, atol=1e-6)
        assert bool(ts.done[0]) == done
    host.close()
