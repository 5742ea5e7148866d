"""Port parity: the batched MPE envs of ``cleanmarl_tpu_torch.envs.mpe``
against the JAX package's per-env MPE (vmapped).

- a 25-step transcript of each scenario: the same JAX reset states
  (converted, half of the spread envs moved into contact) and the same
  seeded actions through both, every TimeStep field and every state field
  at atol=1e-5;
- ``action_force``, ``collision_forces`` and the speaker-listener and
  reference action decoding on their own;
- the reset distributions and the registry routes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.envs import mpe as jmpe
from cleanmarl_tpu.envs import registry as jreg
from cleanmarl_tpu_torch.envs import mpe as tmpe
from cleanmarl_tpu_torch.envs import registry as treg
from cleanmarl_tpu_torch.envs.base import state_from_numpy

torch.set_num_threads(1)
ATOL = 1e-5
N = 8
SCENARIOS = ["simple_spread_v3", "simple_speaker_listener_v4", "simple_reference_v3"]
STATE_FIELDS = ("agent_pos", "agent_vel", "landmark_pos", "comm", "goal", "t")


def _random_actions(rng, avail):
    """One uniformly random available action per (env, agent)."""
    return (rng.rand(*avail.shape) * avail).argmax(-1)


def _jax_reset(jenv, seed):
    js, jts = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), N))
    return {k: np.array(getattr(js, k)) for k in STATE_FIELDS}, jts


@pytest.mark.parametrize("name", SCENARIOS)
def test_transcript_matches_jax(name):
    jenv, tenv = jmpe.make(name), tmpe.make(name, device="cpu")
    assert (tenv.n_agents, tenv.obs_dim, tenv.state_dim, tenv.n_actions,
            tenv.episode_limit) == (jenv.n_agents, jenv.obs_dim, jenv.state_dim,
                                    jenv.n_actions, jenv.episode_limit)
    fields, jts = _jax_reset(jenv, seed=len(name))
    if name.startswith("simple_spread"):
        # envs 0-3: the agents start in contact, so the soft-contact forces act
        fields["agent_pos"][:4] = fields["agent_pos"][:4, :1] + 0.1 * fields["agent_pos"][:4]
    js = jmpe.MPEState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts_state = state_from_numpy(tmpe.MPEState, fields, "cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(0)
    avail = np.asarray(jts.avail)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    collided = 0.0
    for t in range(jenv.episode_limit):
        actions = _random_actions(rng, avail)
        js, jts = jstep(js, jnp.asarray(actions, jnp.int32), keys)
        ts_state, tts = tenv.step(ts_state, torch.as_tensor(actions))
        where = f"{name} t={t}"
        for k in ("obs", "state", "reward"):
            np.testing.assert_allclose(getattr(tts, k).numpy(), np.asarray(getattr(jts, k)),
                                       atol=ATOL, err_msg=f"{where} {k}")
        for k in ("avail", "done", "truncated"):
            np.testing.assert_array_equal(getattr(tts, k).numpy(),
                                          np.asarray(getattr(jts, k)), err_msg=f"{where} {k}")
        np.testing.assert_array_equal(tts.info["battle_won"].numpy(),
                                      np.asarray(jts.info["battle_won"]))
        for k in STATE_FIELDS:
            np.testing.assert_allclose(getattr(ts_state, k).numpy(),
                                       np.asarray(getattr(js, k)), atol=ATOL,
                                       err_msg=f"{where} state.{k}")
        if name.startswith("simple_spread"):
            pos = ts_state.agent_pos
            d = torch.cdist(pos, pos) + 10 * torch.eye(3)
            collided += float((d < 0.3).any(-1).any(-1).sum())
        avail = np.asarray(jts.avail)
    assert bool(tts.truncated.all()) and not bool(tts.done.any())
    if name.startswith("simple_spread"):
        assert collided > 0, "no contact was exercised"


def test_action_force_and_collision_forces_match_jax():
    a = np.arange(5)
    np.testing.assert_allclose(tmpe.action_force(torch.as_tensor(a)).numpy(),
                               np.asarray(jmpe.action_force(jnp.asarray(a))), atol=0)
    rng = np.random.RandomState(3)
    pos = (rng.rand(N, 6, 2) * 0.6 - 0.3).astype(np.float32)   # many overlaps
    sizes = np.array([0.15] * 3 + [0.05] * 3, np.float32)
    collide = np.array([True] * 4 + [False] * 2)
    got = tmpe.collision_forces(torch.as_tensor(pos), torch.as_tensor(sizes),
                                torch.as_tensor(collide)).numpy()
    want = np.array(jax.vmap(jmpe.collision_forces, in_axes=(0, None, None))(
        jnp.asarray(pos), jnp.asarray(sizes), jnp.asarray(collide)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    vel = rng.randn(N, 6, 2).astype(np.float32)
    movable = np.array([True] * 5 + [False])
    for max_speed in (None, 0.5):
        got = tmpe.integrate(torch.as_tensor(pos), torch.as_tensor(vel),
                             torch.as_tensor(want), torch.as_tensor(movable), max_speed)
        exp = jax.vmap(lambda p, v, f: jmpe.integrate(p, v, f, jnp.asarray(movable),
                                                      max_speed))(pos, vel, want)
        for g, w in zip(got, exp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("name,n_act", [("simple_speaker_listener_v4", 5),
                                        ("simple_reference_v3", 50)])
def test_action_decoding_matches_jax(name, n_act):
    """Every action of agent 0 (with a cycling action of agent 1), from one
    reset state: the utterance and the motion it decodes to."""
    jenv, tenv = jmpe.make(name), tmpe.make(name, device="cpu")
    fields, _ = _jax_reset(jenv, seed=7)
    fields = {k: np.repeat(v[:1], n_act, axis=0) for k, v in fields.items()}
    actions = np.stack([np.arange(n_act), (3 * np.arange(n_act)) % n_act], -1)
    if name.startswith("simple_speaker"):
        actions[:, 1] %= 5
    js = jmpe.MPEState(**{k: jnp.asarray(v) for k, v in fields.items()})
    js2, jts = jax.vmap(jenv.step)(js, jnp.asarray(actions, jnp.int32),
                                   jax.random.split(jax.random.PRNGKey(0), n_act))
    ts2, tts = tenv.step(state_from_numpy(tmpe.MPEState, fields, "cpu"),
                         torch.as_tensor(actions))
    for k in ("comm", "agent_vel", "agent_pos"):
        np.testing.assert_allclose(getattr(ts2, k).numpy(), np.asarray(getattr(js2, k)),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tts.obs.numpy(), np.asarray(jts.obs), atol=ATOL)
    # each symbol is heard: the comm rows are one-hot of the decoded symbol
    c = ts2.comm[:, 0].argmax(-1).numpy()
    want = np.clip(actions[:, 0], 0, 2) if n_act == 5 else actions[:, 0] // 5
    np.testing.assert_array_equal(c, want)


@pytest.mark.parametrize("name,lm_bound,goal_shape", [
    ("simple_spread_v3", 0.9, (4096,)), ("simple_speaker_listener_v4", 0.9, (4096,)),
    ("simple_reference_v3", 1.0, (4096, 2))])
def test_reset_ranges(name, lm_bound, goal_shape):
    env = tmpe.make(name, device="cpu")
    s, ts = env.reset(4096, torch.Generator().manual_seed(0))
    assert s.agent_pos.abs().max() <= 1.0 and s.agent_pos.abs().max() > 0.99
    assert s.landmark_pos.abs().max() <= lm_bound
    assert s.landmark_pos.abs().max() > lm_bound - 0.01
    assert float(s.agent_vel.abs().max()) == 0.0 and int(s.t.max()) == 0
    assert tuple(s.goal.shape) == goal_shape
    if not name.startswith("simple_spread"):
        assert set(s.goal.unique().tolist()) == {0, 1, 2}
    assert ts.obs.shape == (4096, env.n_agents, env.obs_dim)
    assert ts.state.shape == (4096, env.state_dim)


def test_registry_routes_mpe():
    for env_type, kw in (("mpe", {}), ("pz", {"env_family": "mpe"})):
        tenv = treg.make(env_type, "simple_spread_v3", agent_ids=True, device="cpu", **kw)
        jenv = jreg.make(env_type, "simple_spread_v3", agent_ids=True, **kw)
        assert (tenv.obs_dim, tenv.state_dim, tenv.n_actions) == (
            jenv.obs_dim, jenv.state_dim, jenv.n_actions) == (21, 54, 5)
        assert isinstance(tenv.env, tmpe.SimpleSpread)
    assert isinstance(treg.make("mpe", "simple_reference_v3", device="cpu"),
                      tmpe.SimpleReference)
