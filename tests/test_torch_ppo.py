"""Port parity: one ``ppo_update`` of ``cleanmarl_tpu_torch`` against the
JAX package's own, on recurrent MAPPO / SMAClite 3m (H=16, 8 envs, T=10,
2 epochs x 2 minibatches), from copied params and optimizer states and
one numpy-made trajectory.

The JAX ``ppo_update`` is a free variable of ``meta["phase_timer"]``,
reached through its closure with no edit to the JAX package.

Tolerance: the 7 ``train/*`` metrics and every updated param agree to
rtol=atol=1e-4 (float32 on both sides; four Adam steps amplify rounding
differences of the gradients by at most lr per step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleanmarl_tpu.algos import mappo as jmappo
from cleanmarl_tpu.algos.ppo_common import PPOConfig as JaxPPOConfig
from cleanmarl_tpu_torch.algos import mappo as tmappo
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core.params import (
    from_numpy_tree, opt_state_from_numpy, tree_leaves,
)
from cleanmarl_tpu_torch.envs import registry

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
T, N, H = 10, 8, 16

BASE = dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=N,
            rollout_len=T, actor_hidden_dim=H, critic_hidden_dim=H, epochs=2,
            num_minibatches=2, total_timesteps=10 * T * N, seed=0, verbose=False)
CASES = {
    "default": {},
    "kernel_route": dict(gru_impl="pallas", normalize_advantage=True),
    "levers": dict(normalize_advantage=True, death_masking=True,
                   normalize_values=True, anneal_entropy=True, anneal_lr=True,
                   clip_gradients=0.5, normalize_reward=True, entropy_coef=0.01),
    "remat_bf16": dict(remat_actor=True, compute_dtype="bfloat16",
                       normalize_return=True),
    "feedforward": dict(recurrent=False, normalize_advantage=True),
    "rmsprop_anneal_clip": dict(optimizer="rmsprop", anneal_lr=True, clip_gradients=0.5,
                                normalize_advantage=True),
}


def _trajectory(env, rng, dead_frac):
    n, A = env.n_agents, env.n_actions
    avail = rng.rand(T, N, n, A) < 0.6
    avail[..., 1] = True                      # stop is always available
    dead = rng.rand(T, N, n) < dead_frac      # dead agents: only the no-op
    avail[dead] = False
    avail[..., 0] = dead
    u = rng.rand(T, N, n, A) * avail
    action = u.argmax(-1)
    n_avail = avail.sum(-1)
    return {
        "obs": rng.randn(T, N, n, env.obs_dim).astype(np.float32),
        "state": rng.randn(T, N, env.state_dim).astype(np.float32),
        "avail": avail,
        "action": action.astype(np.int32),
        "logp": (-np.log(n_avail) + 0.1 * rng.randn(T, N, n)).astype(np.float32),
        "reward": rng.rand(T, N).astype(np.float32),
        "ended": rng.rand(T, N) < 0.1,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_ppo_update_matches_jax(case):
    kw = dict(BASE, **CASES[case])
    name = kw.get("optimizer", "adam")
    jinit, _, _, jmeta = jmappo.make_train(JaxPPOConfig(**kw))
    pt = jmeta["phase_timer"]
    free = dict(zip(pt.__code__.co_freevars, (c.cell_contents for c in pt.__closure__)))
    j_update = free["ppo_update"]
    tinit, _, _, tmeta = tmappo.make_train(PPOConfig(**kw, device="cpu"))

    rng = np.random.RandomState(len(case))
    runner_j = jinit(jax.random.PRNGKey(0))
    n = runner_j.obs.shape[1]
    tenv = registry.make("smaclite", "3m", agent_ids=True, device="cpu")
    traj = _trajectory(tenv, rng, dead_frac=0.2)
    boot_obs = rng.randn(N, n, tenv.obs_dim).astype(np.float32)
    boot_state = rng.randn(N, tenv.state_dim).astype(np.float32)
    h0 = (0.3 * rng.randn(N, n, H)).astype(np.float32)

    runner_j = runner_j.replace(obs=jnp.asarray(boot_obs), state=jnp.asarray(boot_state))
    out_j, m_j = j_update(runner_j, jax.tree.map(jnp.asarray, traj), jnp.asarray(h0))

    np_tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    runner_t = tinit(torch.Generator().manual_seed(0))
    runner_t = runner_t.replace(
        actor_params=from_numpy_tree(np_tree(runner_j.actor_params), "cpu"),
        critic_params=from_numpy_tree(np_tree(runner_j.critic_params), "cpu"),
        actor_opt=opt_state_from_numpy(np_tree(runner_j.actor_opt), "cpu", name),
        critic_opt=opt_state_from_numpy(np_tree(runner_j.critic_opt), "cpu", name),
        obs=torch.as_tensor(boot_obs), state=torch.as_tensor(boot_state),
        vnorm=from_numpy_tree(np_tree(runner_j.vnorm), "cpu"),
    )
    traj_t = {k: torch.as_tensor(v) for k, v in traj.items()}
    traj_t["action"] = traj_t["action"].long()
    out_t, m_t = tmeta["ppo_update"](runner_t, traj_t, torch.as_tensor(h0))

    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL, err_msg=k)
    for which in ("actor_params", "critic_params"):
        want = jax.tree.leaves(getattr(out_j, which))
        got = tree_leaves(getattr(out_t, which))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=which)
    assert out_t.num_updates == int(out_j.num_updates)
    assert out_t.actor_opt["count"] == opt_state_from_numpy(
        np_tree(out_j.actor_opt), "cpu", name)["count"]
