"""Data parallelism of the port over ``torch.distributed`` (gloo on the
CPU), mirroring ``tests/test_distributed.py`` and ``tests/test_multihost.py``.

- one MAPPO update split over 2 ranks by the interleave (global env ``j``
  on rank ``j % 2``; ``shard_runner`` and the trajectory's env axis),
  from the JAX package's params and Adam state, against the JAX package's
  own single-device ``ppo_update`` at 1e-5: four minibatches with
  ``normalize_return``; a GRU actor with ``normalize_advantage`` and
  ``death_masking``; a GRU actor with ``normalize_reward``,
  ``normalize_values`` and clipping. Both ranks end with the same params;
- the same for recurrent COMA with resets (``tests/test_torch_coma.py``'s
  update assembled from the JAX package's functions);
- one rank through the data-parallel path (a 1-rank process group) is
  bit-identical to the plain path;
- after a 2-rank ``global_runner_init`` and block: params identical on
  both ranks, the rollout metrics the global ones, each rank's envs on
  its own stream, ``step`` counting global env steps;
- a 2-process CLI run prints on rank 0 only, and a save / resume cluster
  ends at ``total_timesteps`` (``tests/test_multihost.py``, not slow);
- ``--profile_dir`` writes a trace on the CPU and leaves the run as it
  is without it (the phase timer puts the generator back).

Each spawned rank imports torch and the port only (``tests/_dp_ranks.py``);
the JAX references run in this process. Adam's moments are warmed by one
earlier JAX update, so no parameter sits at Adam's first-step sign.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _dp_ranks
from cleanmarl_tpu.algos import mappo as jmappo
from cleanmarl_tpu.algos.coma import COMAConfig as JaxCOMAConfig
from cleanmarl_tpu.algos.ppo_common import PPOConfig as JaxPPOConfig
from cleanmarl_tpu_torch.algos import coma, mappo
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core.checkpoint import to_state
from cleanmarl_tpu_torch.core.params import opt_state_from_numpy, tree_leaves
from cleanmarl_tpu_torch.envs import registry
from test_torch_coma import jax_update as jax_coma_update
from test_torch_coma import make_rollout as coma_rollout
from test_torch_coma import start as coma_start

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2
T, N, H = 10, 16, 16

PPO_BASE = dict(env_type="smaclite", env_name="3m", num_envs=N, rollout_len=T,
                actor_hidden_dim=H, critic_hidden_dim=H, epochs=2, num_minibatches=2,
                total_timesteps=10 * T * N, seed=0, verbose=False)
PPO_CASES = {
    "ff_minibatches4_return": dict(recurrent=False, num_minibatches=4,
                                   normalize_return=True),
    "gru_advantage_death_masking": dict(recurrent=True, normalize_advantage=True,
                                        death_masking=True),
    "gru_reward_values_clip": dict(recurrent=True, normalize_reward=True,
                                   normalize_values=True, clip_gradients=0.5),
}
COMA_KW = dict(env_type="smaclite", env_name="3m", num_envs=4, rollout_len=10,
               total_timesteps=12 * 10 * 4, actor_hidden_dim=16, critic_hidden_dim=16,
               learning_rate_actor=3e-3, learning_rate_critic=3e-3, entropy_coef=0.05,
               recurrent=True, normalize_reward=True, normalize_return=True)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def port_opt(jax_state):
    """An optax Adam state → the port's, moments as numpy."""
    st = opt_state_from_numpy(np_tree(jax_state), "cpu")
    numpy = lambda t: jax.tree.map(lambda x: x.numpy(), t)  # noqa: E731
    return dict(st, mu=numpy(st["mu"]), nu=numpy(st["nu"]))


def ppo_trajectory(env, rng):
    n, A = env.n_agents, env.n_actions
    avail = rng.rand(T, N, n, A) < 0.6
    avail[..., 1] = True
    dead = rng.rand(T, N, n) < 0.2
    avail[dead] = False
    avail[..., 0] = dead
    action = (rng.rand(T, N, n, A) * avail).argmax(-1)
    return {"obs": rng.randn(T, N, n, env.obs_dim).astype(np.float32),
            "state": rng.randn(T, N, env.state_dim).astype(np.float32),
            "avail": avail, "action": action.astype(np.int32),
            "logp": (-np.log(avail.sum(-1)) + 0.1 * rng.randn(T, N, n)).astype(np.float32),
            "reward": rng.rand(T, N).astype(np.float32), "ended": rng.rand(T, N) < 0.1}


def close_trees(got, want, what):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=what)


def same_trees(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def update_results():
    """Every JAX reference computed here; every 2-rank update in one spawn."""
    env = registry.make("smaclite", "3m", agent_ids=True, device="cpu")
    jobs, want = [], {}
    for i, (case, extra) in enumerate(sorted(PPO_CASES.items())):
        kw = dict(PPO_BASE, **extra)
        jinit, _, _, jmeta = jmappo.make_train(JaxPPOConfig(**kw))
        pt = jmeta["phase_timer"]
        j_update = dict(zip(pt.__code__.co_freevars,
                            (c.cell_contents for c in pt.__closure__)))["ppo_update"]
        rng = np.random.RandomState(10 + i)
        runner = jinit(jax.random.PRNGKey(i))
        n = runner.obs.shape[1]
        warm = {k: jnp.asarray(v) for k, v in ppo_trajectory(env, rng).items()}
        runner, _ = j_update(runner, warm, jnp.zeros((N, n, H)))
        runner = runner.replace(
            obs=jnp.asarray(rng.randn(N, n, env.obs_dim).astype(np.float32)),
            state=jnp.asarray(rng.randn(N, env.state_dim).astype(np.float32)))
        traj = ppo_trajectory(env, rng)
        h0 = (0.3 * rng.randn(N, n, H)).astype(np.float32)
        out, metrics = j_update(runner, {k: jnp.asarray(v) for k, v in traj.items()},
                                jnp.asarray(h0))
        start = dict(actor_params=np_tree(runner.actor_params),
                     critic_params=np_tree(runner.critic_params),
                     actor_opt=port_opt(runner.actor_opt),
                     critic_opt=port_opt(runner.critic_opt), vnorm=np_tree(runner.vnorm),
                     obs=np.asarray(runner.obs), state=np.asarray(runner.state),
                     num_updates=int(runner.num_updates))
        want[case] = (out, metrics)
        jobs.append(("ppo", case, (kw, True, start, traj, h0)))

    jcfg = JaxCOMAConfig(**COMA_KW)
    st = coma_start(jcfg, env, seed=3)
    rng = np.random.RandomState(3)
    jt = lambda d: jax.tree.map(jnp.asarray, d)  # noqa: E731
    r0 = coma_rollout(rng, env, jcfg)
    st, _ = jax_coma_update(jcfg, env, st, jt(r0[0]), jnp.asarray(r0[1]), jt(r0[2]), 0.3, None)
    traj, h0, live, _ = coma_rollout(rng, env, jcfg)
    want["coma"] = jax_coma_update(jcfg, env, st, jt(traj), jnp.asarray(h0), jt(live), 0.3,
                                   None)
    actor, critic, target, a_opt, c_opt, num_updates = st
    start = dict(actor_params=np_tree(actor), critic_params=np_tree(critic),
                 target_critic=np_tree(target), actor_opt=port_opt(a_opt),
                 critic_opt=port_opt(c_opt), num_updates=int(num_updates))
    jobs.append(("coma", "coma", (COMA_KW, start, traj, h0, live, 0.3)))
    got = _dp_ranks.run_ranks(_dp_ranks.run_jobs, WORLD, jobs)
    return want, got


@pytest.mark.parametrize("case", sorted(PPO_CASES))
def test_two_rank_mappo_update_matches_jax(case, update_results):
    want, got = update_results
    out_j, m_j = want[case]
    ranks = [g[case] for g in got]
    assert [r["local_envs"] for r in ranks] == [N // WORLD] * WORLD
    assert sorted(ranks[0]["metrics"]) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(m_j[k]), **TOL, err_msg=k)
    close_trees(ranks[0]["actor_params"], np_tree(out_j.actor_params), "actor_params")
    close_trees(ranks[0]["critic_params"], np_tree(out_j.critic_params), "critic_params")
    if PPO_CASES[case].get("normalize_values"):
        close_trees(ranks[0]["vnorm"], np_tree(out_j.vnorm), "vnorm")
    assert ranks[0]["num_updates"] == int(out_j.num_updates)
    for r in ranks[1:]:                 # one step on every rank: identical params
        same_trees(r["actor_params"], ranks[0]["actor_params"])
        same_trees(r["critic_params"], ranks[0]["critic_params"])
        assert r["metrics"] == ranks[0]["metrics"]
    assert ranks[0]["collectives"] > 0


def test_two_rank_recurrent_coma_update_matches_jax(update_results):
    want, got = update_results
    (actor, critic, target, _, _, num_updates), metrics = want["coma"]
    ranks = [g["coma"] for g in got]
    keys = ("train/actor_loss", "train/critic_loss", "train/entropy",
            "train/actor_gradients", "train/critic_gradients")
    for k, w in zip(keys, metrics):
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(w), **TOL, err_msg=k)
    close_trees(ranks[0]["actor_params"], np_tree(actor), "actor")
    close_trees(ranks[0]["critic_params"], np_tree(critic), "critic")
    close_trees(ranks[0]["target_critic"], np_tree(target), "target")
    assert ranks[0]["num_updates"] == int(num_updates)
    same_trees(ranks[1]["actor_params"], ranks[0]["actor_params"])
    same_trees(ranks[1]["critic_params"], ranks[0]["critic_params"])


# one 2-rank MAPPO update with optimizers whose state or step is not
# Adam's: lamb's per-leaf trust ratio, noisy_sgd's noise (drawn from the
# count, so every rank draws the same)
OPT_NAMES = ("lamb", "noisy_sgd")
OPT_KW = dict(PPO_BASE, recurrent=True, num_envs=8, normalize_advantage=True,
              clip_gradients=0.5, anneal_lr=True)


@pytest.fixture(scope="module")
def optimizer_results():
    return _dp_ranks.run_ranks(_dp_ranks.ppo_optimizer_updates, WORLD, OPT_KW, OPT_NAMES)


@pytest.mark.parametrize("name", OPT_NAMES)
def test_two_rank_update_with_another_optimizer_matches_one_process(name, optimizer_results):
    """Params bitwise identical across the ranks, and equal to the
    single-process update from the same runner and rollout within 1e-5
    (the gradient summed over the ranks in another order)."""
    ranks = [r[name] for r in optimizer_results]
    assert [r["local_envs"] for r in ranks] == [OPT_KW["num_envs"] // WORLD] * WORLD
    for r in ranks[1:]:
        same_trees(r["params"], ranks[0]["params"])
    close_trees(ranks[0]["params"], ranks[0]["single"], name)
    assert ranks[0]["count"] == OPT_KW["epochs"] * OPT_KW["num_minibatches"]


BLOCK = dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=8,
             rollout_len=30, actor_hidden_dim=8, critic_hidden_dim=8, epochs=1,
             num_minibatches=2, log_interval=1, normalize_advantage=True,
             total_timesteps=8 * 30 * 4, seed=0, verbose=False)


def test_two_rank_block_keeps_params_identical_and_metrics_global():
    ranks = _dp_ranks.run_ranks(_dp_ranks.mappo_block, WORLD, BLOCK)
    assert [r["local_envs"] for r in ranks] == [4, 4]
    same_trees(ranks[1]["init_params"], ranks[0]["init_params"])   # rank 0's, broadcast
    same_trees(ranks[1]["params"], ranks[0]["params"])
    same_trees(ranks[1]["critic"], ranks[0]["critic"])
    assert not np.array_equal(ranks[0]["obs"], ranks[1]["obs"])     # own env streams
    ret, length, won, count = np.sum([r["sums"] for r in ranks], axis=0)
    assert count > 0 and all(r["sums"][3] > 0 for r in ranks)
    for r in ranks:
        np.testing.assert_allclose(r["rollout"]["rollout/ep_reward"], ret / count, rtol=1e-6)
        np.testing.assert_allclose(r["rollout"]["rollout/ep_length"], length / count,
                                   rtol=1e-6)
        assert r["rollout"]["rollout/num_episodes"] == count
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["step"] == BLOCK["num_envs"] * BLOCK["rollout_len"]
    assert ranks[0]["metrics"]["rollout/num_episodes"] == count


def _logger():
    return types.SimpleNamespace(log=lambda *a: None, close=lambda: None)


@pytest.mark.parametrize("family", ["mappo", "coma"])
def test_one_rank_dp_path_is_bit_identical_to_plain(family):
    if family == "mappo":
        cfg = PPOConfig(**dict(BLOCK, log_interval=2, normalize_reward=True), device="cpu")
        train = mappo.train
    else:
        cfg = coma.COMAConfig(env_type="matrix", num_envs=4, log_interval=2, recurrent=True,
                              actor_hidden_dim=8, critic_hidden_dim=8, normalize_reward=True,
                              normalize_return=True, total_timesteps=4 * 8 * 4, seed=0,
                              verbose=False, device="cpu")
        train = coma.train
    plain, _ = train(cfg, logger=_logger())
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_dp_ranks.free_port()}",
                            world_size=1, rank=0)
    try:
        dp_run, _ = train(cfg, logger=_logger())
    finally:
        dist.destroy_process_group()
    flat = lambda r: tree_leaves(to_state(r))  # noqa: E731
    for a, b in zip(flat(plain), flat(dp_run), strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("posts, want", [
    # 2 hosts x 4 ranks, 4 cards each (no launcher variable): a card per rank
    ([("a", 4)] * 4 + [("b", 4)] * 4, ("nccl", 4)),
    ([("a", 4), ("b", 4)] * 4, ("nccl", 4)),          # ranks interleaved over hosts
    ([("a", 1)] * 2, ("gloo", 2)),                     # 2 ranks on one card
    ([("a", 4)] * 4 + [("b", 2)] * 3, ("gloo", 4)),    # one host short of cards
    ([("a", 0)] * 2, ("gloo", 2)),                     # the CPU
])
def test_backend_rule_reads_every_host(posts, want, monkeypatch):
    from cleanmarl_tpu_torch.distributed import multihost

    store = dist.HashStore()
    for r, (host, cards) in enumerate(posts[1:], start=1):
        store.set(f"cleanmarl/host/{r}", f"{host} {cards}")
    monkeypatch.setattr(multihost.socket, "gethostname", lambda: posts[0][0])
    assert multihost.choose_backend(store, 0, len(posts), posts[0][1]) == want


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return env


CLI = ["-m", "cleanmarl_tpu_torch.algos.mappo", "--env_type", "matrix", "--device", "cpu",
       "--num_envs", "16", "--log_interval", "2", "--eval_steps", "1000000",
       "--actor_hidden_dim", "8", "--critic_hidden_dim", "8", "--seed", "0",
       "--verbose", "true"]


def test_two_process_cli_prints_on_rank0_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")

    def cluster(total, resume):
        port = _dp_ranks.free_port()
        procs = [subprocess.Popen(
            [sys.executable, *CLI, "--total_timesteps", str(total),
             "--checkpoint_dir", ckpt, "--checkpoint_every", "512",
             "--resume", str(resume).lower(),
             "--coordinator_address", f"localhost:{port}", "--num_processes", "2",
             "--process_id", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(),
            cwd=str(tmp_path)) for i in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-3000:]
        return outs

    outs = cluster(1024, resume=False)
    assert "[MAPPO] step=" in outs[0] and "[MAPPO]" not in outs[1]
    assert "[dist] 2 ranks, backend gloo" in outs[0] and "[dist]" not in outs[1]
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [512, 1024]
    assert sorted(p.name for p in (tmp_path / "ckpt" / "1024").iterdir()) == [
        "meta.json", "rank0.pt", "rank1.pt"]
    assert json.loads((tmp_path / "ckpt" / "1024" / "meta.json").read_text())["world"] == 2

    outs = cluster(2048, resume=True)
    assert "[MAPPO] resumed from step 1024" in outs[0]
    assert "resumed" not in outs[1]
    steps = [int(m) for m in re.findall(r"step=(\d+)", outs[0])]
    assert steps[0] > 1024 and steps[-1] == 2048, steps


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    cfg = PPOConfig(**dict(BLOCK, log_interval=1, verbose=True),
                    profile_dir=str(tmp_path / "prof"), device="cpu")
    runner, _ = mappo.train(cfg, logger=_logger())
    assert runner.step == cfg.total_timesteps
    traces = list((tmp_path / "prof").iterdir())
    assert traces and all(p.name.endswith(".pt.trace.json") for p in traces)
    # the program's spans (core/tracing.py) are annotations of the trace
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"driver.block", "driver.to_host", "ppo.rollout", "env.step", "ppo.minibatch",
            "optim.update"} <= spans, sorted(spans)
    assert "[MAPPO] phases: {'perf/rollout_s'" in capsys.readouterr().out
    # timing the phases leaves the run as it was: params, optimizer state
    # and the generator's stream equal those of a run without profiling
    plain, _ = mappo.train(dataclasses.replace(cfg, profile_dir="", verbose=False),
                           logger=_logger())
    flat = lambda r: tree_leaves(to_state(r))  # noqa: E731
    for a, b in zip(flat(runner), flat(plain), strict=True):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
