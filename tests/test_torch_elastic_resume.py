"""Restoring a checkpoint at another world size (``core/checkpoint.py``,
``dp.unshard_runners``), the port of what orbax's restore gives the JAX
package: a checkpoint written by ``n`` ranks comes back at ``m``.

- ``unshard_runners`` of ``shard_runner``'s shares is the runner, for the
  eight runner kinds (MAPPO, COMA, QMIX, VDN, recurrent Q with episode and
  sequence replay, MADDPG, FACMAC), at 2 and 4 ranks, with rings whose
  capacity the ranks do not divide and VDN's transition ring;
- each kind saved by 2 gloo ranks after a block and restored at 1 is the
  global runner: every rank's share of it (``shard_runner``) is the rank's
  runner, scratch rows aside; saved at 1 and restored at 2 it is
  ``shard_runner``'s share, but for rank 1's generator, which follows the
  rule; 2 → 1 → 2 gives each rank its own file's runner back, rank 0's
  generator too;
- against the JAX package: its own ``Checkpointer`` restores a runner
  sharded on a 2-device mesh on 1 device, every leaf equal; one update
  from the port's 2 → 1 restored runner and one 2-rank update from the
  1 → 2 restored one agree with the JAX single-device update on the same
  state at 1e-5 (MAPPO, ``qmix_rnn``; the state from the JAX package's
  params and Adam state, copied by ``core/params.py``);
- the generator rule: new streams differ from every init and eval stream
  and from each other in their low 32 bits, and rank 0's state is kept;
- a 2-process CLI run saves and a 1-process ``--resume true`` ends at
  ``--total_timesteps`` and says so;
- a world the layout cannot take raises from ``make_train`` naming the
  constraint; a checkpoint of another global ``num_envs`` or capacity
  raises from ``restore`` naming the field.

Each spawned rank imports torch and the port only (``tests/_dp_ranks.py``);
the JAX references run in this process.
"""
import copy
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

import _dp_ranks
from cleanmarl_tpu.algos import mappo as jmappo
from cleanmarl_tpu.algos.ppo_common import PPOConfig as JaxPPOConfig
from cleanmarl_tpu.algos.vdn import VDNConfig as JaxVDNConfig
from cleanmarl_tpu.algos.vdn import make_train as jvdn_make_train
from cleanmarl_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
from cleanmarl_tpu.distributed import dp as jdp
from cleanmarl_tpu.envs.matrix_game import MatrixGame as JaxMatrixGame
from cleanmarl_tpu_torch.algos import mappo
from cleanmarl_tpu_torch.algos.ppo_common import PPOConfig
from cleanmarl_tpu_torch.core.checkpoint import Checkpointer, from_state, to_state
from cleanmarl_tpu_torch.core.cli import cli
from cleanmarl_tpu_torch.core.params import tree_map
from cleanmarl_tpu_torch.distributed import dp
from cleanmarl_tpu_torch.envs import registry
from test_torch_distributed import (
    CLI, PPO_BASE, PPO_CASES, close_trees, np_tree, port_opt, ppo_trajectory, same_trees,
)
from test_torch_distributed import _env as cli_env
from test_torch_distributed_offpolicy import recq_job

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 2
_SL = dict(env_type="mpe", env_name="simple_speaker_listener_v4", num_envs=4,
           batch_size=4, log_interval=25, actor_hidden_dim=8, critic_hidden_dim=8,
           num_eval_ep=2, seed=0, verbose=False)
_RQ = dict(env_type="matrix", num_envs=4, batch_size=4, log_interval=8, hidden_dim=8,
           hyper_dim=8, embed_dim=4, seq_length=4, burn_in=2, num_eval_ep=2, seed=0,
           verbose=False)
# name → (family, config): the eight runner kinds, with rings the ranks
# divide (10, 16) and do not (9, 15, 199)
KINDS = {
    "mappo": ("mappo", dict(env_type="smaclite", env_name="3m", recurrent=True, num_envs=4,
                            rollout_len=10, actor_hidden_dim=8, critic_hidden_dim=8, epochs=2,
                            num_minibatches=2, log_interval=1, normalize_values=True, seed=0,
                            verbose=False)),
    "coma": ("coma", dict(env_type="matrix", num_envs=4, log_interval=2, actor_hidden_dim=8,
                          critic_hidden_dim=8, recurrent=True, seed=0, verbose=False)),
    "qmix": ("qmix", dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4,
                          buffer_size=9, batch_size=4, log_interval=25, hidden_dim=8,
                          hyper_dim=8, embed_dim=4, max_updates_per_iter=2, seed=0,
                          verbose=False)),
    "vdn": ("vdn", dict(env_type="mpe", env_name="simple_spread_v3", num_envs=4,
                        buffer_size=199, batch_size=4, learning_starts=40, train_freq=2,
                        log_interval=30, hidden_dim=8, seed=0, verbose=False)),
    "recurrent_q_episode": ("recq", dict(_RQ, buffer_size=15, mixing="qmix",
                                         max_updates_per_iter=2)),
    "recurrent_q_sequence": ("recq", dict(_RQ, buffer_size=16, mixing="vdn",
                                          replay="sequence")),
    "maddpg": ("maddpg", dict(_SL, buffer_size=9, recurrent=True)),
    "facmac": ("facmac", dict(_SL, buffer_size=10, hyper_dim=8, embed_dim=4)),
}


def tensors(tree):
    """A ``to_state`` tree whose tensors came back from a rank as numpy."""
    return tree_map(lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x, tree)


def flat(state, path="runner"):
    """(path, leaf) of a ``to_state`` tree."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in flat(state[k], f"{path}.{k}")]
    if isinstance(state, list):
        return [x for i, v in enumerate(state) for x in flat(v, f"{path}[{i}]")]
    return [(path, state)]


def ring_rows(ring):
    """The leaves of a ring's ``to_state``: ``stored`` on an episode ring
    (``buffers/episode.py``), ``data`` on a sequence ring."""
    return ring["stored"] if "stored" in ring else ring["data"]


def without_scratch(state):
    """A runner's ``to_state`` with the scratch row of its episode or
    sequence ring zeroed (nothing reads it; a restore zeroes it)."""
    ring = state.get("ring")
    if ring is not None:
        for _, x in flat({"data": ring_rows(ring), "length": ring.get("length")}):
            if isinstance(x, torch.Tensor):
                x[-1] = 0
    return state


def assert_same(a, b, what, skip=()):
    """Two ``to_state`` trees bit for bit, but for the paths in ``skip``."""
    fa, fb = flat(a), flat(b)
    assert [p for p, _ in fa] == [p for p, _ in fb], what
    for (path, x), (_, y) in zip(fa, fb):
        if path in skip:
            continue
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {path}"
        else:
            assert type(x) is type(y) and x == y, f"{what}: {path}"


GEN = "runner.generator.__generator_state__"


# ---------------------------------------------------------------------------
# unshard_runners is the inverse of shard_runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_unshard_of_shard_is_the_runner(name, world):
    family, kw = KINDS[name]
    train_block, _, runner, dims = _dp_ranks.fresh(family, kw)
    runner, _ = train_block(runner)
    parts = [dp.shard_runner(runner, dims, k, world) for k in range(world)]
    ring = getattr(runner, "ring", None) or getattr(runner, "buffer", None)
    assert ring is None or ring.size > 0
    back = dp.unshard_runners(parts, dims)
    assert_same(to_state(back), without_scratch(to_state(runner)), name)


def test_unshard_raises_naming_a_replicated_field_that_differs():
    family, kw = KINDS["qmix"]
    _, _, runner, dims = _dp_ranks.fresh(family, kw)
    parts = [dp.shard_runner(runner, dims, k, 2) for k in range(2)]
    bad = parts[1].replace(num_updates=parts[1].num_updates + 1)
    with pytest.raises(ValueError, match="num_updates differs across the 2 ranks"):
        dp.unshard_runners([parts[0], bad], dims)
    bad = parts[1].replace(params=tree_map(lambda x: x + 1, runner.params))
    with pytest.raises(ValueError, match="params differs across the 2 ranks"):
        dp.unshard_runners([parts[0], bad], dims)
    bad = parts[1].replace(ring=copy.copy(parts[1].ring))
    bad.ring.cursor += 1
    with pytest.raises(ValueError, match="ring.cursor differs across the 2 ranks"):
        dp.unshard_runners([parts[0], bad], dims)


# ---------------------------------------------------------------------------
# 2 → 1, 1 → 2 and 2 → 1 → 2 for every kind, and the JAX updates
# ---------------------------------------------------------------------------

def mappo_jax_case():
    """The JAX package's MAPPO (GRU actor, reward and value normalization,
    clipping) after one warm-up update, a fixed trajectory, and its
    single-device update on them."""
    kw = dict(PPO_BASE, **PPO_CASES["gru_reward_values_clip"])
    env = registry.make("smaclite", "3m", agent_ids=True, device="cpu")
    jinit, _, _, jmeta = jmappo.make_train(JaxPPOConfig(**kw))
    pt = jmeta["phase_timer"]
    j_update = dict(zip(pt.__code__.co_freevars,
                        (c.cell_contents for c in pt.__closure__)))["ppo_update"]
    rng = np.random.RandomState(21)
    runner = jinit(jax.random.PRNGKey(7))
    n, H = runner.obs.shape[1], kw["actor_hidden_dim"]
    N = kw["num_envs"]
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
                 actor_opt=port_opt(runner.actor_opt), critic_opt=port_opt(runner.critic_opt),
                 vnorm=np_tree(runner.vnorm), obs=np.asarray(runner.obs),
                 state=np.asarray(runner.state), num_updates=int(runner.num_updates))
    full = _dp_ranks._ppo_full(dict(kw, seed=0), True, start, traj, h0)
    want = dict(actor_params=np_tree(out.actor_params),
                critic_params=np_tree(out.critic_params), vnorm=np_tree(out.vnorm),
                metrics={k: float(v) for k, v in metrics.items()},
                num_updates=int(out.num_updates))
    return ("mappo", dict(kw, seed=0), (traj, h0)), full, want


def recq_jax_case():
    """``qmix_rnn`` (episode replay, QMIX mixer) from the JAX package's
    params and Adam state, a fixed batch, and its single-device update."""
    (_, kw, start, batch, mask, _), (params, metrics) = recq_job(False, 3)
    kw = dict(kw, num_envs=4, buffer_size=9, batch_size=4, seed=0)
    _, _, runner, _ = _dp_ranks.fresh("recq", kw)
    full = runner.replace(**_dp_ranks._port_state(start))
    return ("recq", kw, (batch, mask)), full, dict(params=params,
                                                   metrics=[float(m) for m in metrics])


JAX_CASES = {"mappo_jax": mappo_jax_case, "qmix_rnn_jax": recq_jax_case}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Every kind: a block and a save on 2 ranks (one spawn), the restore at
    1 here and its save, the restore of that at 2 (a second spawn). The
    JAX cases: saved here at 1, restored at 2 and updated (first spawn),
    saved there at 2 and restored here at 1 and updated."""
    work = str(tmp_path_factory.mktemp("elastic"))
    jax_jobs, jax_want = {}, {}
    for name, make in JAX_CASES.items():
        (family, kw, args), full, jax_want[name] = make()
        dims = _dp_ranks.fresh(family, kw)[3]
        _dp_ranks.checkpointer(work, name, 1, dims, kw).save(7, full)
        jax_jobs[name] = (family, kw, args)
    saved = _dp_ranks.run_ranks(_dp_ranks.elastic_save, WORLD, KINDS, jax_jobs, work)
    saved = [dict(r, **{name: tensors(r[name]) for name in KINDS}) for r in saved]
    single, steps = {}, {}
    for name, (family, kw) in KINDS.items():
        _, _, template, dims = _dp_ranks.fresh(family, kw)
        ckpt = _dp_ranks.checkpointer(work, name, WORLD, dims, kw)
        steps[name] = ckpt.latest_step()
        runner = ckpt.restore(template)
        single[name] = to_state(runner)
        _dp_ranks.checkpointer(work, name, 1, dims, kw).save(steps[name], runner)
    jax_single = {}
    for name, (family, kw, args) in jax_jobs.items():
        _, meta, template, dims = _dp_ranks.fresh(family, kw)
        runner = _dp_ranks.checkpointer(work, name, WORLD, dims, kw).restore(template)
        jax_single[name] = _dp_ranks.restored_update(family, 0, 1, meta, runner, args)
    restored = [tensors(r) for r in
                _dp_ranks.run_ranks(_dp_ranks.elastic_restore, WORLD, KINDS, work)]
    return dict(work=work, saved=saved, single=single, steps=steps, restored=restored,
                jax_want=jax_want, jax_single=jax_single)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_two_ranks_restored_at_one_is_the_global_runner(name, elastic):
    family, kw = KINDS[name]
    _, _, template, dims = _dp_ranks.fresh(family, kw)
    single = from_state(template, elastic["single"][name], as_saved=True)
    ranks = [r[name] for r in elastic["saved"]]
    assert single.obs.shape[0] == kw["num_envs"]
    for k, saved in enumerate(ranks):
        share = without_scratch(to_state(dp.shard_runner(single, dims, k, WORLD)))
        # the generator is rank 0's on the single process (every share copies it)
        assert_same(share, without_scratch(saved), f"{name} rank {k}",
                    skip={GEN} if k else ())
    assert torch.equal(elastic["single"][name]["generator"]["__generator_state__"],
                       ranks[0]["generator"]["__generator_state__"])
    state = elastic["single"][name]
    ring = state.get("ring") or state.get("buffer")
    if ring is not None:
        assert ring["size"] > 0 and ring["capacity"] == kw["buffer_size"]
    if "ring" in state:                                 # one scratch row, zeroed
        for _, x in flat(ring_rows(ring)):
            assert x.shape[0] == kw["buffer_size"] + 1 and not x[-1].any()


@pytest.mark.parametrize("name", sorted(KINDS))
def test_one_rank_restored_at_two_is_each_ranks_share(name, elastic):
    family, kw = KINDS[name]
    _, _, template, dims = _dp_ranks.fresh(family, kw)
    single = from_state(template, elastic["single"][name], as_saved=True)
    got = [r[name] for r in elastic["restored"]]
    for k in range(WORLD):
        want = to_state(dp.shard_runner(single, dims, k, WORLD))
        assert_same(got[k], want, f"{name} rank {k}", skip={GEN} if k else ())
    gen = [g["generator"]["__generator_state__"] for g in got]
    assert torch.equal(gen[0], elastic["single"][name]["generator"]["__generator_state__"])
    fresh_gen = torch.Generator().manual_seed(dp.resume_seed(0, 1, WORLD, elastic["steps"][name]))
    assert torch.equal(gen[1], fresh_gen.get_state())
    assert not torch.equal(gen[0], gen[1])


@pytest.mark.parametrize("name", sorted(KINDS))
def test_two_one_two_round_trip_gives_each_rank_its_file(name, elastic):
    """Every tensor and counter of each rank's file comes back, rank 0's
    generator too; rank 1's generator is the rule's new stream (the
    world-1 checkpoint between holds one generator)."""
    for k in range(WORLD):
        got = elastic["restored"][k][name]
        assert_same(without_scratch(got), without_scratch(elastic["saved"][k][name]),
                    f"{name} rank {k}", skip={GEN} if k else ())


def test_mappo_two_to_one_update_matches_jax(elastic):
    got, want = elastic["jax_single"]["mappo_jax"], elastic["jax_want"]["mappo_jax"]
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, **TOL, err_msg=k)
    for key in ("actor_params", "critic_params", "vnorm"):
        close_trees(got[key], want[key], key)
    assert got["num_updates"] == want["num_updates"]


def test_mappo_one_to_two_update_matches_jax(elastic):
    ranks = [r["mappo_jax"] for r in elastic["saved"]]
    want = elastic["jax_want"]["mappo_jax"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, **TOL, err_msg=k)
    for key in ("actor_params", "critic_params", "vnorm"):
        close_trees(ranks[0][key], want[key], key)
        same_trees(ranks[1][key], ranks[0][key])
    assert ranks[1]["metrics"] == ranks[0]["metrics"]


@pytest.mark.parametrize("direction", ["two_to_one", "one_to_two"])
def test_qmix_rnn_update_matches_jax(direction, elastic):
    want = elastic["jax_want"]["qmix_rnn_jax"]
    ranks = ([elastic["jax_single"]["qmix_rnn_jax"]] if direction == "two_to_one" else
             [r["qmix_rnn_jax"] for r in elastic["saved"]])
    np.testing.assert_allclose(ranks[0]["metrics"], want["metrics"], **TOL)
    close_trees(ranks[0]["params"], want["params"], "params")
    for r in ranks[1:]:
        same_trees(r["params"], ranks[0]["params"])
        assert r["metrics"] == ranks[0]["metrics"]


# ---------------------------------------------------------------------------
# the JAX package's own restore on another mesh: the reference behaviour
# ---------------------------------------------------------------------------

def _randomized(tree, seed):
    """Every leaf of a JAX runner replaced by random values of its shape and
    dtype, so that a leaf laid out wrongly shows."""
    rng = np.random.RandomState(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return jnp.asarray(rng.rand(*x.shape) < 0.5)
        if np.issubdtype(x.dtype, np.floating):
            return jnp.asarray(np.asarray(rng.randn(*x.shape), dtype=x.dtype))
        return jnp.asarray(np.asarray(rng.randint(0, 100, x.shape), dtype=x.dtype))
    return jax.tree.map(leaf, tree)


def test_jax_checkpointer_restores_a_two_device_runner_on_one(tmp_path):
    env = JaxMatrixGame(n_agents=2, n_actions=3, episode_limit=8)
    cfg = JaxVDNConfig(env_type="matrix", num_envs=4, buffer_size=64, seed=0)
    init = jvdn_make_train(cfg, env)[0]
    runner = _randomized(init(jax.random.PRNGKey(0)), 0)
    mesh = jdp.make_mesh(jax.devices()[:2])
    sharded = jdp.shard_runner(runner, mesh, jdp.DATA_FIELD_DIMS["VDN"])
    assert sharded.obs.sharding.num_devices == 2
    assert jax.tree.leaves(sharded.buffer)[0].sharding.num_devices == 2
    ckpt = JaxCheckpointer(str(tmp_path))
    ckpt.save(5, sharded, wait=True)
    restored = ckpt.restore(init(jax.random.PRNGKey(1)))
    ckpt.close()
    leaves = jax.tree.leaves(restored)
    assert all(x.sharding.num_devices == 1 for x in leaves if hasattr(x, "sharding"))
    for a, b in zip(leaves, jax.tree.leaves(runner), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the generator rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 12345, 2**32 - 3])
def test_new_streams_differ_from_every_live_one_in_their_low_bits(seed):
    low = lambda s: s % 2**32  # noqa: E731
    for n, m in ((1, 2), (1, 4), (2, 8), (3, 64)):
        for step in (0, 7, 10**9):
            new = [dp.resume_seed(seed, r, m, step) for r in range(n, m)]
            taken = {low(dp.rank_seed(seed, r)) for r in range(2 * m + 2)} | {low(seed + 1)}
            assert len({low(s) for s in new}) == len(new)
            assert not {low(s) for s in new} & taken
    # the CPU generator keeps the low 32 bits: the streams themselves differ
    draws = [torch.randint(0, 2**31, (4,), generator=torch.Generator().manual_seed(s))
             for s in [dp.rank_seed(seed, 0), dp.resume_seed(seed, 1, 2, 7)]]
    assert not torch.equal(*draws)


# ---------------------------------------------------------------------------
# the CLI: two processes save, one resumes
# ---------------------------------------------------------------------------

def test_two_process_checkpoint_resumes_in_one_process(tmp_path, capsys):
    """Two CLI processes save; ``train`` in this process (one rank, the
    CLI's flags) resumes and ends at its total."""
    ckpt = str(tmp_path / "ckpt")
    port = _dp_ranks.free_port()
    procs = [subprocess.Popen(
        [sys.executable, *CLI, "--checkpoint_dir", ckpt, "--checkpoint_every", "512",
         "--total_timesteps", "1024", "--coordinator_address", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=cli_env(),
        cwd=str(tmp_path)) for i in range(2)]
    for p in procs:
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out[-3000:]
    cfg = cli(PPOConfig, CLI[2:] + ["--checkpoint_dir", ckpt, "--checkpoint_every", "512",
                                    "--total_timesteps", "2048", "--resume", "true"])
    runner, _ = mappo.train(cfg, logger=types.SimpleNamespace(log=lambda *a: None,
                                                              close=lambda: None))
    out = capsys.readouterr().out
    assert "[MAPPO] resumed from step 1024 (written by 2 ranks, now 1)" in out
    steps = [int(x) for x in re.findall(r"step=(\d+)", out)]
    assert steps[0] > 1024 and steps[-1] == 2048 == runner.step, steps
    meta = Checkpointer(ckpt, field_dims=dp.DATA_FIELD_DIMS["PPO"], seed=cfg.seed).meta()
    assert (meta["step"], meta["world"], meta["num_envs"], meta["seed"]) == (2048, 1, 16,
                                                                             cfg.seed)


# ---------------------------------------------------------------------------
# what the new world cannot take
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family, kw, match", [
    ("mappo", dict(KINDS["mappo"][1], num_envs=6, num_minibatches=1),
     r"num_envs=6 must be a multiple of num_minibatches x ranks = 1 x 4"),
    ("qmix", dict(KINDS["qmix"][1], batch_size=6), r"batch_size=6 must be a multiple of the 4"),
    ("vdn", dict(KINDS["vdn"][1], num_envs=6),
     r"num_envs=6 must be a multiple of num_minibatches x ranks = 1 x 4"),
])
def test_a_world_the_layout_cannot_take_raises_from_make_train(family, kw, match,
                                                               monkeypatch):
    """``num_envs=6`` saved at 2 ranks cannot restore at 4: ``make_train``
    at 4 ranks refuses before ``restore`` is reached."""
    _dp_ranks.fresh(family, kw)                       # one rank takes it
    monkeypatch.setattr(dp, "rank_world", lambda: (0, 4))
    with pytest.raises(ValueError, match=match):
        _dp_ranks.fresh(family, kw)


@pytest.mark.parametrize("name, change, match", [
    ("mappo", dict(num_envs=8), r"holds num_envs=4; this run has num_envs=8 "
                                r"\(8 per rank x 1 ranks\)"),
    ("qmix", dict(buffer_size=10), r"holds capacity=9; this run has capacity=10"),
])
def test_a_checkpoint_of_another_global_layout_raises_from_restore(name, change, match,
                                                                   elastic):
    family, kw = KINDS[name]
    _, _, template, dims = _dp_ranks.fresh(family, dict(kw, **change))
    ckpt = _dp_ranks.checkpointer(elastic["work"], name, WORLD, dims, kw)
    with pytest.raises(ValueError, match=match):
        ckpt.restore(template)

